"""flame_tpu_torch: the PyTorch/CUDA port of flame_tpu.

The Flame.update paths (frame creation, tracking, host Delaunay,
NLTGV2-L1 smoothing, mesh filters and rasterization; synchronous,
asynchronous and batched) on torch tensors, with hand-written CUDA
kernels for the smoother iteration, the tile rasterizer and the
partitioned halo smoother of parallel.orchestrator.ShardedFlame (built
with nvcc at first use). On the CPU the kernels' plain torch versions
run. Imports torch and numpy, never jax.
"""

from flame_tpu_torch.params import (BAParams, DetectionParams, FilterParams,
                                    LineStereoParams, MeasModelParams,
                                    Params, RegularizerParams, SolverParams,
                                    TriangleFilterParams)
from flame_tpu_torch.core.flame import Flame
from flame_tpu_torch.utils.stats import StatsTracker

__all__ = ["Flame", "Params", "FilterParams", "LineStereoParams",
           "MeasModelParams", "RegularizerParams", "TriangleFilterParams",
           "DetectionParams", "SolverParams", "BAParams", "StatsTracker"]
