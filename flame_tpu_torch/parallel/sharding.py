"""The partition mesh of the partitioned smoothers.

Counterpart of the mesh part of flame_tpu/parallel/sharding.py (AXIS,
make_mesh). The JAX package's mesh is a row of chips; the port's is a
row of partitions of one card: the halo kernel runs one CTA per
partition and the partitions swap boundary strips through global memory
(parallel/halo_kernel.py), and the plain "halo" smoother runs the
partitions as a leading tensor axis (parallel/halo.py). A mesh whose
entries name different cards needs a transport between cards, which is
not ported: it raises NotImplementedError. The edge-sharded smoother and
the sharded update step of that module are not ported either.
"""

from dataclasses import dataclass

import torch

AXIS = "graph"


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each partition, in axis order."""

    devices: tuple
    axis: str = AXIS

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one partition")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                "a mesh over several devices needs the multi-card "
                "transport (ROADMAP: multi-GPU), got "
                f"{sorted(str(d) for d in set(devs))}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """Number of partitions."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every partition lies on."""
        return self.devices[0]


def make_mesh(n: int = 1, device="cuda") -> Mesh:
    """n partitions of one device."""
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 partitions, got {n}")
    return Mesh((device,) * n, AXIS)
