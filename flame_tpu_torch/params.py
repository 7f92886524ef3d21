"""Configuration tree for flame_tpu_torch.

The same frozen dataclasses, field names and defaults as
flame_tpu/params.py, so one configuration drives both packages
(convert.params_from_dict). Left out: `max_topology_staleness` (never
read) and the scoped-VMEM budget, a TPU limit.
"""

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LineStereoParams:
    """Epipolar line search (reference line_stereo.h:47-59)."""

    max_cost: float = 1300.0  # Max 5-sample SSD for a valid match.
    do_subpixel: bool = True  # Subpixel refinement at the error-gradient zero.
    sample_dist: float = 1.0  # Distance in pixels between samples.
    second_best_factor: float = 1.5  # best*factor must beat second best.
    # Packed bf16 sample tables in the JAX package; the port samples the
    # f32 image directly, which gives the same values for u8 imagery.
    table_bf16: bool = True


@dataclass(frozen=True)
class MeasModelParams:
    """LSD-SLAM inverse-depth noise model (inverse_depth_meas_model.h:44-52)."""

    win_size: int = 5
    pixel_var: float = 16.0  # Photometric noise variance (intensity^2).
    epipolar_line_var: float = 1.0  # Epipolar line noise variance (px^2).


@dataclass(frozen=True)
class FilterParams:
    """Per-feature inverse-depth filter (inverse_depth_filter.h:48-68)."""

    win_size: int = 5  # Patch size along the epiline (must be 5).
    search_sigma: float = 2.0  # Search region = mu +/- search_sigma * sigma.
    min_grad_mag: float = 5.0  # Min |d(ref patch)| to attempt a match.
    idepth_min: float = 1e-3
    idepth_max: float = 2.0
    epilength_min: float = 3.0  # Epipolar segment length bounds (pixels).
    epilength_max: float = 32.0
    process_var_factor: float = 1.01  # Variance inflation per frame.
    process_fail_var_factor: float = 1.1  # Inflation on a failed track.
    sparams: LineStereoParams = dataclasses.field(
        default_factory=LineStereoParams)


@dataclass(frozen=True)
class RegularizerParams:
    """NLTGV2-L1 Chambolle-Pock (nltgv2_l1_graph_regularizer.h:121-129)."""

    data_factor: float = 0.1
    step_x: float = 0.001  # Primal step size.
    step_q: float = 125.0  # Dual step size.
    theta: float = 0.25  # Extragradient overrelaxation.
    x_min: float = 0.0  # Feasible set for the primal variable.
    x_max: float = 10.0


@dataclass(frozen=True)
class TriangleFilterParams:
    """Display-mesh triangle filters (reference params.h:69-85)."""

    do_oblique_filter: bool = True
    oblique_normal_thresh: float = 1.39626  # 80 deg view-ray/normal angle.
    oblique_idepth_diff_factor: float = 0.35
    oblique_idepth_diff_abs: float = 0.1
    do_edge_length_filter: bool = True
    edge_length_thresh: float = 0.333  # Fraction of image width.
    do_idepth_filter: bool = True
    min_triangle_idepth: float = 0.01


@dataclass(frozen=True)
class DetectionParams:
    """Gradient-grid feature detection (params.h:44-53)."""

    continuous: bool = True  # Detect on every poseframe (vs first only).
    win_size: int = 16  # One feature per win_size x win_size cell.
    do_letterbox: bool = False  # Restrict to the middle third of rows.
    min_grad_mag: float = 5.0


@dataclass(frozen=True)
class SolverParams:
    """Solver scheduling: a fixed iteration budget per frame."""

    n_iters_per_frame: int = 40  # Chambolle-Pock iterations per update().
    max_vertex_degree: int = 16  # Slots of the [V, D] incidence table.
    # Smoother implementation (pipeline.resolve_smoother): "auto" and
    # "vertex" run the vertex-centric kernel K1; "pallas" the RCM-banded
    # layout through the halo kernel K3 with one partition; "halo" and
    # "pallas_halo" the partitioned smoothers of parallel/ (ShardedFlame).
    smoother: str = "auto"
    # Row reach of the banded layout: edges whose RCM ranks lie more than
    # pallas_reach rows of 128 apart are left out of the frame's smoothing.
    pallas_reach: int = 2
    async_topology: bool = False
    topology_lag: int = 2
    fetch_stride: int = 1
    join_age: int = 3
    max_consecutive_sheds: int = 8
    frame_batch: int = 1
    deterministic: bool = False
    coalesce_uploads: bool = True


@dataclass(frozen=True)
class BAParams:
    """Windowed bundle adjustment over keyframe poses (ba/window.py; the
    JAX package's params.py documents each field's measured trade-off)."""

    window_size: int = 8
    n_gn_iters: int = 5
    damping: float = 1e-4
    huber_delta: float = 2.0
    obs_capacity: int = 16384
    max_landmarks: int = 1024
    max_obs: int = 4096
    max_mean_cost: float = 9.0
    solve_min_new_pfs: int = 1
    pose_prior_weight: float = 1e5
    do_rematch: bool = True
    rematch_radius: int = 3
    rematch_max_cost: float = 6500.0
    rematch_min_eig: float = 25.0
    aniso_weights: bool = False
    writeback_min_dt: float = 1e-3
    writeback_min_drot: float = 1e-3


@dataclass(frozen=True)
class Params:
    """Top-level parameter struct (reference params.h:36-143)."""

    # Capacities: every state tensor has a fixed size.
    feature_capacity: int = 4096  # Max live features == max graph vertices.
    edge_capacity: int = 16384
    triangle_capacity: int = 12288
    poseframe_capacity: int = 32

    # Detection.
    min_grad_mag: float = 5.0
    do_grad_check_after_projection: bool = False
    detection: DetectionParams = dataclasses.field(
        default_factory=DetectionParams)
    photo_error_num_pfs: int = 30  # Comparison-poseframe scoring (0 = off).

    # Filter / measurement.
    zparams: MeasModelParams = dataclasses.field(
        default_factory=MeasModelParams)
    rescale_factor_min: float = 0.7
    rescale_factor_max: float = 1.4
    idepth_init: float = 0.01
    idepth_var_init: float = 0.25
    idepth_var_max: float = 0.25  # Feature killed above this variance.
    max_dropouts: int = 5  # Feature killed after this many failed tracks.
    outlier_sigma_thresh: float = 3.0  # Chi^2 gate on measurements.
    min_baseline: float = 0.01  # Min baseline to attempt an idepth update.
    do_meas_fusion: bool = True
    fparams: FilterParams = dataclasses.field(default_factory=FilterParams)

    # Triangle filters.
    tri_filter: TriangleFilterParams = dataclasses.field(
        default_factory=TriangleFilterParams)

    # Regularizer.
    min_height: float = 0.1  # World-height gate for graph membership.
    max_height: float = 4.0
    idepth_var_max_graph: float = 1e-2  # Max feature var to enter the graph.
    adaptive_data_weights: bool = False  # weight = 1/var instead of 1.
    init_with_prediction: bool = False  # Init new vertices from dense map.
    rescale_data: bool = False  # Renormalize graph scale to mean idepth.
    check_sticky_obstacles: bool = False  # Reset x if sucked toward camera.
    do_nltgv2: bool = True
    rparams: RegularizerParams = dataclasses.field(
        default_factory=RegularizerParams)
    solver: SolverParams = dataclasses.field(default_factory=SolverParams)

    # Automatic poseframe selection (Flame._want_poseframe).
    auto_poseframe: bool = False
    auto_pf_max_disparity: float = 16.0
    auto_pf_depth: float = 5.0

    # Windowed bundle adjustment (ba/window.py).
    do_ba: bool = False
    ba: BAParams = dataclasses.field(default_factory=BAParams)

    debug_quiet: bool = True
    scene_color_scale: float = 1.0
    compute_dtype: str = "float32"

    def replace(self, **kwargs) -> "Params":
        return dataclasses.replace(self, **kwargs)

    @property
    def border(self) -> int:
        """Valid-region border: rescale_factor_max * win/2 + 1."""
        return int(self.rescale_factor_max * self.fparams.win_size / 2 + 1)

    @property
    def pad(self) -> int:
        """Image padding width = filter window size."""
        return self.fparams.win_size
