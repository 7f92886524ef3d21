"""What the redesigned K1, K2 and K3 decide on the host, on the CPU.

  * K1 (csrc/nltgv2_smoother.cu) runs every iteration in one cooperative
    launch, so its CTAs must all be resident: smoother_kernel.launch_plan
    picks the fewest vertices per warp that fit, from the SM count and
    each instantiation's CTAs per SM, and names the limit otherwise.
  * K2 (csrc/raster.cu raster_mesh) bins on the device and keeps, per
    tile, the K1 highest-index overlapping triangles. Its plain version
    (rasterize._packed_rows + _bin_tiles) is held here to the JAX
    package's pallas_raster._setup_one + _bin_tiles on a mesh with an
    overflowing tile: the same rows, bboxes and candidate set per tile
    (exact: the binning compares truncated integer coordinates), and
    raster_kernel.rasterize_with_count to the JAX Pallas kernel in
    interpret mode (identical NaN masks, values to atol 1e-5).
  * K3 (csrc/halo_smoother.cu) runs a thread-block cluster per partition,
    every cluster spinning on its ring neighbours, so all must be
    resident: halo_kernel.launch_plan picks the CTAs per cluster, the
    fewest vertices per warp and then the fewest clusters per partition
    from the SM count and the cluster occupancy, and names the limit
    otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flame_tpu.ops import pallas_raster as jpr  # noqa: E402
from flame_tpu_torch.ops import raster_kernel, rasterize  # noqa: E402
from flame_tpu_torch.optimize import smoother_kernel  # noqa: E402
from flame_tpu_torch.parallel import halo_kernel  # noqa: E402

H100_SMS = 132


def h100_blocks_per_sm(spl, vpw):
    """One 1024-thread CTA per SM (64 registers a thread fill the register
    file), when its spilled slot groups (8 words a lane) and the warps'
    sum buffers fit the 227 KB of shared memory."""
    smem = (max(spl * vpw - 2, 0) * 8 * 1024 + 32 * 3 * 32 * spl) * 4
    return 1 if smem <= 227 * 1024 else 0


@pytest.mark.parametrize("D", [16, 20, 40])
@pytest.mark.parametrize("V, vpw", [(4096, 1), (8192, 2), (16384, 4)])
def test_launch_plan_fits_the_card(V, vpw, D):
    plan = smoother_kernel.launch_plan(V, D, H100_SMS, h100_blocks_per_sm)
    assert plan.slots_per_lane == (1 if D <= 32 else 2)
    assert plan.vertices_per_warp == vpw
    # Every vertex has a warp, every CTA is resident, none is empty.
    assert plan.grid * 32 * vpw >= V
    assert plan.grid <= H100_SMS * h100_blocks_per_sm(plan.slots_per_lane,
                                                      vpw)
    assert (plan.grid - 1) * 32 * vpw < V
    assert plan.grid == -(-V // (32 * vpw))


def test_launch_plan_uses_the_occupancy_it_is_given():
    # Two CTAs per SM hold 8192 vertices at one vertex per warp.
    plan = smoother_kernel.launch_plan(8192, 20, H100_SMS, lambda s, v: 2)
    assert plan.vertices_per_warp == 1 and plan.grid == 256
    # An SM count that does not hold V at one vertex per warp takes more.
    plan = smoother_kernel.launch_plan(4096, 20, 66, h100_blocks_per_sm)
    assert plan.vertices_per_warp == 2 and plan.grid == 64


@pytest.mark.parametrize("V, D, limit", [
    (40000, 20, 33792),   # 8 vertices per warp at one slot per lane
    (20000, 40, 16896),   # 4 vertices per warp at two slots per lane
])
def test_launch_plan_names_the_limit(V, D, limit):
    with pytest.raises(ValueError, match=f"at most {limit}"):
        smoother_kernel.launch_plan(V, D, H100_SMS, h100_blocks_per_sm)


@pytest.mark.parametrize("D", [0, 65])
def test_launch_plan_rejects_the_degree(D):
    with pytest.raises(ValueError, match="degree"):
        smoother_kernel.launch_plan(1024, D, H100_SMS, h100_blocks_per_sm)


def h100_max_clusters(cluster, vpw, reach=3):
    """Clusters of 1024-thread CTAs (one per SM) that a 132-SM H100 holds
    at once: 7 of 16 and 15 of 8 CTAs, as an H100 80GB HBM3 reports them
    (cudaOccupancyMaxActiveClusters), else one CTA per SM; none where a
    CTA's shared memory (the bars, halos, spilled slots and sums of
    csrc/halo_smoother.cu) passes 227 KB."""
    smem = (2 * 32 * vpw + 2 * reach * 128) * 16 \
        + (max(vpw - 2, 0) * 8 * 1024 + 32 * 96) * 4
    if smem > 227 * 1024:
        return 0
    return {16: 7, 8: 15}.get(cluster, H100_SMS // cluster)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("V", [4096, 8192])
def test_halo_launch_plan_fits_the_card(V, n):
    plan = halo_kernel.launch_plan(V, 20, n, H100_SMS, h100_max_clusters,
                                   reach=3)
    nv = V // n // plan.splits  # vertices of one cluster
    C, vpw = plan.cluster, plan.vertices_per_warp
    # A cluster of more than one CTA, each holding vertices, covers its
    # rows; every cluster is resident.
    assert 2 <= C <= halo_kernel.MAX_CLUSTER
    assert C * 32 * vpw >= nv > (C - 1) * 32 * vpw
    assert plan.clusters == n * plan.splits
    assert plan.clusters <= plan.max_active_clusters \
        == h100_max_clusters(C, vpw)
    assert plan.clusters * C <= H100_SMS
    # No fewer vertices per warp would have fitted at any split, nor
    # fewer splits at these vertices per warp.
    Rb = V // 128 // n
    for v in halo_kernel.VERTICES_PER_WARP:
        for s in range(1, Rb + 1):
            if Rb % s or Rb // s < 3 or (v, s) >= (vpw, plan.splits):
                continue
            c = -(-(V // n // s) // (32 * v))
            assert c > 16 or n * s * c > H100_SMS \
                or n * s > h100_max_clusters(c, v)


@pytest.mark.parametrize("V, n, want", [
    (4096, 1, (16, 2, 4)), (4096, 2, (16, 2, 2)), (4096, 4, (16, 2, 1)),
    (4096, 8, (8, 2, 1)), (8192, 1, (16, 4, 4)), (8192, 8, (8, 4, 1))])
def test_halo_launch_plan_splits_for_fewer_vertices_per_warp(V, n, want):
    """A partition goes over several clusters where that lowers the
    vertices per warp: 4096 vertices at one partition as four clusters
    of 16 CTAs at two vertices per warp, not one at eight."""
    plan = halo_kernel.launch_plan(V, 20, n, H100_SMS, h100_max_clusters,
                                   reach=3)
    assert (plan.cluster, plan.vertices_per_warp, plan.splits) == want


@pytest.mark.parametrize("held16, want", [(8, (16, 1)), (7, (8, 2))])
def test_halo_launch_plan_uses_the_occupancy_it_is_given(held16, want):
    """Eight partitions of 512 vertices: 16-CTA clusters at one vertex per
    warp when the card holds eight of them, else 8-CTA clusters at two."""
    def held(cluster, vpw):
        return held16 if cluster == 16 else h100_max_clusters(cluster, vpw)
    plan = halo_kernel.launch_plan(4096, 20, 8, H100_SMS, held, reach=3)
    assert (plan.cluster, plan.vertices_per_warp) == want
    assert plan.max_active_clusters == held(*want)


@pytest.mark.parametrize("V, n", [(65536, 1), (65536, 4)])
def test_halo_launch_plan_names_the_limit(V, n):
    # 132 SMs x 32 warps x 8 vertices, in clusters of 4 or fewer CTAs.
    with pytest.raises(ValueError, match="at most 33792"):
        halo_kernel.launch_plan(V, 20, n, H100_SMS, h100_max_clusters)


@pytest.mark.parametrize("D", [0, 33])
def test_halo_launch_plan_rejects_the_degree(D):
    with pytest.raises(ValueError, match="degree"):
        halo_kernel.launch_plan(4096, D, 4, H100_SMS, h100_max_clusters)


def _overflow_mesh(seed, H=96, W=256):
    """A Delaunay mesh over W x H with a dense cluster inside tile (1, 1)
    (rows 32-63, columns 128-255), a few invalid triangles and a
    degenerate one."""
    from scipy.spatial import Delaunay as SDelaunay
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform([2, 2], [W - 2, H - 2], (120, 2)),
                          rng.uniform([140, 36], [240, 60], (150, 2))])
    pts = pts.astype(np.float32)
    tris = np.concatenate([SDelaunay(pts).simplices,
                           [[0, 0, 1]]]).astype(np.int32)  # zero area
    valid = rng.uniform(size=tris.shape[0]) > 0.03
    vals = rng.uniform(0.5, 2.0, pts.shape[0]).astype(np.float32)
    return pts, tris, vals, valid, H, W


@pytest.mark.parametrize("K1", [16, 160])
def test_bin_tiles_matches_jax_with_overflow(K1):
    pts, tris, vals, valid, H, W = _overflow_mesh(7)
    packed_j, ok_j, bbox_j = jpr._setup_one(
        jnp.asarray(pts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(valid), True)
    packed, ok, bbox = rasterize._packed_rows(
        torch.as_tensor(pts), torch.as_tensor(tris.astype(np.int64)),
        torch.as_tensor(vals), torch.as_tensor(valid), True)
    np.testing.assert_allclose(packed.numpy(), np.asarray(packed_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    for a, b in zip(bbox, bbox_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    kvals, max_count = rasterize._bin_tiles(bbox, ok, H, W, 32, K1)
    nty, ntx = -(-H // 32), -(-W // 128)
    tids = jnp.arange(nty * ntx)
    order, k_valid = jpr._bin_tiles(
        bbox_j, ok_j, nty * ntx, (tids % ntx).astype(jnp.float32) * 128,
        (tids // ntx).astype(jnp.float32) * 32, 32, K1)
    order, k_valid = np.asarray(order), np.asarray(k_valid)
    kv = kvals.numpy()
    for tile in range(nty * ntx):
        assert set(kv[tile][kv[tile] >= 0]) \
            == set(order[tile][k_valid[tile]])
    # The cluster's tile overflows at 160, and the count says so.
    assert int(max_count) > 160
    assert (kv >= 0).sum(1).max() == K1


def test_rasterize_with_count_matches_jax_pallas_on_overflow():
    pts, tris, vals, valid, H, W = _overflow_mesh(8)
    T = [torch.as_tensor(a) for a in (pts, tris.astype(np.int64), vals,
                                      valid)]
    out, count = raster_kernel.rasterize_with_count(*T, H, W)
    assert int(count) == int(rasterize.tile_candidates(*T, H, W).max_count)
    assert int(count) > raster_kernel.MAX_PER_TILE
    ref = np.asarray(jpr.rasterize(
        *(jnp.asarray(a) for a in (pts, tris, vals, valid)), H, W,
        max_per_tile=raster_kernel.MAX_PER_TILE, interpret=True))
    out = out.numpy()
    assert (np.isnan(out) == np.isnan(ref)).all()
    m = ~np.isnan(ref)
    np.testing.assert_allclose(out[m], ref[m], atol=1e-5)
