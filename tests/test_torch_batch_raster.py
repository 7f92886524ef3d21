"""The batched rasterizer of flame_tpu_torch (ops/rasterize.py
tile_candidates_batch + eval_tiles_batch, the plain version of the K2b
kernel) against flame_tpu.ops.pallas_raster.rasterize_batch in interpret
mode, as tests/test_ops.py runs it, and against the port's per-view
rasterizer.

Inputs: one seeded Delaunay triangle set seen from B views, each view
translated and slightly scaled (projection-style motion), with per-view
values and view-specific invalid triangles.

The union binning that the K2b kernel (raster_mesh_batch) does on the
device is held here, through its plain version, to the JAX package's on a
batch whose densest tile's union count passes 192: the same union bboxes
(rasterize.union_boxes, exact), the same candidate set per tile and
the same largest union count, and the maps of
raster_kernel.rasterize_batch_with_count to pallas_raster.rasterize_batch
in interpret mode.

Tolerance: NaN masks identical (the inside test is exact on truncated
vertices); values atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flame_tpu.ops import pallas_raster  # noqa: E402
from flame_tpu_torch.mesh import delaunay  # noqa: E402
from flame_tpu_torch.ops import raster_kernel, rasterize  # noqa: E402

H, W = 120, 160
ATOL = 1e-5


def _views(seed, n_pts=150, B=3, T=512):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([4, 4], [140, 100], (n_pts, 2)).astype(np.float32)
    tri = delaunay.triangulate(pts).triangles
    tris = np.zeros((T, 3), np.int64)
    tris[:tri.shape[0]] = tri
    verts = np.stack([pts * (1.0 + 0.01 * b) + np.array([3.0 * b, -2.0 * b])
                      for b in range(B)]).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, (B, n_pts)).astype(np.float32)
    valid = np.zeros((B, T), bool)
    valid[:, :tri.shape[0]] = True
    valid[1, :10] = False  # view-specific invalidation
    valid[-1, rng.integers(0, tri.shape[0], 12)] = False
    return verts, tris, vals, valid


def _t(a):
    return torch.as_tensor(a)


def _assert_maps_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    assert m.mean() > 0.3
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_batch_raster_matches_pallas_interpret(seed):
    verts, tris, vals, valid = _views(seed)
    want = np.asarray(pallas_raster.rasterize_batch(
        jnp.asarray(verts), jnp.asarray(tris.astype(np.int32)),
        jnp.asarray(vals), jnp.asarray(valid), H, W, max_per_tile=512,
        interpret=True))
    got = rasterize.rasterize_batch(_t(verts), _t(tris), _t(vals), _t(valid),
                                    H, W, max_per_tile=512)
    assert got.shape == (3, H, W)
    _assert_maps_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_batch_raster_matches_per_view(seed):
    """The shared union-bbox binning gives each view the map the per-view
    binning gives, while no tile overflows (wrapper path on the CPU)."""
    verts, tris, vals, valid = _views(seed, B=4)
    cand = rasterize.tile_candidates_batch(
        _t(verts), _t(tris), _t(vals), _t(valid), H, W,
        max_per_tile=raster_kernel.MAX_PER_TILE_BATCH)
    assert int(cand.max_count) <= raster_kernel.MAX_PER_TILE_BATCH
    assert cand.cdata.shape[:3] == (4, 4, 2)
    got = raster_kernel.rasterize_batch(_t(verts), _t(tris), _t(vals),
                                        _t(valid), H, W)
    for b in range(4):
        want = rasterize.rasterize(_t(verts[b]), _t(tris), _t(vals[b]),
                                   _t(valid[b]), H, W)
        _assert_maps_equal(got[b].numpy(), want.numpy())


def test_union_bbox_ignores_invalid_views():
    """A triangle invalid in every view but one is binned by that view's
    bbox alone: a far-away invalid copy must not widen its union."""
    verts, tris, vals, valid = _views(5, B=2)
    verts[1] += 60.0  # view 1 far away ...
    valid[1] = False  # ... and invalid everywhere
    cand = rasterize.tile_candidates_batch(_t(verts), _t(tris), _t(vals),
                                           _t(valid), H, W)
    single = rasterize.tile_candidates(_t(verts[0]), _t(tris), _t(vals[0]),
                                       _t(valid[0]), H, W, max_per_tile=192)
    assert int(cand.max_count) == int(single.max_count)
    out = rasterize.finish(rasterize.eval_tiles_batch(cand.cdata), H, W)
    assert torch.isnan(out[1]).all()


def _overflow_views(seed, B=3, H=96, W=256):
    """B views of a Delaunay mesh over W x H with a dense cluster inside
    tile (1, 1), view-specific invalid triangles and a degenerate one."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform([4, 4], [W - 20, H - 4], (120, 2)),
                          rng.uniform([140, 36], [236, 60], (220, 2))])
    tri = delaunay.triangulate(pts.astype(np.float32)).triangles
    tris = np.concatenate([tri, [[0, 0, 1]]]).astype(np.int64)  # zero area
    verts = np.stack([pts * (1.0 + 0.01 * b) + np.array([3.0 * b, -2.0 * b])
                      for b in range(B)]).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, (B, pts.shape[0])).astype(np.float32)
    valid = rng.uniform(size=(B, tris.shape[0])) > 0.03
    return verts, tris, vals, valid, H, W


def _jax_union(verts, tris, vals, valid):
    """pallas_raster.rasterize_batch's per-view setup, union bboxes and
    any_ok."""
    packed_b, ok_b, bbox_b = jax.vmap(
        lambda v, x, tv: pallas_raster._setup_one(v, jnp.asarray(tris),
                                                  x, tv, True))(
        jnp.asarray(verts), jnp.asarray(vals), jnp.asarray(valid))
    big = jnp.float32(3e38)
    xmin, xmax, ymin, ymax = bbox_b
    union = (jnp.min(jnp.where(ok_b, xmin, big), axis=0),
             jnp.max(jnp.where(ok_b, xmax, -big), axis=0),
             jnp.min(jnp.where(ok_b, ymin, big), axis=0),
             jnp.max(jnp.where(ok_b, ymax, -big), axis=0))
    return union, jnp.any(ok_b, axis=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_union_boxes_match_jax(seed):
    verts, tris, vals, valid, _, _ = _overflow_views(seed)
    union, _ = _jax_union(verts, tris.astype(np.int32), vals, valid)
    _, ok, bbox = rasterize._packed_rows(_t(verts), _t(tris), _t(vals),
                                         _t(valid), True)
    assert ok.shape == (3, tris.shape[0])
    for got, want in zip(rasterize.union_boxes(ok, bbox), union):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K1", [32, 192])
def test_union_binning_matches_jax_with_overflow(K1):
    """The K1 highest overlapping union bboxes per tile and the largest
    union count, against pallas_raster's _bin_tiles on its own union."""
    verts, tris, vals, valid, H, W = _overflow_views(2)
    union, any_ok = _jax_union(verts, tris.astype(np.int32), vals, valid)
    nty, ntx = -(-H // 32), -(-W // 128)
    tids = jnp.arange(nty * ntx)
    order, k_valid = pallas_raster._bin_tiles(
        union, any_ok, nty * ntx, (tids % ntx).astype(jnp.float32) * 128,
        (tids // ntx).astype(jnp.float32) * 32, 32, K1)
    order, k_valid = np.asarray(order), np.asarray(k_valid)
    _, ok, bbox = rasterize._packed_rows(_t(verts), _t(tris), _t(vals),
                                         _t(valid), True)
    kvals, max_count = rasterize._bin_tiles(
        rasterize.union_boxes(ok, bbox), ok.any(0), H, W, 32, K1)
    kv = kvals.numpy()
    for tile in range(nty * ntx):
        assert set(kv[tile][kv[tile] >= 0]) \
            == set(order[tile][k_valid[tile]])
    xmin, xmax, ymin, ymax = (np.asarray(u)[None] for u in union)
    tx = (np.arange(nty * ntx) % ntx * 128.0)[:, None]
    ty = (np.arange(nty * ntx) // ntx * 32.0)[:, None]
    jax_count = ((xmin <= tx + 127) & (xmax >= tx) & (ymin <= ty + 31)
                 & (ymax >= ty) & np.asarray(any_ok)[None]).sum(1).max()
    assert int(max_count) == jax_count > 192
    cand = rasterize.tile_candidates_batch(_t(verts), _t(tris), _t(vals),
                                           _t(valid), H, W, max_per_tile=K1)
    assert int(cand.max_count) == jax_count


def test_rasterize_batch_with_count_matches_jax_pallas_on_overflow():
    verts, tris, vals, valid, H, W = _overflow_views(3)
    out, count = raster_kernel.rasterize_batch_with_count(
        _t(verts), _t(tris), _t(vals), _t(valid), H, W)
    assert int(count) > raster_kernel.MAX_PER_TILE_BATCH
    want = np.asarray(pallas_raster.rasterize_batch(
        jnp.asarray(verts), jnp.asarray(tris.astype(np.int32)),
        jnp.asarray(vals), jnp.asarray(valid), H, W,
        max_per_tile=raster_kernel.MAX_PER_TILE_BATCH, interpret=True))
    _assert_maps_equal(out.numpy(), want)
