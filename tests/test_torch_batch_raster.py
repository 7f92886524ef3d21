"""The batched rasterizer of flame_tpu_torch (ops/rasterize.py
tile_candidates_batch + eval_tiles_batch, the plain version of the K2b
kernel) against flame_tpu.ops.pallas_raster.rasterize_batch in interpret
mode, as tests/test_ops.py runs it, and against the port's per-view
rasterizer.

Inputs: one seeded Delaunay triangle set seen from B views, each view
translated and slightly scaled (projection-style motion), with per-view
values and view-specific invalid triangles.

Tolerance: NaN masks identical (the inside test is exact on truncated
vertices); values atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
