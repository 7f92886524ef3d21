"""flame_tpu_torch image ops and the tile rasterizer (the module of the
raster_mesh CUDA kernel) against the JAX package, on the CPU.

Bilinear sampling, central gradients and Liang-Barsky are the same
float32 formulas (atol 1e-5 on values up to 255). The rasterizer's plain
tiled path is held to JAX's Pallas tile kernel in interpret mode and to
the brute-force rasterizer on random Delaunay meshes, at the sizes of
tests/test_ops.py: identical NaN masks (the inside test is exact on
truncated integer vertices) and values to atol 1e-5 (interpolation
rounding)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flame_tpu.ops import clipping as jclip  # noqa: E402
from flame_tpu.ops import gradients as jgrad  # noqa: E402
from flame_tpu.ops import interp as jinterp  # noqa: E402
from flame_tpu.ops import pallas_raster as jpr  # noqa: E402
from flame_tpu.ops import rasterize as jrast  # noqa: E402
from flame_tpu_torch.ops import clipping, gradients, interp  # noqa: E402
from flame_tpu_torch.ops import raster_kernel, rasterize  # noqa: E402

H, W = 120, 160


def _img(rng):
    return rng.integers(0, 256, (H, W)).astype(np.uint8)


def test_bilinear_matches_jax():
    rng = np.random.default_rng(0)
    img = _img(rng).astype(np.float32)
    x = rng.uniform(-3, W + 3, (64, 7)).astype(np.float32)
    y = rng.uniform(-3, H + 3, (64, 7)).astype(np.float32)
    a = jinterp.bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    b = interp.bilinear(torch.as_tensor(img), torch.as_tensor(x),
                        torch.as_tensor(y))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_bilinear_stack_matches_jax():
    rng = np.random.default_rng(1)
    imgs = np.stack([_img(rng) for _ in range(3)]).astype(np.float32)
    fidx = rng.integers(0, 3, (50, 5)).astype(np.int32)
    x = rng.uniform(0, W, (50, 5)).astype(np.float32)
    y = rng.uniform(0, H, (50, 5)).astype(np.float32)
    a = jinterp.bilinear_stack(jnp.asarray(imgs), jnp.asarray(fidx),
                               jnp.asarray(x), jnp.asarray(y), packed=False)
    b = interp.bilinear_stack(torch.as_tensor(imgs), torch.as_tensor(fidx),
                              torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_central_gradient_matches_jax():
    img = _img(np.random.default_rng(2))
    for a, b in zip(jgrad.central_gradient(jnp.asarray(img)),
                    gradients.central_gradient(torch.as_tensor(img))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_clip_line_matches_jax():
    rng = np.random.default_rng(3)
    seg = rng.uniform(-50, 250, (256, 4)).astype(np.float32)
    seg[:8, 2] = seg[:8, 0]  # vertical segments
    seg[8:16, 3] = seg[8:16, 1]  # horizontal segments
    a = jclip.clip_line(1.0, 159.0, 1.0, 119.0, *jnp.asarray(seg).T)
    b = clipping.clip_line(1.0, 159.0, 1.0, 119.0,
                           *torch.as_tensor(seg).unbind(1))
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-4)


def _mesh(seed, n_pts=180, T=512):
    from scipy.spatial import Delaunay as SDelaunay
    rng = np.random.default_rng(seed)
    pts = rng.uniform([4, 4], [156, 116], (n_pts, 2)).astype(np.float32)
    sd = SDelaunay(pts)
    tris = np.zeros((T, 3), np.int32)
    tris[:sd.simplices.shape[0]] = sd.simplices
    tm = np.zeros(T, bool)
    tm[:sd.simplices.shape[0]] = True
    tm[rng.integers(0, sd.simplices.shape[0], 5)] = False
    vals = rng.uniform(0.5, 2.0, n_pts).astype(np.float32)
    return pts, tris, vals, tm


def _same_map(out, ref):
    assert (np.isnan(ref) == np.isnan(out)).all()
    m = ~np.isnan(ref)
    np.testing.assert_allclose(out[m], ref[m], atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_matches_jax_pallas_and_bruteforce(seed):
    pts, tris, vals, tm = _mesh(seed)
    J = [jnp.asarray(a) for a in (pts, tris, vals, tm)]
    T = [torch.as_tensor(a) for a in (pts, tris.astype(np.int64), vals, tm)]
    ref_bf = np.asarray(jrast.rasterize_bruteforce(*J, H, W))
    ref_pl = np.asarray(jpr.rasterize(*J, H, W, max_per_tile=512,
                                      interpret=True))
    out = rasterize.rasterize(*T, H, W, max_per_tile=512).numpy()
    _same_map(out, ref_pl)
    _same_map(out, ref_bf)
    _same_map(rasterize.rasterize_bruteforce(*T, H, W).numpy(), ref_bf)


def test_raster_wrapper_takes_plain_path_on_cpu():
    pts, tris, vals, tm = _mesh(2)
    T = [torch.as_tensor(a) for a in (pts, tris.astype(np.int64), vals, tm)]
    cand = rasterize.tile_candidates(*T, H, W)
    assert cand.cdata.shape == (4, 2, 160, 16)
    assert int(cand.max_count) <= 160
    before = dict(raster_kernel._kernels.LAUNCHES)
    out = raster_kernel.rasterize(*T, H, W)
    assert raster_kernel._kernels.LAUNCHES == before  # no launch on CPU
    np.testing.assert_array_equal(
        out.numpy(), rasterize.rasterize(*T, H, W).numpy())


def test_rasterize_overflow_keeps_highest_index_triangles():
    """Past max_per_tile a tile keeps its highest-index candidates (the
    TPU kernel's top_k contract); tile_candidates reports the largest
    per-tile count, so the overflow is visible."""
    pts, tris, vals, tm = _mesh(3)
    T = [torch.as_tensor(a) for a in (pts, tris.astype(np.int64), vals, tm)]
    cand = rasterize.tile_candidates(*T, H, W, max_per_tile=8)
    assert int(cand.max_count) > 8
    J = [jnp.asarray(a) for a in (pts, tris, vals, tm)]
    ref = np.asarray(jpr.rasterize(*J, H, W, max_per_tile=8,
                                   interpret=True))
    _same_map(rasterize.rasterize(*T, H, W, max_per_tile=8).numpy(), ref)
