"""The port's I/O and host utilities against the JAX package (and PIL):

- io/png.py decodes PIL-written 8-bit gray, gray + alpha, RGB and RGBA
  files bit-equal to PIL (its convert("L") for the gray channel), undoes
  each of the five row filters, and writes gray files PIL reads back;
- io/synthetic.py writes the same mini-TUM sequence as the JAX package's
  from one seed: bit-equal frames, the same pose files, the same returned
  poses, with and without the non-ideal knobs;
- io/datasets.py returns equal records (and images) on the TUM and EuRoC
  fixtures of tests/test_datasets.py, and PoseTrack / _slerp agree;
- utils/evaluation.py, colormaps.py and visualization.py return equal
  values;
- no module of the port imports jax, flame_tpu or PIL."""

import ast
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from flame_tpu.io import datasets as jdatasets  # noqa: E402
from flame_tpu.io import synthetic as jsynthetic  # noqa: E402
from flame_tpu.utils import colormaps as jcolormaps  # noqa: E402
from flame_tpu.utils import evaluation as jevaluation  # noqa: E402
from flame_tpu.utils import visualization as jvisualization  # noqa: E402
from flame_tpu_torch.io import datasets, png, synthetic  # noqa: E402
from flame_tpu_torch.utils import (colormaps, evaluation,  # noqa: E402
                                   visualization)

from test_datasets import make_euroc_dir, make_tum_dir  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(mode, shape, seed):
    """Smooth ramps (Sub/Up/Paeth rows) with a band of noise (None rows)."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(rng.integers(0, 7, shape), axis=1).astype(np.uint8)
    img[shape[0] // 3: shape[0] // 2] = rng.integers(
        0, 256, img[shape[0] // 3: shape[0] // 2].shape)
    return img


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3),
                                           ("RGBA", 4)])
def test_png_decodes_pil_files_bit_equal(tmp_path, mode, channels):
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(_image(mode, shape, channels), mode=mode).save(path)
    with Image.open(path) as im:
        raw = np.asarray(im)
        gray = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(png.read(path), raw.reshape(37, 53, -1))
    np.testing.assert_array_equal(png.read_gray(path), gray)


def _encode(rows: np.ndarray, filters, ctype: int) -> bytes:
    """A PNG whose row y uses filter filters[y] (the encoder side of the
    five filters, on the raw (H, W*C) bytes)."""
    H, n = rows.shape
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    r = rows.astype(np.int32)
    out = []
    for y in range(H):
        a = np.concatenate([np.zeros(bpp, np.int32), r[y, :-bpp]])
        b = r[y - 1] if y else np.zeros(n, np.int32)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) >> 1, paeth][filters[y]]
        out.append(bytes([filters[y]]) + ((r[y] - pred) & 0xFF)
                   .astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    W = n // bpp
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2])
def test_png_undoes_every_row_filter(tmp_path, ctype):
    C = 1 if ctype == 0 else 3
    rng = np.random.default_rng(ctype)
    px = rng.integers(0, 256, (15, 11, C)).astype(np.uint8)
    filters = [y % 5 for y in range(15)]
    path = tmp_path / "f.png"
    path.write_bytes(_encode(px.reshape(15, -1), filters, ctype))
    np.testing.assert_array_equal(png.read(str(path)), px)
    with Image.open(path) as im:  # the test encoder makes valid files
        np.testing.assert_array_equal(png.read_gray(str(path)),
                                      np.asarray(im.convert("L")))


def test_png_write_gray_round_trips_through_pil(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (48, 64)).astype(np.uint8)
    path = str(tmp_path / "g.png")
    png.write_gray(path, img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_gray(path), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    path = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError):
        png.read(str(path))
    data = bytearray(path.read_bytes())
    data[20] ^= 0xFF  # inside IHDR: the CRC no longer matches
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read(str(path))


@pytest.mark.parametrize("knobs", [
    dict(pose_noise_t=0.015, pose_noise_deg=0.3, noise_seed=1),
    dict(with_box=True, exposure_drift=0.3, noise_sigma=4.0, noise_seed=5)],
    ids=["pose_noise", "nonideal"])
def test_generate_mini_tum_matches_jax(tmp_path, knobs):
    kw = dict(n_frames=3, width=64, height=48, fx=52.5, **knobs)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmeta = jsynthetic.generate_mini_tum(jroot, **kw)
    tmeta = synthetic.generate_mini_tum(troot, **kw)
    np.testing.assert_array_equal(tmeta["K"], jmeta["K"])
    for key in ("gt", "noisy"):
        if jmeta[key] is None:
            assert tmeta[key] is None
            continue
        for (jq, jt), (tq, tt) in zip(jmeta[key], tmeta[key]):
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(tt, jt)
    names = sorted(os.listdir(jroot))
    assert sorted(os.listdir(troot)) == names
    for name in names:
        if name.endswith(".txt"):
            with open(os.path.join(jroot, name)) as a, \
                    open(os.path.join(troot, name)) as b:
                assert a.read() == b.read(), name
    for name in sorted(os.listdir(os.path.join(jroot, "rgb"))):
        with Image.open(os.path.join(jroot, "rgb", name)) as im:
            np.testing.assert_array_equal(
                png.read_gray(os.path.join(troot, "rgb", name)),
                np.asarray(im))


def test_scene_functions_match_jax():
    K = np.array([[60.0, 0, 40], [0, 60, 30], [0, 0, 1]])
    for i in (0, 5, 17):
        jq, jt = jsynthetic.trajectory(i)
        tq, tt = synthetic.trajectory(i)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(tt, jt)
        for kw in (dict(), dict(with_box=True, with_flat_patch=True,
                                exposure_gain=1.1, exposure_bias=3.0)):
            ji, jd = jsynthetic.render_frame(K, jq, jt, 80, 60, **kw)
            ti, td = synthetic.render_frame(K, tq, tt, 80, 60, **kw)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)
        args = (K, jq, jt, 80, 60, 0, 1.6, 1, (-0.55, 0.55), 2, (2.6, 6.4))
        np.testing.assert_array_equal(synthetic.wall_patch_mask(*args),
                                      jsynthetic.wall_patch_mask(*args))


def _same_records(jframes, tframes):
    assert len(tframes) == len(jframes) > 0
    for j, t in zip(jframes, tframes):
        assert (t.time, t.frame_id, t.image_path) == \
            (j.time, j.frame_id, j.image_path)
        np.testing.assert_array_equal(t.q, j.q)
        np.testing.assert_array_equal(t.t, j.t)
        assert t.q.dtype == j.q.dtype and t.t.dtype == j.t.dtype
    np.testing.assert_array_equal(tframes[0].load_image(),
                                  jframes[0].load_image())


@pytest.mark.parametrize("max_frames", [None, 5])
def test_load_tum_matches_jax(tmp_path, max_frames):
    root = make_tum_dir(str(tmp_path))
    _same_records(jdatasets.load_tum(root, max_frames=max_frames),
                  datasets.load_tum(root, max_frames=max_frames))


def test_load_euroc_matches_jax(tmp_path):
    root = make_euroc_dir(str(tmp_path))
    _same_records(jdatasets.load_euroc(root), datasets.load_euroc(root))
    Tbc = np.eye(4)
    Tbc[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]
    Tbc[:3, 3] = [0.1, 0.0, 0.0]
    _same_records(jdatasets.load_euroc(root, T_body_cam=Tbc),
                  datasets.load_euroc(root, T_body_cam=Tbc))


def test_pose_track_matches_jax():
    rng = np.random.default_rng(7)
    qs = rng.normal(size=(6, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[2] = qs[1] + 1e-5  # nearly equal: the lerp branch of _slerp
    qs[2] /= np.linalg.norm(qs[2])
    ts = rng.normal(size=(6, 3))
    times = [0.0, 0.1, 0.2, 0.35, 5.0, 5.1]
    jt = jdatasets.PoseTrack(times, qs, ts)
    tt = datasets.PoseTrack(times, qs, ts)
    for t in (-0.3, -0.1, 0.0, 0.05, 0.15, 0.3, 2.0, 5.05, 5.3, 9.0):
        for gap in (0.25, 10.0):
            j, p = jt.sample(t, gap), tt.sample(t, gap)
            assert (j is None) == (p is None), (t, gap)
            if j is not None:
                np.testing.assert_array_equal(p[0], j[0])
                np.testing.assert_array_equal(p[1], j[1])
    for u in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(datasets._slerp(qs[0], -qs[3], u),
                                      jdatasets._slerp(qs[0], -qs[3], u))
    assert datasets.tum_default_intrinsics("fr2") == \
        jdatasets.tum_default_intrinsics("fr2")


def test_evaluation_matches_jax():
    rng = np.random.default_rng(11)
    gt = rng.normal(size=(20, 3))
    est = 1.3 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.2 \
        + rng.normal(0, 0.01, (20, 3))
    for with_scale in (False, True):
        for a, b in zip(evaluation.umeyama_alignment(est, gt, with_scale),
                        jevaluation.umeyama_alignment(est, gt, with_scale)):
            np.testing.assert_array_equal(a, b)
        for align in (False, True):
            assert evaluation.ate_rmse(est, gt, align, with_scale) == \
                jevaluation.ate_rmse(est, gt, align, with_scale)
    gt_id = rng.uniform(0.1, 1.0, (30, 40))
    gt_id[:3] = np.nan
    est_id = gt_id * rng.uniform(0.9, 1.1, gt_id.shape)
    est_id[10:15] = np.nan
    for e in (est_id, np.full_like(est_id, np.nan)):
        assert evaluation.depth_error_stats(e, gt_id) == \
            jevaluation.depth_error_stats(e, gt_id)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = q + rng.normal(0, 1e-3, q.shape)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    t = rng.normal(size=(5, 3))
    assert evaluation.pose_errors(q2, t + 0.01, q, t) == \
        jevaluation.pose_errors(q2, t + 0.01, q, t)


def test_colormaps_and_visualization_match_jax():
    rng = np.random.default_rng(13)
    v = rng.uniform(-0.5, 2.0, (24, 32))
    v[0, :5] = np.nan
    w = np.nan_to_num(v)
    for name, args in (("jet", (w, 0.0, 1.5)), ("idepth_color", (v, 2.0)),
                       ("hsl_to_rgb", (360 * w, np.full_like(w, 0.7),
                                       np.full_like(w, 0.4))),
                       ("normal_map", (rng.uniform(-1, 1, (24, 32, 3)),)),
                       ("blend", ((255, 0, 0), (0, 0, 255), w))):
        np.testing.assert_array_equal(getattr(colormaps, name)(*args),
                                      getattr(jcolormaps, name)(*args))
    gray = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    verts = rng.uniform(-5, 55, (12, 2))
    idp = rng.uniform(0.1, 1.0, 12)
    tris = rng.integers(0, 12, (10, 3))
    ok = rng.uniform(size=10) > 0.3
    normals = rng.normal(size=(12, 3))
    idm = rng.uniform(0.1, 1.0, (40, 50))
    idm[5] = np.nan
    for name, args in (
            ("draw_wireframe", (gray, verts, idp, tris, ok, 1.5)),
            ("draw_features", (gray, verts, idp, 1.5, 2)),
            ("draw_idepthmap", (gray, idm, 1.5, 0.6)),
            ("draw_normals", (gray, verts, normals, tris, ok)),
            ("draw_detections", (gray, np.nan_to_num(40 * idm), verts[:4]))):
        np.testing.assert_array_equal(getattr(visualization, name)(*args),
                                      getattr(jvisualization, name)(*args))


PORT_MODULES = (
    "flame_tpu_torch", "flame_tpu_torch.convert", "flame_tpu_torch._kernels",
    "flame_tpu_torch.run_dataset", "flame_tpu_torch.io.png",
    "flame_tpu_torch.io.synthetic", "flame_tpu_torch.io.datasets",
    "flame_tpu_torch.utils.evaluation", "flame_tpu_torch.utils.colormaps",
    "flame_tpu_torch.utils.visualization", "flame_tpu_torch.ba.residuals",
    "flame_tpu_torch.ba.schur", "flame_tpu_torch.ba.rematch",
    "flame_tpu_torch.ba.window", "flame_tpu_torch.core.flame",
    "flame_tpu_torch.core.pipeline", "flame_tpu_torch.parallel.orchestrator",
    "flame_tpu_torch.optimize.smoother_kernel",
    "flame_tpu_torch.ops.raster_kernel",
    "flame_tpu_torch.parallel.halo_kernel")


def test_port_imports_neither_jax_nor_pil():
    """Every port module imports with jax, flame_tpu and PIL blocked."""
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'flame_tpu', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_chip_smoke_imports_neither_jax_nor_pil():
    """chip_smoke.py imports with jax, flame_tpu and PIL blocked, and none
    of its import statements, the lazy ones inside functions included,
    names them."""
    path = os.path.join(REPO, "chip_smoke.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "flame_tpu_torch" in {n.split(".")[0] for n in names}
    for n in names:
        assert n.split(".")[0] not in ("jax", "jaxlib", "flame_tpu", "PIL"), n
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flame_tpu', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            "import chip_smoke\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
