"""The port's window solve (ba.window._solve_packed, on the CPU) against
the benchmark's plain float64 reference (benchmark/reference/ba.py,
loaded from its path with benchmark/compare/ba.py, which computes the
compared numbers), on seeded well-posed windows (ba.window
.well_posed_window) at P 4, L 64, M 256: with the re-match off, with it
on over two small frames of the benchmark's box_room scene, and three
faults that the euroc_wvga.ba cell's limits catch: a solve that returns
the staged poses, the reference in bfloat16 in the program's place, and
a solve on stale frames. The numbers come from compare/ba.py's readings
of one kept solve, as the cell takes them."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flame_tpu_torch import BAParams  # noqa: E402
from flame_tpu_torch.ba import window  # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
P, L, M = 4, 64, 256
W, H, PAD = 160, 120, 5
KN = np.array([[200.0, 0, 80], [0, 200, 60], [0, 0, 1]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    """reference/ba.py, compare/ba.py, box_room and the cell's limits;
    compare/ba.py imports the reference as the harness does, from the
    benchmark's directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCH)
        ref = _load("reference.ba", os.path.join(BENCH, "reference",
                                                 "ba.py"))
        mp.setitem(sys.modules, "reference.ba", ref)
        cmp = _load("bench_compare_ba", os.path.join(BENCH, "compare",
                                                      "ba.py"))
        scene = _load("bench_box_room", os.path.join(BENCH, "scenes",
                                                     "box_room.py"))
    with open(os.path.join(BENCH, "workloads", "euroc_wvga.ba.json")) as f:
        limits = json.load(f)["limits"]
    return dict(ref=ref, cmp=cmp, scene=scene, limits=limits)


@pytest.fixture(scope="module")
def frames(bench):
    """Two 160x120 frames of euroc_mav_wvga's room, 10 frames apart."""
    with open(os.path.join(BENCH, "configs", "euroc_mav_wvga.json")) as f:
        cfg = json.load(f)
    cfg["camera"].update(width=W, height=H, fx=KN[0, 0], fy=KN[1, 1],
                         cx=KN[0, 2], cy=KN[1, 2])
    return bench["scene"].Scene(cfg, "cpu").render_host([0, 10])


def _capture(bench, frames, part, seed):
    """One window as the cell's listener keeps it: the upload, the
    port's flat result and the digest of the padded frames it solved
    on."""
    ref_ba, cmp = bench["ref"], bench["cmp"]
    p = BAParams(max_landmarks=L, max_obs=M,
                 do_rematch=part in ("rematch", "stale"))
    buf = window.well_posed_window(P, L, M, KN, seed, (20, 100),
                                   n_invalid=9)
    img_pad = ref_ba.pad_images(frames[[0, 1, 0, 1]], PAD, torch.float32,
                                "cpu")
    K = torch.tensor(KN, dtype=torch.float32)
    flat = window._solve_packed(p, K, torch.linalg.inv(K),
                                torch.as_tensor(buf), img_pad, PAD, 2, P, L,
                                M).numpy()
    if part == "staged":  # a solve that hands back the staged poses
        flat = np.concatenate([buf[:7 * P].view(np.float32),
                               flat[7 * P:]])
    if part == "stale":  # the stack's slots held other frames
        img_pad = img_pad[[1, 0, 1, 0]]
    return dict(buf=buf, flat=flat, order=[0, 1, 2, 3], P=P, L=L,
                n_obs=M - 9, params=p, pad=PAD, K=K,
                Kinv=torch.linalg.inv(K), digest=cmp.digest(img_pad))


@pytest.mark.parametrize("part,seed", [
    ("plain", 0), ("plain", 1), ("plain", 2), ("rematch", 0),
    ("rematch", 1), ("staged", 0), ("stale", 0), ("bfloat16", 0),
    ("bfloat16", 1)])
def test_window_solve_against_the_reference(bench, frames, part, seed):
    """Every compared number of a sound solve within the cell's limit;
    the two faults beyond the cell's limit of ba_pose_gap (and the
    bfloat16 solve beyond those of ba_lm_gap and ba_cost_gap too); a
    solve on frames other than the fed ones misses every re-match."""
    cap = _capture(bench, frames, part, seed)
    lim = bench["limits"]
    got = bench["cmp"].readings(cap, "cpu", torch.tensor(KN),
                                lambda f: frames[f % 2],
                                control=part == "bfloat16")
    if part == "staged":
        assert got[""]["ba_pose_gap"] > lim["ba_pose_gap"], got[""]
        return
    if part == "stale":
        assert got[""]["ba_rematch_miss"] == 1.0, got[""]
        return
    if part == "bfloat16":
        ctl = got[".control"]
        for name in ("ba_pose_gap", "ba_lm_gap", "ba_cost_gap"):
            assert ctl[name] > lim[name], (name, ctl)
    for name in bench["cmp"].NUMBERS:
        assert got[""][name] <= lim[name], (name, got[""])
    # Every solve here is well posed: both gates accept it.
    assert got[""]["accepted"] and got[""]["ref_accepted"]


def test_reference_imports_torch_alone():
    """reference/ba.py stands alone: no JAX, nothing of either package."""
    import ast
    with open(os.path.join(BENCH, "reference", "ba.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"torch"}
