"""The roofline files' bytes and operations on inputs counted by hand."""

import math

import torch

from harness import registry
from reference import raster as ref_raster

ROOF = registry.rooflines()


def test_k1_by_hand():
    # 3 member vertices of 65 bytes (10 words and a mask byte in, 6 words
    # out), 2 live edges of 32 bytes (5 words in, 3 out); one iteration:
    # 52 operations per edge, 21 per vertex, and 5 per edge once.
    assert ROOF["k1"].counts(3, 2, 1) == (3 * 65 + 2 * 32,
                                          2 * 52 + 3 * 21 + 2 * 5)
    rec = dict(vtx=torch.tensor([True, True, False, True]),
               edges=torch.tensor([True, False, True]), n_iters=40)
    assert ROOF["k1"].cost(rec) == (259, 40 * (104 + 63) + 10)


def _one_triangle():
    verts = torch.tensor([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0], [7.0, 5.0]])
    tris = torch.tensor([[0, 1, 2], [1, 2, 3]])
    valid = torch.tensor([True, False])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0])
    maps = ref_raster.rasterize(verts[None], tris, vals[None], valid[None],
                                6, 8, max_per_tile=160)
    return verts, tris, valid, maps


def test_k2_by_hand():
    verts, tris, valid, maps = _one_triangle()
    covered = int((~torch.isnan(maps)).sum())
    assert covered == 15  # x, y >= 0 and x + y <= 4
    rec = dict(verts=verts, tris=tris, tri_valid=valid, maps=maps[0])
    nbytes, ops = ROOF["k2"].cost(rec)
    # 3 vertices x 12 bytes, one triangle's 3 indices, 2 validity bytes,
    # a 6 x 8 map of 4-byte words; setup 30, its 5 x 5 bbox pixels x 15,
    # the 15 covered pixels x 7.
    assert nbytes == 36 + 12 + 2 + 4 * 48
    assert math.isclose(ops, 30 + 15 * 25 + 7 * 15)


def test_k2b_by_hand():
    verts, tris, valid, _ = _one_triangle()
    v2 = torch.stack([verts, verts + torch.tensor([1.0, 0.0])])
    val2 = torch.stack([valid, valid])
    maps = ref_raster.rasterize(v2, tris, torch.ones(2, 4), val2, 6, 8,
                                max_per_tile=192, union=True)
    assert [int((~torch.isnan(m)).sum()) for m in maps] == [15, 15]
    nbytes, ops = ROOF["k2b"].cost(dict(verts=v2, tris=tris, tri_valid=val2,
                                        maps=maps))
    assert nbytes == 2 * 36 + 12 + 2 * 2 + 4 * 2 * 48
    assert math.isclose(ops, 2 * (30 + 15 * 25 + 7 * 15))
