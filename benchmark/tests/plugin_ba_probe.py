"""A compared-number plug-in for the tests, copied into a benchmark
copy's compare/: once armed, it keeps the solved poses of the next
bundle-adjustment result that lands (BundleAdjuster._apply, a method),
in the armed read or a later one. ba_qnorm_gap is the largest
| |q| - 1 | over the solved quaternions; its control rounds them to
bfloat16 first."""

import numpy as np
import torch

NUMBERS = ("ba_qnorm_gap",)
HOOKS = [("flame_tpu_torch.ba.window", "BundleAdjuster._apply")]


class Listener:
    def __init__(self):
        self.armed = False
        self.kept = []

    def arm(self) -> None:
        self.armed = True

    def take(self) -> list:
        kept, self.kept = self.kept, []
        return kept

    def before(self, point, args, kwargs):
        if not self.armed:
            return None
        self.armed = False
        _ba, _fl, flat, meta = args[:4]
        return np.array(flat[:4 * meta["P"]]).reshape(-1, 4)

    def after(self, point, token, out) -> None:
        if token is not None:
            self.kept.append(token)


def numbers(captures, device, cfg, image, control=False) -> dict:
    out = {}

    def gap(q):
        return float((q.double().norm(dim=1) - 1).abs().max())
    for q in captures:
        q = torch.as_tensor(q, device=device)
        out["ba_qnorm_gap"] = max(out.get("ba_qnorm_gap", 0.0), gap(q))
        if control:
            out["ba_qnorm_gap.control"] = max(
                out.get("ba_qnorm_gap.control", 0.0),
                gap(q.to(torch.bfloat16)))
    return out
