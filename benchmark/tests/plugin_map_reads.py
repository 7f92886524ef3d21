"""A compared-number plug-in for the tests, copied into a benchmark
copy's compare/: reads_since_arm counts the map reads
(Flame.get_inverse_depth_map, a method) from the latest sampled read
through the window's drain."""

NUMBERS = ("reads_since_arm",)
HOOKS = [("flame_tpu_torch.core.flame", "Flame.get_inverse_depth_map")]


class Listener:
    def __init__(self):
        self.count = None

    def arm(self) -> None:
        self.count = 0

    def take(self) -> list:
        count, self.count = self.count, None
        return [] if count is None else [count]

    def before(self, point, args, kwargs):
        return None if self.count is None else True

    def after(self, point, token, out) -> None:
        if token:
            self.count += 1


def numbers(captures, device, cfg, image, control=False) -> dict:
    return {"reads_since_arm": float(captures[0])} if captures else {}
