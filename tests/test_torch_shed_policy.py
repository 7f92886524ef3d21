"""tests/test_shed_policy.py on the port: the bounded-shed flow control of
the packed snapshots (flame_tpu_torch/core/flame.py _drain_packed_queue,
_reap_zombies), which feeds the bench's packed_sheds.

The update thread never blocks on a stale snapshot in flight while shed
budget remains; past the budget the head is joined, so the host mirror
cannot drift without bound. The nine policy cases drive
_drain_packed_queue with the JAX test's fake transfers (FakeFetch: a
landing state the test controls; on the CPU a real copy lands at once),
on the JAX test's Params carried over through convert. The tenth runs the
whole pipeline with every snapshot reported not ready for its first
polls: the run must shed, not stall, and still give a dense map.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
import flame_tpu_torch.core.flame as flame_mod  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.geometry import camera  # noqa: E402
from test_shed_policy import FX, H, PLANE_Z, W, FakeFetch  # noqa: E402
from test_shed_policy import make_params as jax_params  # noqa: E402
from test_shed_policy import render  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_params(**solver_kw):
    return convert.params_from_dict(dataclasses.asdict(
        jax_params(**solver_kw)))


def make_flame(params):
    K = camera.make_k(FX, FX, W / 2, H / 2)
    return flame_tpu_torch.Flame(W, H, K, camera.inv_k(K), params,
                                 device="cpu")


def make_policy_flame(**solver_kw):
    fl = make_flame(make_params(join_age=4, **solver_kw))
    fl._consumed = []
    fl._consume_packed = lambda pk, fr, meta: (
        fl._consumed.append(fr) or True)
    return fl


def stat(fl, name):
    return fl.stats.snapshot()["stats"].get(name, 0)


def test_young_inflight_head_is_left_alone():
    fl = make_policy_flame()
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10], [True]), [None]))
    fl.num_imgs = 12  # age 2 < join_age 4
    assert fl._drain_packed_queue()
    assert len(fl._packed_queue) == 1 and not pk.joined
    assert not fl._consumed and stat(fl, "packed_sheds") == 0


def test_ready_head_consumed_and_resets_shed_counter():
    fl = make_policy_flame()
    fl._sheds_since_consume = 3
    # Frame 10 entered update() at 99.95 s (its update span's start).
    fl.stats.record("update", round(99.95e9), round(99.96e9), frames=(10,))
    fl._packed_queue.append((FakeFetch(ready=True), 10, ([10], [True]),
                             [10]))
    fl.num_imgs = 11
    assert fl._drain_packed_queue()
    assert fl._consumed == [10]
    assert fl._sheds_since_consume == 0
    # t_done (100.05) - frame 10's update span start (99.95) = 100 ms.
    p50, p95 = fl.latency_percentiles()
    assert abs(p50 - 100.0) < 1e-6 and abs(p95 - 100.0) < 1e-6


def test_stale_head_is_shed_not_joined():
    fl = make_policy_flame()
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10, 11], [True, False]),
                             [None, None]))
    fl.num_imgs = 14  # age 4 >= join_age 4
    assert fl._drain_packed_queue()
    assert not fl._packed_queue and not pk.joined
    assert not fl._consumed
    assert stat(fl, "packed_sheds") == 1
    assert fl._sheds_since_consume == 1
    # A shed is an unready transfer: the readiness EMA records it.
    assert stat(fl, "fetch_ready_frac") < 1.0
    # The copy cannot be cancelled: it counts in flight until it lands.
    assert fl._in_flight_fetches() == 1
    pk._ready = True
    pk.t_done = 100.3
    assert fl._in_flight_fetches() == 0


def test_shed_notes_ba_obs_drop():
    fl = make_policy_flame()
    fl._ba = object()  # _note_ba_obs_drop reads only that it is set
    fl._packed_queue.append((FakeFetch(ready=False), 10,
                             ([10, 11], [True, True]), [None, None]))
    fl.num_imgs = 20
    assert fl._drain_packed_queue()
    assert stat(fl, "ba_obs_dropped_pfs") == 2


def test_exhausted_budget_forces_blocking_join():
    fl = make_policy_flame(max_consecutive_sheds=2)
    fl._sheds_since_consume = 2
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10], [False]), [None]))
    fl.num_imgs = 20
    assert fl._drain_packed_queue()
    assert pk.joined
    assert fl._consumed == [10]
    assert fl._sheds_since_consume == 0
    assert stat(fl, "packed_sheds") == 0


def test_sheds_disabled_restores_blocking_behavior():
    fl = make_policy_flame(max_consecutive_sheds=0)
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 10, ([10], [False]), [None]))
    fl.num_imgs = 14
    assert fl._drain_packed_queue()
    assert pk.joined and fl._consumed == [10]
    assert stat(fl, "packed_sheds") == 0


def test_consecutive_sheds_then_backstop():
    """The budget counts sheds across drains until a consume: two stale
    heads shed, the third forces a join."""
    fl = make_policy_flame(max_consecutive_sheds=2)
    fl.num_imgs = 20
    for i in range(2):
        fl._packed_queue.append((FakeFetch(ready=False), 10 + i,
                                 ([i], [False]), [None]))
        assert fl._drain_packed_queue()
    assert stat(fl, "packed_sheds") == 2 and not fl._consumed
    pk = FakeFetch(ready=False)
    fl._packed_queue.append((pk, 12, ([2], [False]), [None]))
    assert fl._drain_packed_queue()
    assert pk.joined and fl._consumed == [12]


def test_staging_respects_zombie_link_slots():
    """Shed copies count in flight until they land, so the staging depth
    (topology_lag) counts them."""
    fl = make_policy_flame()
    z1, z2 = FakeFetch(ready=False), FakeFetch(ready=False)
    fl._zombie_fetches = [(z1, None), (z2, None)]
    assert fl._in_flight_fetches() == 2  # == topology_lag: no room
    z1._ready = True
    z1.t_done = 100.1
    assert fl._in_flight_fetches() == 1


def test_zombie_transfer_error_is_counted_not_raised():
    fl = make_policy_flame()
    pk = FakeFetch(ready=True)
    pk._exc = RuntimeError("copy failed")
    fl._zombie_fetches = [(pk, None)]
    fl._reap_zombies()  # must not raise
    assert stat(fl, "zombie_fetch_errors") == 1
    assert not fl._zombie_fetches


def test_e2e_with_delayed_fetches(monkeypatch):
    """Every snapshot reports not ready for its first polls, forcing the
    stale-head path: the run sheds, stays healthy, and still gives a
    dense map once the copies land."""
    real_fetch = flame_mod._AsyncFetch

    class SlowFetch(real_fetch):
        __slots__ = ("_polls",)
        delay_polls = 6

        def __init__(self, packed):
            super().__init__(packed)
            self._polls = 0

        def ready(self):
            self._polls += 1
            if self._polls <= self.delay_polls:
                return False
            return super().ready()

    monkeypatch.setattr(flame_mod, "_AsyncFetch", SlowFetch)
    fl = make_flame(make_params(join_age=2, max_consecutive_sheds=3))
    for i in range(16):
        cam_x = 0.15 * i
        fl.update(i * 0.1, i, (np.array([1.0, 0.0, 0.0, 0.0]),
                               np.array([cam_x, 0.0, 0.0])),
                  render(cam_x), i % 2 == 0)
    assert stat(fl, "packed_sheds") > 0
    idm = fl.get_inverse_depth_map()
    assert np.mean(~np.isnan(idm)) > 0.3
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert np.median(err) < 0.05
    # Samples from the consumed snapshots and the landed zombies.
    assert fl.latency_percentiles() is not None
