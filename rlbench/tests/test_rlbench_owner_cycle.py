"""rlbench/owner_cycle.py: the owner's cycle spans laid over the device
idle. The card test reads a short run on the card:
    python3 -m pytest rlbench/tests/test_rlbench_owner_cycle.py -q -m card
"""

from types import SimpleNamespace

import pytest

from rlbench import owner_cycle as oc

DEVICE = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 100.0, 110.0)]  # idle 10-30, 40-100
OWNER = [("dispatch.batch", 0.0, 120.0),  # a parent: read by no phase
         ("engine.step_enqueue", 5.0, 15.0), ("engine.readback_enqueue", 15.0, 20.0),
         ("engine.fence_wait", 20.0, 35.0), ("dispatch.scatter", 45.0, 50.0),
         ("dispatch.turn", 50.0, 55.0), ("dispatch.linger", 60.0, 70.0),
         ("dispatch.take", 70.0, 75.0), ("engine.pack", 75.0, 90.0)]


def test_each_idle_gap_is_split_by_the_owners_phase():
    got = oc.split_idle(DEVICE, OWNER, launches=2)
    want = {"enqueue": 10.0, "redeem": 15.0, "turn": 5.0, "starved": 10.0, "pack": 20.0}
    for phase, us in want.items():
        assert got[phase] == pytest.approx(us / 2 * 1e-3), phase
    # 60 of the 80 us of idle lie in a phase: the rest is the owner between spans
    assert got["idle"] == pytest.approx(80 / 2 * 1e-3)
    assert got["between"] == pytest.approx(20 / 2 * 1e-3)
    assert got["share"] == pytest.approx(60 / 80)
    assert set(got) == set(oc.OWNER_PHASES) | {"between", "idle", "share"}
    # the holes: 35-45 (fence_wait>scatter, 5 us of it idle past 40) and 55-60
    assert oc.idle_between_by_pair(DEVICE, OWNER, 2) == {
        "dispatch.turn>dispatch.linger": pytest.approx(2.5e-3),
        "engine.fence_wait>dispatch.scatter": pytest.approx(2.5e-3),
    }


def test_every_cycle_span_has_one_phase():
    names = [n for names in oc.OWNER_PHASES.values() for n in names]
    assert len(names) == len(set(names))
    assert {n for n, _, _ in oc.children(OWNER)} <= set(names)


def test_owner_spans_land_on_the_profilers_timeline():
    start_ns = 1_792_000_000_123_456_789
    spans = [SimpleNamespace(operation_name="engine.pack", start_time=(start_ns + 2_000_000) / 1e9, duration=250e-6),
             SimpleNamespace(operation_name="dispatch.take", start_time=(start_ns + 1_000_000) / 1e9, duration=1e-6)]
    got = oc.owner_timeline(spans, start_ns)
    assert [g[0] for g in got] == ["dispatch.take", "engine.pack"]
    assert got[0][1] == pytest.approx(1000.0, abs=0.5) and got[1][2] == pytest.approx(2250.0, abs=0.5)


def test_runtime_calls_are_matched_to_the_span_they_lie_in():
    owner = [("dispatch.batch", 0.0, 400.0), ("engine.step_enqueue", 0.0, 100.0),
             ("engine.fence_wait", 300.0, 400.0)]
    runtime = [("cudaLaunchKernel", 50.0, 60.0), ("cudaMemcpyAsync", 95.0, 108.0),  # within the slack
               ("cudaLaunchKernel", 150.0, 160.0),  # in the hole between the spans
               ("cudaLaunchKernel", 350.0, 360.0), ("cudaLaunchKernel", 500.0, 501.0)]  # the last after the slice
    assert oc.calls_inside(runtime, owner, window_us=450.0) == (3, 4)


def test_the_diagnostic_records_and_restores_the_tracer_on_the_cpu(monkeypatch):
    """At a tiny size on the CPU (whose profiler names no device activity:
    the check is waived), recorded slices hold the owner's cycle spans,
    the others none, and the global tracer is the one from before."""
    from api_ratelimit_tpu_torch import tracing
    from rlbench import trace as T
    from rlbench_helpers import TINY_POOL_ROWS, tiny

    monkeypatch.setattr(T, "_names_device_activity", lambda prof: True)
    tracing.reset_global_tracer()
    lines = []
    got = oc.measure("fixed.zipf", 2**31 + 41, 2, 0.3, device="cpu",
                     tiny=lambda c, t: (*tiny(c, t), TINY_POOL_ROWS), emit=lines.append)
    assert not tracing.is_global_tracer_registered() and not tracing.global_tracer().enabled
    on, off = got["slices"]
    assert on["recorded"] and on["owner_spans"] > 0 and not on["ring_full"]
    assert not off["recorded"] and "owner_spans" not in off
    assert got["run"]["correct"] is True
    assert got["run"]["device.step_enqueue_ms"] > 0 and 0 <= got["run"]["dispatch.owner_offcpu_pct"] <= 100
    assert len(lines) == 3


@pytest.mark.card
def test_owner_spans_share_the_profilers_clock_and_cover_the_idle(card):
    """A short run of fixed.zipf on the card. At least 95% of the owner
    thread's cudaLaunchKernel and cudaMemcpyAsync calls in the recorded
    slice lie inside one of its cycle spans (the program's anchored clock
    against the profiler's, on the card's build of torch), and the owner's
    phases cover 80-100% of the slice's device idle."""
    got = oc.measure("fixed.zipf", 2**31 + 23, 2, 1.0)
    assert got["run"]["correct"] is True
    on = got["slices"][0]
    inside, calls = on["calls_inside"]
    print(f"runtime calls inside an owner span: {inside} of {calls}; idle {on['idle_ms']}")
    assert calls >= 1000 and inside >= 0.95 * calls
    assert 0.8 <= on["idle_ms"]["share"] <= 1.0
