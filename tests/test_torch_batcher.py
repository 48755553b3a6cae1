"""The port's micro-batcher, deadline context and admission controller
(api_ratelimit_tpu_torch/backends/{batcher,overload}.py, utils/deadline.py)
on the CPU: the reference's own tests (tests/test_tpu_backend.py
TestMicroBatcher, TestMicroBatcherPipelined, TestBlockNativePath's windowed
coalescing and the windowed-cache coalescing test; tests/test_overload.py's
batcher-side classes) run against the port's classes. The fault injector is
the reference's testing/faults.py FaultInjector: the port takes any object
with fire(site)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu.testing.faults import FaultInjector, parse_fault_spec  # noqa: E402
from api_ratelimit_tpu_torch.backends.batcher import MicroBatcher  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache, SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.backends.overload import (  # noqa: E402
    AdmissionController,
    BrownoutError,
    OverloadError,
    QueueFullError,
)
from api_ratelimit_tpu_torch.limiter import BaseRateLimiter  # noqa: E402
from api_ratelimit_tpu_torch.limiter.cache import CacheError, DeadlineExceededError  # noqa: E402
from api_ratelimit_tpu_torch.models import Descriptor, RateLimitRequest, Unit  # noqa: E402
from api_ratelimit_tpu_torch.models.config import RateLimit, new_rate_limit_stats  # noqa: E402
from api_ratelimit_tpu_torch.models.response import RateLimitValue  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.utils.deadline import deadline_scope, time_remaining  # noqa: E402


def _make_limit(store, rpu, unit, key):
    return RateLimit(
        full_key=key,
        stats=new_rate_limit_stats(store, key),
        limit=RateLimitValue(requests_per_unit=rpu, unit=unit),
    )


def _req(*pairs, hits=1):
    return RateLimitRequest(
        domain="domain", descriptors=tuple(Descriptor.of(p) for p in pairs), hits_addend=hits
    )


def _controller(store, **kw):
    return AdmissionController(scope=store.scope("ratelimit"), **kw)


def _brownout(controller):
    for _ in range(8):
        controller.observe_queue_wait(1e6)
    assert controller.brownout


class TestMicroBatcher:
    def test_direct_mode(self):
        calls = []
        b = MicroBatcher(lambda items: (calls.append(len(items)), items)[1])
        assert b.submit([1, 2, 3]) == [1, 2, 3]
        assert calls == [3]

    def test_windowed_coalescing_and_order(self):
        batches = []

        def execute(items):
            batches.append(list(items))
            return [x * 10 for x in items]

        b = MicroBatcher(execute, window_seconds=0.05, max_batch=100)
        out = []
        threads = [
            threading.Thread(target=lambda i=i: out.append((i, b.submit([i]))))
            for i in range(5)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        b.close()
        assert sorted(x for _, [x] in out) == [0, 10, 20, 30, 40]
        assert len(batches) < 5  # coalesced into fewer launches than submits

    def test_oversized_request_taken_alone(self):
        sizes = []

        def execute(items):
            sizes.append(len(items))
            return items

        b = MicroBatcher(execute, window_seconds=0.01, max_batch=4)
        assert b.submit(list(range(10))) == list(range(10))
        assert sizes == [10]
        b.close()

    def test_warm_pipeline_skips_linger(self):
        executing = threading.Event()
        release = threading.Event()

        def execute(items):
            executing.set()
            release.wait(2.0)
            release.clear()
            return items

        b = MicroBatcher(execute, window_seconds=0.5, max_batch=100)
        t1 = threading.Thread(target=lambda: b.submit([1]))
        t1.start()
        assert executing.wait(2.0)  # batch 1 on device
        executing.clear()
        got = []
        t2 = threading.Thread(target=lambda: got.append(b.submit([2])))
        t2.start()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with b._lock:
                if b._futures:
                    break
            time.sleep(0.005)
        s = time.monotonic()
        release.set()  # batch 1 finishes now
        assert executing.wait(2.0)  # batch 2 launched...
        launched_after = time.monotonic() - s
        release.set()
        t1.join(2.0)
        t2.join(2.0)
        b.close()
        assert got == [[2]]
        # ...well inside the 0.5 s window it would otherwise linger
        assert launched_after < 0.25, f"lingered {launched_after:.3f}s"

    def test_error_propagates_to_callers(self):
        def execute(items):
            raise RuntimeError("device on fire")

        b = MicroBatcher(execute, window_seconds=0.01, max_batch=4)
        with pytest.raises(RuntimeError, match="device on fire"):
            b.submit([1])
        b.close()


class TestMicroBatcherPipelined:
    """The double-buffered launch/collect mode: launches overlap the
    previous batch's readback."""

    @staticmethod
    def _make(launch_log, collect_log, collect_gate=None, max_inflight=2):
        def launch(items):
            launch_log.append(list(items))
            return list(items)

        def collect(token):
            if collect_gate is not None:
                collect_gate.wait(2.0)
            collect_log.append(list(token))
            return [x * 10 for x in token]

        return MicroBatcher(
            lambda items: [x * 10 for x in items],
            window_seconds=0.01,
            max_batch=4,
            execute_launch=launch,
            execute_collect=collect,
            max_inflight=max_inflight,
        )

    def test_results_and_order(self):
        launches, collects = [], []
        b = self._make(launches, collects)
        out = []
        threads = [threading.Thread(target=lambda i=i: out.append(b.submit([i]))) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        b.close()
        assert sorted(x for [x] in out) == [i * 10 for i in range(8)]
        assert sorted(launches) == sorted(collects)  # each collected once

    def test_launch_overlaps_collect(self):
        launches, collects = [], []
        gate = threading.Event()
        b = self._make(launches, collects, collect_gate=gate)
        t1 = threading.Thread(target=lambda: b.submit([1]))
        t1.start()
        deadline = time.monotonic() + 2.0
        while not launches and time.monotonic() < deadline:
            time.sleep(0.005)
        t2 = threading.Thread(target=lambda: b.submit([2]))
        t2.start()
        deadline = time.monotonic() + 2.0
        while len(launches) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(launches) == 2, "launch 2 did not overlap collect 1"
        assert collects == []  # nothing collected yet: both in flight
        assert b.overlapped_launches == 1
        gate.set()
        t1.join(2.0)
        t2.join(2.0)
        b.close()
        assert sorted(collects) == [[1], [2]]  # order is caller-driven

    def test_close_with_collects_in_flight(self):
        launches, collects = [], []
        gate = threading.Event()
        b = self._make(launches, collects, collect_gate=gate, max_inflight=1)
        results = []
        threads = [threading.Thread(target=lambda i=i: results.append(b.submit([i]))) for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 2.0
        while not launches and time.monotonic() < deadline:
            time.sleep(0.005)
        closer = threading.Thread(target=b.close)
        closer.start()
        gate.set()
        closer.join(5.0)
        assert not closer.is_alive(), "close() deadlocked"
        for t in threads:
            t.join(5.0)
        assert sorted(x for [x] in results) == [0, 10, 20]

    def test_collect_error_propagates(self):
        def collect(token):
            raise RuntimeError("readback failed")

        b = MicroBatcher(
            lambda items: items, window_seconds=0.01, max_batch=4,
            execute_launch=lambda items: list(items), execute_collect=collect,
        )
        with pytest.raises(RuntimeError, match="readback failed"):
            b.submit([1])
        b.close()

    def test_flush_waits_for_collects(self):
        launches, collects = [], []
        gate = threading.Event()
        b = self._make(launches, collects, collect_gate=gate)
        t = threading.Thread(target=lambda: b.submit([7]))
        t.start()
        deadline = time.monotonic() + 2.0
        while not launches and time.monotonic() < deadline:
            time.sleep(0.005)
        flushed = threading.Event()
        f = threading.Thread(target=lambda: (b.flush(), flushed.set()))
        f.start()
        time.sleep(0.05)
        assert not flushed.is_set()  # collect still gated => not idle
        gate.set()
        f.join(2.0)
        assert flushed.is_set()
        t.join(2.0)
        b.close()


def test_block_mode_row_ring_copies_the_callers_scratch():
    """Block mode with a row ring: the queue holds views into the ring, so
    a caller rewriting its scratch right after submitting (here: another
    thread's batch-mate) cannot change what launches."""
    seen = []

    def launch(blocks):
        seen.append([b[2].tolist() for b in blocks])
        return [np.array(b[2]) for b in blocks]

    b = MicroBatcher(
        None, window_seconds=0.01, max_batch=64, block_mode=True, arena_rows=16,
        execute_launch=launch, execute_collect=np.concatenate,
    )
    assert b.consumes_submits
    scratch = np.zeros((6, 4), np.uint32)
    scratch[2] = [1, 2, 3, 4]
    out = b.submit(scratch)
    scratch[2] = 99
    assert out.tolist() == [1, 2, 3, 4] and seen == [[[1, 2, 3, 4]]]
    # larger than the ring: an owned copy, still correct
    big = np.zeros((6, 20), np.uint32)
    big[2] = np.arange(20)
    assert b.submit(big).tolist() == list(range(20))
    b.close()


def test_windowed_block_coalescing():
    """Row blocks from concurrent submitters coalesce into shared launches
    of the port's windowed engine (leader-collects arm), and each submitter
    gets exactly its own slice back."""
    from concurrent.futures import ThreadPoolExecutor

    eng = SlabDeviceEngine(
        FakeTimeSource(1000), n_slots=1 << 12, device="cpu",
        batch_window_seconds=0.005, dispatch_loop=False,
    )
    assert eng.dispatch_loop is None

    def one(k):
        n = 64
        block = np.zeros((6, n), dtype=np.uint32)
        block[0] = np.arange(n, dtype=np.uint32) // 8 + 1000 * (k + 1)
        block[1] = k + 1
        block[2] = 1
        block[3] = 1_000_000
        block[4] = 60
        return eng.submit_rows(block)

    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(one, range(4)))
    for out in outs:
        # 8 duplicates per key serialize within the submitter's block
        assert out.tolist() == [i % 8 + 1 for i in range(64)]
    assert eng.health_snapshot()["decisions"] == 4 * 64
    assert eng.batcher.launches == len(eng.launch_sizes) <= 4
    assert sum(eng.launch_sizes) == 4 * 64
    eng.close()


def test_windowed_batching_coalesces_concurrent_requests():
    ts = FakeTimeSource(1_000_000)
    store = Store()
    cache = CudaRateLimitCache(
        BaseRateLimiter(ts, near_limit_ratio=0.8), n_slots=1 << 12,
        batch_window_seconds=0.02, buckets=(128, 1024), max_batch=1024, device="cpu",
    )
    limit = _make_limit(store, 100, Unit.MINUTE, "k_v")
    results = []

    def worker():
        resp = cache.do_limit(_req(("k", "v")), [limit])
        results.append(resp.descriptor_statuses[0])

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    cache.flush()
    assert len(results) == 8
    # all 8 hits serialized against one counter
    assert sorted(s.limit_remaining for s in results) == [92, 93, 94, 95, 96, 97, 98, 99]
    assert cache.engine.dispatch_loop is not None  # the default arm
    cache.close()


# -- tests/test_overload.py's batcher-side classes ---------------------------


class TestDeadlineContext:
    def test_no_scope_means_no_deadline(self):
        assert time_remaining() is None

    def test_scope_sets_and_restores(self):
        with deadline_scope(5.0):
            remaining = time_remaining()
            assert remaining is not None and 4.0 < remaining <= 5.0
            with deadline_scope(0.1):
                assert time_remaining() <= 0.1
            assert time_remaining() > 4.0
        assert time_remaining() is None


class TestBatcherDeadline:
    def test_direct_mode_expired_sheds_before_execute(self):
        executed = []
        b = MicroBatcher(lambda items: executed.append(items) or [0] * len(items))
        with deadline_scope(-0.001):
            with pytest.raises(DeadlineExceededError):
                b.submit([1])
        assert executed == []
        assert b.deadline_drops == 1
        assert b.submit([1]) == [0]

    def test_windowed_expired_items_never_reach_a_launch(self):
        launched: list = []

        def execute(items):
            launched.extend(items)
            return [0] * len(items)

        b = MicroBatcher(execute, window_seconds=0.02)
        results = {}

        def worker(name, remaining):
            def run():
                try:
                    with deadline_scope(remaining):
                        results[name] = b.submit([name])
                except DeadlineExceededError:
                    results[name] = "expired"

            t = threading.Thread(target=run)
            t.start()
            return t

        threads = [worker("dead", -0.001), worker("live", None)]
        for t in threads:
            t.join(10.0)
        b.close()
        assert results["dead"] == "expired"
        assert results["live"] == [0]
        assert launched == ["live"]
        assert b.deadline_drops == 1

    def test_controller_counts_deadline_drops(self):
        store = Store()
        c = _controller(store)
        b = MicroBatcher(lambda items: [0] * len(items), overload=c)
        with deadline_scope(-0.001):
            with pytest.raises(DeadlineExceededError):
                b.submit([1])
        assert store.debug_snapshot()["ratelimit.overload.deadline_expired"] == 1


class TestQueueBound:
    def test_max_queue_sheds_instantly_while_stalled(self):
        start = threading.Event()
        release = threading.Event()

        def execute(items):
            start.set()
            assert release.wait(10.0)
            return [0] * len(items)

        b = MicroBatcher(execute, window_seconds=0.005, max_queue=2)
        stalled = threading.Thread(target=lambda: b.submit(["a"]))
        stalled.start()
        assert start.wait(5.0)  # dispatcher is now wedged in execute()
        waiters = [
            threading.Thread(target=lambda: b.submit(["b"])),
            threading.Thread(target=lambda: b.submit(["c"])),
        ]
        for t in waiters:
            t.start()
        deadline = time.monotonic() + 5.0
        while b.queue_depth < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b.queue_depth == 2
        t0 = time.monotonic()
        with pytest.raises(QueueFullError):
            b.submit(["d"])
        assert time.monotonic() - t0 < 1.0  # shed instantly, no queueing
        release.set()
        stalled.join(10.0)
        for t in waiters:
            t.join(10.0)
        b.close()

    def test_injected_queue_full_fault(self):
        faults = FaultInjector(parse_fault_spec("batcher.submit:queue_full:1.0"))
        b = MicroBatcher(lambda items: [0] * len(items), fault_injector=faults)
        with pytest.raises(QueueFullError, match="injected"):
            b.submit([1])
        assert faults.fired() == {"batcher.submit:queue_full": 1}

    def test_injected_delay_stalls_submit(self):
        slept = []
        faults = FaultInjector(parse_fault_spec("batcher.submit:delay_ms:250"), sleep=slept.append)
        b = MicroBatcher(lambda items: [0] * len(items), fault_injector=faults)
        assert b.submit([1]) == [0]
        assert slept == [0.25]


class TestBrownoutHysteresis:
    def test_enter_and_exit_with_hysteresis(self):
        store = Store()
        c = _controller(store, brownout_target_ms=5.0, brownout_exit_ms=2.0, ewma_alpha=1.0)
        assert not c.brownout
        c.observe_queue_wait(10.0)
        assert c.brownout  # 10 > 5: enter
        c.observe_queue_wait(3.0)
        assert c.brownout  # 3 in (2, 5]: hysteresis holds it in
        c.observe_queue_wait(1.0)
        assert not c.brownout  # 1 < 2: exit
        snap = store.debug_snapshot()
        assert snap["ratelimit.overload.brownout"] == 0
        assert snap["ratelimit.overload.queue_wait_ewma_us"] == 1000

    def test_default_exit_is_half_target(self):
        c = _controller(Store(), brownout_target_ms=10.0, ewma_alpha=1.0)
        c.observe_queue_wait(11.0)
        assert c.brownout
        c.observe_queue_wait(6.0)  # above 10/2: still browned out
        assert c.brownout
        c.observe_queue_wait(4.0)  # below 10/2: out
        assert not c.brownout

    def test_degraded_reason_while_browned_out(self):
        c = _controller(Store(), brownout_target_ms=5.0, ewma_alpha=1.0)
        assert c.degraded_reason() is None
        c.observe_queue_wait(50.0)
        assert "brownout" in c.degraded_reason()

    def test_batcher_sheds_during_brownout(self):
        c = _controller(Store(), brownout_target_ms=1.0, ewma_alpha=1.0)
        _brownout(c)
        b = MicroBatcher(lambda items: [0] * len(items), overload=c)
        with pytest.raises(BrownoutError):
            b.submit([1])

    def test_validation(self):
        with pytest.raises(ValueError, match="hysteresis"):
            _controller(Store(), brownout_target_ms=5.0, brownout_exit_ms=5.0)
        with pytest.raises(ValueError, match="alpha"):
            _controller(Store(), ewma_alpha=0.0)
        with pytest.raises(ValueError, match="shed mode"):
            AdmissionController(shed_mode="nope")

    def test_shed_bookkeeping_is_sticky_until_ok(self):
        store = Store()
        c = _controller(store)
        err = QueueFullError("full")
        assert isinstance(err, OverloadError) and isinstance(err, CacheError)
        c.note_shed(err)
        assert "queue_full" not in (c.degraded_reason() or "") and "QueueFullError" in c.degraded_reason()
        c.note_ok()
        assert c.degraded_reason() is None
        snap = store.debug_snapshot()
        assert snap["ratelimit.overload.shed"] == 1 and snap["ratelimit.overload.queue_full"] == 1
