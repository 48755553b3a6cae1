"""The port's device-owner dispatch loop (api_ratelimit_tpu_torch/backends/
dispatch.py) and the windowed engine's launch/collect split
(backends/cuda.py), on the CPU: the reference's tests/test_dispatch.py
TestSubmitRing, TestDispatchLoop and TestEngineParity and tests/
test_overload.py TestDispatchLoopOverloadParity against the port's classes,
then the cross-package check: the JAX windowed SlabDeviceEngine and the
port's, on one clock, give identical per-submit result bytes and table bytes
over one serial stream in both arms. Also the operand pool's fence: a
buffer is repacked only after the launch that last read it has finished."""

import queue
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from api_ratelimit_tpu.backends.tpu import SlabDeviceEngine as JaxEngine  # noqa: E402
from api_ratelimit_tpu_torch.testing.faults import FaultInjector  # noqa: E402
from api_ratelimit_tpu.utils import FakeTimeSource as JaxClock  # noqa: E402
from api_ratelimit_tpu_torch.backends import cuda as cuda_mod  # noqa: E402
from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine  # noqa: E402
from api_ratelimit_tpu_torch.backends.dispatch import (  # noqa: E402
    FAULT_SITE_LAUNCH,
    DispatchLoop,
    SubmitRing,
    _Ticket,
)
from api_ratelimit_tpu_torch.backends.overload import (  # noqa: E402
    AdmissionController,
    BrownoutError,
    QueueFullError,
)
from api_ratelimit_tpu_torch.limiter.cache import CacheError, DeadlineExceededError  # noqa: E402
from api_ratelimit_tpu_torch.stats import Store  # noqa: E402
from api_ratelimit_tpu_torch.utils import FakeTimeSource  # noqa: E402
from api_ratelimit_tpu_torch.utils.deadline import deadline_scope  # noqa: E402


def _block(values, rows=6):
    """uint32[6, n] block whose hits row carries `values`."""
    block = np.zeros((rows, len(values)), dtype=np.uint32)
    block[2] = values
    return block


def _echo_loop(**kwargs):
    """A loop whose fake device echoes each block's hits row back."""
    return DispatchLoop(
        lambda blocks: [np.array(b[2]) for b in blocks],
        lambda token: np.concatenate(token),
        **kwargs,
    )


def _wait_for(cond, timeout=2.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


class TestSubmitRing:
    def test_publish_take_roundtrip_and_wraparound(self):
        ring = SubmitRing(slots=8, arena_rows=32)
        ticket = _Ticket()
        for i in range(100):
            n = 1 + (i % 5)
            ring.publish(_block([i] * n), n, None, time.monotonic(), ticket)
            slot = ring.slots[ring.head & ring.mask]
            ring.slots[ring.head & ring.mask] = None
            rows, count, _dl, _enq, _t, arena_used = slot
            assert rows[2].tolist() == [i] * n
            # an untraced frame clears its ctx row's flags word
            assert int(ring.ctx[ring.head & ring.mask, 3]) == 0
            assert count == n
            ring.head += 1
            ring.items_out += count
            ring.rows_out += arena_used
        assert ring.depth == 0

    def test_overflow_raises_queue_full_not_corruption(self):
        ring = SubmitRing(slots=8, arena_rows=1 << 12)
        ticket = _Ticket()
        for i in range(8):
            ring.publish(_block([i]), 1, None, 0.0, ticket)
        with pytest.raises(QueueFullError):
            ring.publish(_block([99]), 1, None, 0.0, ticket)
        assert [ring.slots[i & ring.mask][0][2][0] for i in range(8)] == list(range(8))

    def test_arena_exhaustion_falls_back_to_owned_copy(self):
        ring = SubmitRing(slots=64, arena_rows=4)
        ticket = _Ticket()
        src = _block([7, 8, 9])
        ring.publish(src, 3, None, 0.0, ticket)  # arena
        ring.publish(src, 3, None, 0.0, ticket)  # would wrap: copy
        src[:] = 0xFFFF  # caller reuses scratch
        first, second = ring.slots[0][0], ring.slots[1][0]
        assert second.base is None or second.base is not ring.arena
        assert first[2].tolist() == [7, 8, 9]
        assert second[2].tolist() == [7, 8, 9]
        assert ring.overflow_count == 1


def _two_producers(loop):
    """Two producer threads that keep one ring each across submits."""
    jobs = [queue.Queue(), queue.Queue()]
    outs = [[], []]

    def producer(k):
        while True:
            v = jobs[k].get()
            if v is None:
                return
            outs[k].append(int(loop.submit(_block([v]))[0]))

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    return jobs, outs, threads


class TestDispatchLoop:
    def test_results_and_order(self):
        loop = _echo_loop()
        try:
            outs = {}
            lock = threading.Lock()

            def worker(tid):
                got = loop.submit(_block([tid * 10, tid * 10 + 1]))
                with lock:
                    outs[tid] = got.tolist()

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(5.0)
            assert outs == {t: [t * 10, t * 10 + 1] for t in range(8)}
        finally:
            loop.close()

    def test_launch_overlaps_redeem(self):
        """While batch 1's readback is gated, a second known producer's
        frame must LAUNCH: the double-buffer overlap."""
        launches = []
        gate = threading.Event()
        gate.set()

        def launch(blocks):
            launches.append(len(blocks))
            return [np.array(b[2]) for b in blocks]

        def collect(token):
            gate.wait(5.0)
            return np.concatenate(token)

        loop = DispatchLoop(launch, collect, ready=lambda t: gate.is_set())
        jobs, outs, threads = _two_producers(loop)
        try:
            jobs[0].put(101)
            jobs[1].put(102)
            assert _wait_for(lambda: outs[0] and outs[1])  # census warm-up
            gate.clear()
            n_before = len(launches)
            jobs[0].put(1)  # batch 1: launched, readback gated
            assert _wait_for(lambda: len(launches) >= n_before + 1)
            jobs[1].put(2)  # must launch WHILE batch 1 is still gated
            assert _wait_for(lambda: len(launches) >= n_before + 2), "launch 2 did not overlap redeem 1"
            assert loop.overlapped_launches >= 1
            gate.set()
        finally:
            gate.set()
            for j in jobs:
                j.put(None)
            for t in threads:
                t.join(5.0)
            loop.close()
        assert outs == [[101, 1], [102, 2]]

    def test_drain_resolves_tickets_parked_in_both_inflight_buffers(self):
        gate = threading.Event()
        gate.set()
        launched = []

        def launch(blocks):
            launched.append(len(blocks))
            return [np.array(b[2]) for b in blocks]

        def collect(token):
            gate.wait(5.0)
            return np.concatenate(token)

        loop = DispatchLoop(launch, collect, ready=lambda t: gate.is_set())
        jobs, outs, threads = _two_producers(loop)
        jobs[0].put(101)
        jobs[1].put(102)
        assert _wait_for(lambda: outs[0] and outs[1])
        gate.clear()
        n_before = len(launched)
        jobs[0].put(1)
        assert _wait_for(lambda: len(launched) >= n_before + 1)
        jobs[1].put(2)
        assert _wait_for(lambda: len(launched) >= n_before + 2)
        assert len(launched) == n_before + 2  # both buffers occupied
        drainer = threading.Thread(target=loop.drain)
        drainer.start()
        gate.set()
        drainer.join(5.0)
        assert not drainer.is_alive(), "drain() hung"
        for j in jobs:
            j.put(None)
        for t in threads:
            t.join(5.0)
        assert outs == [[101, 1], [102, 2]]
        with pytest.raises(CacheError):
            loop.submit(_block([3]))  # post-drain submits are refused
        loop.close()

    def test_close_with_inflight(self):
        gate = threading.Event()
        loop = DispatchLoop(
            lambda blocks: [np.array(b[2]) for b in blocks],
            lambda token: (gate.wait(5.0), np.concatenate(token))[1],
        )
        out = []
        t = threading.Thread(target=lambda: out.append(loop.submit(_block([5]))))
        t.start()
        time.sleep(0.05)
        closer = threading.Thread(target=loop.close)
        closer.start()
        gate.set()
        closer.join(5.0)
        assert not closer.is_alive(), "close() deadlocked"
        t.join(5.0)
        assert out and out[0].tolist() == [5]

    def test_launch_error_fails_only_that_batch(self):
        calls = []

        def launch(blocks):
            calls.append(len(blocks))
            if len(calls) == 1:
                raise CacheError("device on fire")
            return [np.array(b[2]) for b in blocks]

        loop = DispatchLoop(launch, lambda token: np.concatenate(token))
        try:
            with pytest.raises(CacheError, match="device on fire"):
                loop.submit(_block([1]))
            assert loop.submit(_block([2])).tolist() == [2]
        finally:
            loop.close()

    def test_redeem_error_propagates(self):
        def collect(token):
            raise RuntimeError("readback failed")

        loop = DispatchLoop(lambda blocks: [np.array(b[2]) for b in blocks], collect)
        try:
            with pytest.raises(RuntimeError, match="readback failed"):
                loop.submit(_block([1]))
        finally:
            loop.close()

    def test_expired_ticket_dropped_at_take_before_packing(self):
        gate = threading.Event()
        launched_rows = []

        def launch(blocks):
            launched_rows.extend(int(b[2][0]) for b in blocks)
            return [np.array(b[2]) for b in blocks]

        def collect(token):
            gate.wait(5.0)
            return np.concatenate(token)

        loop = DispatchLoop(launch, collect)
        errors = []
        t1 = threading.Thread(target=lambda: loop.submit(_block([1])))
        t1.start()
        assert _wait_for(lambda: launched_rows)

        def expiring():
            with deadline_scope(0.05):
                try:
                    loop.submit(_block([99]))
                except DeadlineExceededError as e:
                    errors.append(e)

        t2 = threading.Thread(target=expiring)
        t2.start()
        time.sleep(0.15)  # the deadline lapses while parked in the ring
        gate.set()
        t1.join(5.0)
        t2.join(5.0)
        loop.close()
        assert len(errors) == 1
        assert 99 not in launched_rows
        assert loop.deadline_drops == 1

    def test_max_queue_sheds_with_queue_full(self):
        gate = threading.Event()
        loop = DispatchLoop(
            lambda blocks: [np.array(b[2]) for b in blocks],
            lambda token: (gate.wait(5.0), np.concatenate(token))[1],
            max_queue=2,
        )
        t1 = threading.Thread(target=lambda: loop.submit(_block([1])))
        t1.start()
        time.sleep(0.05)  # batch 1 launched, readback gated
        stalled = []
        t2 = threading.Thread(target=lambda: stalled.append(loop.submit(_block([2, 3]))))
        t2.start()
        assert _wait_for(lambda: loop.queue_depth >= 2)
        with pytest.raises(QueueFullError):
            loop.submit(_block([4]))
        gate.set()
        t1.join(5.0)
        t2.join(5.0)
        loop.close()
        assert stalled and stalled[0].tolist() == [2, 3]

    def test_brownout_sheds_on_submit(self):
        controller = AdmissionController(brownout_target_ms=1.0, ewma_alpha=1.0)
        loop = _echo_loop(overload=controller)
        try:
            assert loop.submit(_block([1])).tolist() == [1]
            controller.observe_queue_wait(50.0)  # force the brownout
            assert controller.should_shed()
            with pytest.raises(BrownoutError):
                loop.submit(_block([2]))
        finally:
            loop.close()

    def test_dispatch_launch_fault_site(self):
        injector = FaultInjector.from_spec(f"{FAULT_SITE_LAUNCH}:error:1")
        loop = _echo_loop(fault_injector=injector)
        try:
            with pytest.raises(CacheError, match="dispatch.launch"):
                loop.submit(_block([1]))
            assert injector.fired()[f"{FAULT_SITE_LAUNCH}:error"] >= 1
            injector.clear()
            assert loop.submit(_block([2])).tolist() == [2]
        finally:
            loop.close()

    def test_stalled_owner_grows_queue_wait_signal(self):
        """dispatch.launch:delay_ms models a stalled device owner: the ring
        wait observed by the admission controller grows past the brownout
        target and the loop starts shedding."""
        controller = AdmissionController(brownout_target_ms=5.0, ewma_alpha=1.0)
        injector = FaultInjector.from_spec(f"{FAULT_SITE_LAUNCH}:delay_ms:40")
        loop = _echo_loop(overload=controller, fault_injector=injector)

        def submit_quietly():
            try:
                loop.submit(_block([1]))
            except BrownoutError:
                pass

        try:
            deadline = time.monotonic() + 10.0
            while not controller.brownout and time.monotonic() < deadline:
                threads = [threading.Thread(target=submit_quietly) for _ in range(3)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(5.0)
            assert controller.brownout
        finally:
            loop.close()

    def test_stats_reach_the_store(self):
        store = Store()
        loop = _echo_loop(scope=store.scope("ratelimit"))
        try:
            for i in range(3):
                loop.submit(_block([i, i]))
        finally:
            loop.close()
        snap = store.debug_snapshot()
        assert snap["ratelimit.dispatch.batch_size.count"] == 3
        assert snap["ratelimit.dispatch.launch_ms.count"] == 3
        assert snap["ratelimit.dispatch.redeem_ms.count"] == 3
        assert snap["ratelimit.dispatch.ring_wait_ms.count"] == 3
        assert snap["ratelimit.dispatch.queue_depth"] == 0
        assert snap["ratelimit.dispatch.ring.arena_hwm"] >= 2


# -- the windowed engine ------------------------------------------------------


def _engine(dispatch_loop, clock=None, **kwargs):
    kwargs.setdefault("n_slots", 1 << 12)
    return SlabDeviceEngine(
        clock or FakeTimeSource(700_000),
        device="cpu",
        batch_window_seconds=0.002,
        buckets=(8, 128),
        max_batch=128,
        dispatch_loop=dispatch_loop,
        **kwargs,
    )


def _one_key_block(fp, limit):
    block = np.zeros((6, 1), dtype=np.uint32)
    block[0] = fp
    block[2] = 1
    block[3] = limit
    block[4] = 60
    return block


class TestEngineParity:
    """Row-block results are byte-identical between the dispatch-loop and
    leader-collects arms, and both answer saturation and shed alike."""

    def test_row_block_results_byte_identical_across_arms(self):
        rng = random.Random(3)
        eng_loop = _engine(True)
        eng_lead = _engine(False)
        assert eng_loop.dispatch_loop is not None and eng_lead.dispatch_loop is None
        try:
            for step in range(40):
                n = rng.randrange(1, 9)
                block = np.zeros((6, n), dtype=np.uint32)
                block[0] = [rng.randrange(1, 64) for _ in range(n)]
                block[2] = 1
                block[3] = rng.randrange(2, 30)
                block[4] = 60
                a = eng_loop.submit_rows(np.array(block))
                b = eng_lead.submit_rows(np.array(block))
                assert a.dtype == b.dtype == np.uint32
                assert a.tobytes() == b.tobytes(), step
        finally:
            eng_loop.close()
            eng_lead.close()

    def test_windowed_engine_rides_loop_and_coalesces(self):
        eng = _engine(True)
        try:
            outs = []
            lock = threading.Lock()

            def worker():
                r = eng.submit_rows(_one_key_block(4242, 1_000_000))
                with lock:
                    outs.append(int(r[0]))

            threads = [threading.Thread(target=worker) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(5.0)
            assert sorted(outs) == [1, 2, 3, 4, 5, 6]
            assert eng.health_snapshot()["decisions"] == 6
            assert eng.dispatch_loop.launches == len(eng.launch_sizes) <= 6
            assert sum(eng.launch_sizes) == 6
        finally:
            eng.close()

    def test_engine_drain_with_loop(self):
        eng = _engine(True)
        block = _one_key_block(9, 100)
        assert eng.submit_rows(block).tolist() == [1]
        eng.drain()
        with pytest.raises(CacheError):
            eng.submit_rows(np.array(block))
        eng.close()

    def test_full_occupancy_parity(self):
        """Past 100% live occupancy both arms keep answering (the set scan
        evicts in-kernel), byte-identically across arms."""
        outs = {}
        for arm in (True, False):
            eng = SlabDeviceEngine(
                FakeTimeSource(700_000), n_slots=128, device="cpu",
                batch_window_seconds=0.002, buckets=(8,), max_batch=8, dispatch_loop=arm,
            )
            got = []
            try:
                # 160 distinct keys over 32 four-way sets: the tail 32
                # inserts each evict a live way instead of shedding
                for i in range(160):
                    got.append(eng.submit_rows(_one_key_block(i + 1, 1000)).tobytes())
                snap = eng.health_snapshot()
                assert snap["occupancy"] == 1.0
                assert snap["evictions_live"] == 32
            finally:
                eng.close()
            outs[arm] = got
        assert outs[True] == outs[False]

    def test_launch_failure_raises_cache_error_in_every_arm(self, monkeypatch):
        """No fallback: a failed launch surfaces as CacheError to the
        caller, whichever arm carries it, and the next submit still runs."""
        for arm in (True, False, None):
            eng = _engine(arm) if arm is not None else SlabDeviceEngine(FakeTimeSource(1), n_slots=1 << 10, device="cpu")
            real = cuda_mod.slab_step_after
            calls = []

            def failing(*a, _real=real, **kw):
                calls.append(1)
                if len(calls) == 1:
                    raise RuntimeError("kernel launch failed: cudaError_t 98")
                return _real(*a, **kw)

            monkeypatch.setattr(cuda_mod, "slab_step_after", failing)
            try:
                with pytest.raises(CacheError, match="cuda backend failure"):
                    eng.submit_rows(_one_key_block(5, 10))
                assert eng.submit_rows(_one_key_block(5, 10)).tolist() == [1]
            finally:
                monkeypatch.setattr(cuda_mod, "slab_step_after", real)
                eng.close()

    def test_engine_stats_and_precompile(self):
        store = Store()
        eng = _engine(True, scope=store.scope("ratelimit"), precompile=True, hotkey_lanes=16)
        try:
            assert set(eng.precompiled) == {(b, w) for b in (8, 128) for w in ("uint8", "uint16", "uint32")}
            # the warm-up launches leave the slab, the sketch and the
            # counters untouched and record nothing
            assert not eng.export_tables()[0].any()
            assert not eng.export_sketch().any()
            assert eng.health_snapshot()["decisions"] == 0 and not eng.launch_sizes
            assert "ratelimit.device.launch_ms" not in store.debug_snapshot()
            eng.submit_rows(_one_key_block(3, 10))
        finally:
            eng.close()
        snap = store.debug_snapshot()
        for name in ("device.pack_ms", "device.launch_ms", "device.readback_ms", "dispatch.batch_size"):
            assert snap[f"ratelimit.{name}.count"] == 1, name
        assert snap["ratelimit.batcher.queue_depth"] == 0


def test_operand_buffer_waits_for_its_last_launch_before_repacking(monkeypatch):
    """The pooled operand's upload is non-blocking on the card, so a buffer
    may be repacked only after the launch that last read it has finished.
    Fake fences that pass only when synchronized: three launches at one
    bucket (two in flight, then a third on the first one's buffer). The
    third must wait on the first launch's fence while the buffer still
    holds the first launch's rows; packing first would have overwritten
    them (a premature reuse), which the snapshot would show."""
    eng = SlabDeviceEngine(FakeTimeSource(1000), n_slots=1 << 10, buckets=(8,), device="cpu")
    seen = []

    class Fence:
        def __init__(self):
            self.done = False

        def record(self):
            pass

        def query(self):
            return self.done

        def synchronize(self):
            pair = eng._operand_pool[8]
            seen.append((self, [op.array[:6, :3].copy() for op in pair[:2]]))
            self.done = True

    monkeypatch.setattr(eng, "_new_fence", Fence)
    blocks = []
    for k in range(3):
        block = np.zeros((6, 3), np.uint32)
        block[0] = [10 * k + 1, 10 * k + 2, 10 * k + 3]
        block[2] = 1
        block[3] = 100
        block[4] = 60
        blocks.append(block)
    tok_a = eng._execute_blocks_launch([blocks[0]])
    tok_b = eng._execute_blocks_launch([blocks[1]])
    fence_a, fence_b = tok_a[0].fence, tok_b[0].fence
    assert not eng._launch_ready(tok_a) and not eng._launch_ready(tok_b)
    assert seen == []  # two launches in flight: no wait yet
    tok_c = eng._execute_blocks_launch([blocks[2]])
    assert len(seen) == 1 and seen[0][0] is fence_a
    # at the wait, buffer 0 still held launch A's rows
    assert np.array_equal(seen[0][1][0], blocks[0])
    assert not fence_b.done
    # each collect waits on its own fence, then reads its own counters
    for tok in (tok_c, tok_b, tok_a):
        assert eng._execute_blocks_collect(tok).tolist() == [1, 1, 1]
    assert fence_b.done and tok_c[0].fence.done
    eng.close()


def test_tensor_operand_matches_numpy_and_is_validated():
    """slab_step_after takes the engine's pooled host tensor as it takes
    the numpy operand (same counters, same table); a tensor of the wrong
    shape, dtype or device is refused."""
    from api_ratelimit_tpu_torch.ops import slab as S

    rng = np.random.default_rng(2)
    packed = np.zeros((7, 16), np.uint32)
    packed[0] = rng.integers(1, 40, 16)
    packed[2] = 1
    packed[3] = 5
    packed[4] = 60
    packed[6, 0] = 1000
    a, b = S.make_slab(256, "cpu"), S.make_slab(256, "cpu")
    want, _ = S.slab_step_after(a, packed, ways=4)
    got, _ = S.slab_step_after(b, torch.from_numpy(packed.view(np.int32).copy()), ways=4)
    assert torch.equal(got, want) and torch.equal(a.table, b.table)
    for bad in (torch.zeros((6, 16), dtype=torch.int32), torch.zeros((7, 16), dtype=torch.int64),
                torch.zeros((7, 16), dtype=torch.int32).t().contiguous().t()):
        with pytest.raises(ValueError, match="tensor operand"):
            S.slab_step_after(b, bad, ways=4)


# -- tests/test_overload.py TestDispatchLoopOverloadParity ---------------------


@pytest.mark.parametrize("arm", [True, False])
def test_expired_dropped_at_take_before_packing(arm):
    store = Store()
    eng = _engine(arm, scope=store.scope("ratelimit"))
    block = _one_key_block(42, 10)
    try:
        with deadline_scope(-0.001):
            with pytest.raises(DeadlineExceededError):
                eng.submit_rows(np.array(block))
        # dropped BEFORE packing: the device never saw a decision
        assert eng.health_snapshot()["decisions"] == 0
        drops = eng.dispatch_loop.deadline_drops if arm else eng.batcher.deadline_drops
        assert drops == 1
        assert eng.submit_rows(np.array(block)).tolist() == [1]
    finally:
        eng.close()


@pytest.mark.parametrize("arm", [True, False])
def test_queue_full_fault_sheds_identically(arm):
    """queue_full injected at the SHARED batcher.submit site: both arms
    shed the submit with QueueFullError before any device work."""
    injector = FaultInjector.from_spec("batcher.submit:queue_full:1")
    eng = _engine(arm, fault_injector=injector)
    try:
        with pytest.raises(QueueFullError, match="injected"):
            eng.submit_rows(_one_key_block(7, 10))
        assert injector.fired() == {"batcher.submit:queue_full": 1}
        assert eng.health_snapshot()["decisions"] == 0
    finally:
        eng.close()


@pytest.mark.parametrize("arm", [True, False])
def test_brownout_sheds_identically(arm):
    controller = AdmissionController(brownout_target_ms=1.0, ewma_alpha=1.0, scope=Store().scope("ratelimit"))
    eng = _engine(arm, overload=controller)
    block = _one_key_block(7, 10)
    try:
        assert eng.submit_rows(np.array(block)).tolist() == [1]
        for _ in range(8):
            controller.observe_queue_wait(1e6)
        with pytest.raises(BrownoutError):
            eng.submit_rows(np.array(block))
    finally:
        eng.close()


# -- the port against the JAX windowed engine ---------------------------------


@pytest.mark.parametrize("arm", [True, False])
def test_windowed_engine_matches_the_jax_windowed_engine(arm):
    """One clock, one serial 40-step stream (blocks of 1-20 items across
    the 8/128 buckets, duplicate keys, 1-3 hits, the clock crossing window
    edges) through the JAX SlabDeviceEngine(use_pallas=False) and the
    port's engine, both windowed in the same arm: identical per-submit
    result bytes and final export_tables() bytes."""
    clock = JaxClock(700_000)
    kw = dict(n_slots=1 << 12, batch_window_seconds=0.002, buckets=(8, 128), max_batch=128, dispatch_loop=arm)
    ref = JaxEngine(clock, use_pallas=False, **kw)
    port = SlabDeviceEngine(clock, device="cpu", **kw)
    assert (ref.dispatch_loop is None) == (port.dispatch_loop is None) == (not arm)
    rng = np.random.default_rng(17)
    try:
        for step in range(40):
            if step % 9 == 8:
                clock.advance(int(rng.choice([1, 59, 61])))
            n = int(rng.integers(1, 21))
            block = np.zeros((6, n), dtype=np.uint32)
            block[0] = rng.integers(1, 48, n)
            block[1] = block[0] * 7
            block[2] = rng.integers(1, 4, n)
            block[3] = rng.choice([2, 5, 300, 70000], n)
            block[4] = rng.choice([1, 60, 3600], n)
            block[5] = rng.integers(0, 5, n)
            want = ref.submit_rows(np.array(block))
            got = port.submit_rows(np.array(block))
            assert got.dtype == want.dtype == np.uint32
            assert got.tobytes() == want.tobytes(), step
        table = port.export_tables()[0]
        assert table.tobytes() == np.asarray(ref.export_tables()[0]).tobytes()
        assert table.any()
        assert port.health_snapshot()["decisions"] == ref.health_snapshot()["decisions"]
    finally:
        ref.close()
        port.close()


# -- the owner's cycle in spans and histograms ---------------------------------

# the children the owner records under each dispatch.batch (backends/
# dispatch.py); every launch has the second set
OWNER_SPANS = frozenset({
    "dispatch.wait", "dispatch.linger", "dispatch.take", "dispatch.scatter", "dispatch.turn",
    "engine.operand_wait", "engine.pack", "engine.promote", "engine.step_enqueue",
    "engine.readback_enqueue", "engine.fence_wait", "engine.copy",
})
EVERY_LAUNCH = frozenset({
    "dispatch.take", "engine.pack", "engine.step_enqueue", "engine.readback_enqueue",
    "engine.fence_wait", "engine.copy", "dispatch.scatter", "dispatch.turn",
})
NOW_OWNER = 1_000


def _owner_engine(store=None):
    """A windowed CPU engine whose takes of 4 frontends x 100 rows run
    past the 256-row bucket (two device launches) or fit one."""
    return SlabDeviceEngine(
        FakeTimeSource(NOW_OWNER), n_slots=1 << 12, ways=4, buckets=(64, 256), device="cpu",
        batch_window_seconds=0.0005, max_batch=256,
        scope=store.scope("ratelimit") if store is not None else None,
    )


def _frontends(engine, threads=4, blocks=12, rows=100, hold=None):
    """`threads` closed-loop submitters of `blocks` row blocks each; `hold`
    (an Event) keeps them going until it is set."""

    def run(i):
        rng = np.random.default_rng(i)
        k = 0
        while k < blocks or (hold is not None and not hold.is_set()):
            n = rows if k % 3 else rows // 4
            block = np.zeros((6, n), dtype=np.uint32)
            block[0] = rng.integers(1, 4000, n)
            block[2] = 1
            block[3] = 100
            block[4] = 60
            engine.submit_rows(block)
            k += 1

    ts = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    return ts


class TestOwnerCycleSpans:
    def test_every_launch_records_one_batch_span_with_its_children(self):
        from api_ratelimit_tpu_torch import tracing

        tracer = tracing.RecordingTracer(1 << 16, keep_unsampled=True)
        tracing.set_global_tracer(tracer)
        eng = _owner_engine()
        try:
            for t in _frontends(eng):
                t.join(30)
        finally:
            eng.close()
            tracing.reset_global_tracer()
        spans = tracer.finished_spans()
        batches = [s for s in spans if s.operation_name == "dispatch.batch"]
        assert len(batches) == eng.dispatch_loop.launches > 0
        children: dict = {}
        for s in spans:
            if s.operation_name != "dispatch.batch":
                assert s.operation_name in OWNER_SPANS
                children.setdefault(s.parent_id, []).append(s)
        eps = 2e-6  # the epoch floats' rounding
        launches = 0
        for b in batches:
            # no frontend carried a request span: the owner's own record,
            # unsampled, and so are its children
            assert b.links == [] and not b.context.sampled
            kids = children[b.context.span_id]
            names = [k.operation_name for k in kids]
            assert EVERY_LAUNCH <= set(names), names
            rows = b.tags["chunk_rows"]
            assert b.tags["device_launches"] == len(rows) == names.count("engine.step_enqueue")
            assert names.count("engine.readback_enqueue") == names.count("engine.fence_wait") == len(rows)
            assert sum(rows) == b.tags["batch_items"] and all(0 < n <= 256 for n in rows)
            assert b.tags["clock_now"] == NOW_OWNER and b.tags["owner_cpu_us"] > 0
            (pack,) = [k for k in kids if k.operation_name == "engine.pack"]
            assert pack.tags["fresh_operands"] == (len(rows) if len(rows) > 1 else 0)
            assert ("engine.operand_wait" in names) == (len(rows) == 1)
            for k in kids:
                assert b.start_time - eps <= k.start_time
                assert k.start_time + k.duration <= b.start_time + b.duration + eps
            launches += len(rows)
        assert launches > len(batches)  # some takes ran past the bucket
        # one owner thread: its children never overlap, whatever their batch
        kids = sorted((s for s in spans if s.operation_name != "dispatch.batch"), key=lambda s: s.start_time)
        for a, b in zip(kids, kids[1:]):
            assert a.start_time + a.duration <= b.start_time + 2 * eps, (a.operation_name, b.operation_name)

    def test_tracer_off_builds_no_span_nor_stamp_list_on_the_owner(self, monkeypatch):
        from api_ratelimit_tpu_torch.backends import dispatch as dispatch_mod
        from api_ratelimit_tpu_torch.tracing import tracer as tracer_mod

        built = []
        span_init = tracer_mod.Span.__init__
        stamps_init = dispatch_mod._PreStamps.__init__

        def note(init):
            def wrapped(self, *a, **kw):
                built.append((type(self).__name__, threading.current_thread().name))
                init(self, *a, **kw)
            return wrapped

        monkeypatch.setattr(tracer_mod.Span, "__init__", note(span_init))
        monkeypatch.setattr(dispatch_mod._PreStamps, "__init__", note(stamps_init))
        tracer_mod.reset_global_tracer()  # the no-op tracer: off
        store = Store()
        eng = _owner_engine(store)
        try:
            for t in _frontends(eng):
                t.join(30)
        finally:
            eng.close()
        assert eng.dispatch_loop.launches > 0
        assert [b for b in built if b[1] == "cuda-dispatch-owner"] == []
        # the histograms are always on
        snap = store.debug_snapshot()
        assert snap["ratelimit.device.step_enqueue_ms.count"] >= eng.dispatch_loop.launches

    def test_cycle_offcpu_wake_and_step_enqueue_histograms(self):
        store = Store()
        eng = _owner_engine(store)
        try:
            for t in _frontends(eng, threads=2, blocks=10):
                t.join(30)
        finally:
            eng.close()
        h = store.metrics_snapshot()["histograms"]
        launches = eng.dispatch_loop.launches
        # one device launch a chunk, one cycle between two takes, one wake
        # an in-process frame
        assert h["ratelimit.device.step_enqueue_ms"]["count"] == len(eng.launch_sizes) >= launches
        assert h["ratelimit.dispatch.cycle_ms"]["count"] == launches - 1
        assert h["ratelimit.dispatch.offcpu_ms"]["count"] == launches - 1
        assert h["ratelimit.dispatch.offcpu_ms"]["sum"] <= h["ratelimit.dispatch.cycle_ms"]["sum"]
        assert h["ratelimit.dispatch.wake_ms"]["count"] == 20
        assert h["ratelimit.device.step_enqueue_ms"]["sum"] <= h["ratelimit.device.launch_ms"]["sum"]

    def test_offcpu_sums_exactly_on_a_coarse_cpu_clock(self, monkeypatch):
        """A thread CPU clock that advances in 10 ms ticks reads each
        ~7 ms cycle's CPU as 0 or 10 ms: every cycle records a gain of 0
        or more, and the sum is the owner's wall less CPU time to a tick."""
        store = Store()
        loop = _echo_loop(scope=store.scope("ratelimit"))
        loop.close()
        tick = 10_000_000
        wall = [0]
        cpu_true = [0]

        def monotonic_ns():
            return wall[0]

        def thread_time_ns():
            return cpu_true[0] // tick * tick

        monkeypatch.setattr(time, "monotonic_ns", monotonic_ns)
        monkeypatch.setattr(time, "thread_time_ns", thread_time_ns)
        for _ in range(200):
            wall[0] += 7_000_000
            cpu_true[0] += 5_000_000  # 2 ms of each cycle off the CPU
            loop._note_cycle()
        monkeypatch.undo()
        h = store.metrics_snapshot()["histograms"]
        off, cycle = h["ratelimit.dispatch.offcpu_ms"], h["ratelimit.dispatch.cycle_ms"]
        assert off["count"] == cycle["count"] == 199
        assert cycle["sum"] == pytest.approx(199 * 7.0)
        assert abs(off["sum"] - 199 * 2.0) <= tick / 1e6
        assert off["counts"][0] > 0  # cycles whose tick landed read 0, never below

    def test_unlinked_launches_stay_out_of_a_sampling_tracer(self):
        """An operator's tracer (sampled spans only) keeps none of the
        owner's unlinked cycles, so they never push request spans out of
        its ring; a linked launch's batch span it keeps, as the reference
        does."""
        from api_ratelimit_tpu_torch import tracing

        tracer = tracing.RecordingTracer(1 << 12)
        tracing.set_global_tracer(tracer)
        eng = _owner_engine()
        try:
            for t in _frontends(eng, threads=2, blocks=4):
                t.join(30)
            assert tracer.finished_spans() == []
            with tracer.start_span("request") as span, tracing.activate(span):
                eng.submit_rows(np.array([[7], [0], [1], [100], [60], [0]], dtype=np.uint32))
        finally:
            eng.close()
            tracing.reset_global_tracer()
        names = [s.operation_name for s in tracer.finished_spans()]
        assert names.count("dispatch.batch") == 1 and "request" in names
        assert "dispatch.turn" in names and "engine.step_enqueue" in names

    def test_offcpu_leaves_out_the_owners_parking(self):
        """Frontends that pause between blocks leave the owner parked on its
        work event most of each cycle: that parking is not off-CPU time."""
        store = Store()
        eng = _owner_engine(store)

        def run():
            for i in range(12):
                eng.submit_rows(np.array([[i + 1], [0], [1], [100], [60], [0]], dtype=np.uint32))
                time.sleep(0.03)

        t = threading.Thread(target=run)
        t.start()
        t.join(30)
        eng.close()
        h = store.metrics_snapshot()["histograms"]
        cycle, off = h["ratelimit.dispatch.cycle_ms"], h["ratelimit.dispatch.offcpu_ms"]
        assert cycle["count"] == 11 and cycle["sum"] >= 11 * 30.0
        assert off["sum"] < 0.3 * cycle["sum"], (off["sum"], cycle["sum"])
