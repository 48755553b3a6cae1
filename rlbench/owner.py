"""The system under test, and the control that stands in for it.

build_owner builds the device owner as cmd/sidecar_cmd.py's build_engine
does (the same settings parsed by the port's new_settings, the same
admission controller and empty fault injector, block mode), with two inputs
of the benchmark's own:

- the clock (the engine's time_source): the real clock, which notes the
  reading each launch takes;
- a launch log at the boundary between the dispatch loop and the engine:
  every call of the engine's block launcher records, in launch order, the
  pool blocks it packed, the clock reading it took and the rows of each
  device launch it made. That is what the reference replays: the coalescing
  and the clock are the two things the inputs do not fix.

ControlOwner is the reference itself put in the program's place, with its
in-launch serialization switched off (reference.py serialize=False). It
serves the same closed loop through the same launch log.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .reference import SlabReference, saturate


class LaunchClock:
    """The real clock in whole seconds; begin()/end() collect the readings a
    thread takes in between."""

    def __init__(self):
        self._tls = threading.local()

    def unix_now(self) -> int:
        now = int(time.time())
        readings = getattr(self._tls, "readings", None)
        if readings is not None:
            readings.append(now)
        return now

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def begin(self) -> None:
        self._tls.readings = []

    def end(self) -> list:
        readings, self._tls.readings = self._tls.readings, None
        return readings


class LaunchLog:
    """One entry a block-launcher call: (clock readings, pool block indices
    in pack order, rows of each device launch, host perf_counter at entry).
    A block is known by where its rows sit in the pool's memory."""

    def __init__(self, blocks: np.ndarray):
        self._base = blocks.__array_interface__["data"][0]
        self._stride = blocks.strides[0]
        self._n = blocks.shape[0]
        self.entries: list = []

    def index_of(self, block: np.ndarray) -> int:
        offset = block.__array_interface__["data"][0] - self._base
        index, rest = divmod(offset, self._stride)
        if rest or not 0 <= index < self._n:
            return -1  # not a pool block: the check counts it as a fault
        return index

    def record(self, t0: float, readings: list, blocks, chunk_rows) -> None:
        self.entries.append((readings, tuple(self.index_of(b) for b in blocks), tuple(chunk_rows), t0))


def build_owner(config: dict, clock: LaunchClock, log: LaunchLog, scope, device: str = "cuda"):
    """The device owner of `config`, built as the owner process builds it."""
    from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
    from api_ratelimit_tpu_torch.backends.overload import AdmissionController
    from api_ratelimit_tpu_torch.settings import new_settings
    from api_ratelimit_tpu_torch.testing.faults import FaultInjector

    settings = new_settings(dict(config["settings"]))

    class RecordedEngine(SlabDeviceEngine):
        def _execute_blocks_launch(self, blocks):
            t0 = time.perf_counter()
            clock.begin()
            try:
                tokens = super()._execute_blocks_launch(blocks)
            finally:
                readings = clock.end()
            log.record(t0, readings, blocks, [t.n for t in tokens])
            return tokens

    hk_enabled, hk_k, hk_lanes = settings.hotkey_config()
    v_enabled, v_max_rows, v_watermark = settings.victim_config()
    overload = AdmissionController(
        shed_mode=settings.shed_mode(),
        max_queue=settings.overload_max_queue,
        brownout_target_ms=settings.overload_brownout_target_ms,
        brownout_exit_ms=settings.overload_brownout_exit_ms,
        ewma_alpha=settings.overload_ewma_alpha,
        scope=scope,
    )
    kwargs = {"buckets": settings.buckets()} if settings.buckets() else {}
    return RecordedEngine(
        clock,
        n_slots=settings.tpu_slab_slots,
        ways=settings.slab_ways_count(),
        device=device,
        batch_window_seconds=settings.tpu_batch_window,
        max_batch=settings.tpu_batch_limit,
        dispatch_loop=settings.dispatch_loop,
        max_queue=settings.overload_max_queue,
        overload=overload,
        fault_injector=FaultInjector(settings.fault_rules(), seed=settings.fault_inject_seed),
        scope=scope,
        watermark_high=settings.slab_watermark(),
        gcra_burst_ratio=settings.gcra_burst(),
        block_mode=True,
        precompile=settings.tpu_precompile,
        hotkey_lanes=hk_lanes if hk_enabled else 0,
        hotkey_k=hk_k,
        victim_max_rows=v_max_rows if v_enabled else 0,
        victim_watermark=v_watermark,
        **kwargs,
    )


def slab_geometry(config: dict) -> tuple[int, int, float]:
    """(rows, ways, GCRA burst ratio) the configuration states."""
    s = config["settings"]
    return int(s["TPU_SLAB_SLOTS"]), int(s["SLAB_WAYS"]), float(s.get("GCRA_BURST_RATIO", "1.0"))


class ControlOwner:
    """The reference in the program's place, without serialization: one
    launch a submitted block, under a lock."""

    def __init__(self, config: dict, clock: LaunchClock, log: LaunchLog):
        n_slots, ways, burst = slab_geometry(config)
        self._ref = SlabReference(n_slots, ways, burst, serialize=False)
        self._clock = clock
        self._log = log
        self._lock = threading.Lock()

    def submit_block(self, block: np.ndarray) -> np.ndarray:
        with self._lock:
            t0 = time.perf_counter()
            self._clock.begin()
            now = self._clock.unix_now()
            readings = self._clock.end()
            after = self._ref.step(*block[:6], now)
            self._log.record(t0, readings, [block], [block.shape[1]])
        return saturate(after, block[3], block[2]).astype(np.uint32)

    def close(self) -> None:
        pass
