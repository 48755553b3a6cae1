"""Port of api_ratelimit_tpu/tracing/journeys.py (unchanged semantics): the
tail-sampled flight recorder of per-request journeys through the pipeline.

Aggregate histograms (stats/store.py) say the p99 is slow; head-sampled
spans say what a RANDOM request did. Neither answers the on-call question
"where did *this slow request* spend its time" — by the time a request is
known to be interesting (slow, shed, deadline-expired, faulted, OVER_LIMIT)
a head sampler has already decided not to keep it. This module records
every request's stage timestamps unconditionally into lock-free per-thread
rings, then TAIL-samples: when a journey finishes, the outcome decides
whether it is promoted into a bounded retained buffer.

A journey is the request's itinerary through the dispatch pipeline, as
monotonic-ns stage timestamps:

    publish   frame published into the submit ring (or batcher queue)
    take      owner/dispatcher thread took the frame out of the ring
    pack      frame gather into the padded launch operand began
    launch    async device dispatch returned
    redeem    blocking readback completed
    scatter   verdicts scattered into the caller's ticket buffer

The frontend half (publish) is recorded on the request thread; the owner
half (take..scatter) rides the dispatch ticket across the thread hop and
is merged after redemption, so a journey survives the thread hop of the
windowed arms. Every arm (direct mode, the dispatch loop, leader-collects)
marks the same stage set, pinned by test.

Promotion flags: `slow` (duration over JOURNEY_SLOW_MS, or over the live
p99 estimate when the knob is 0), `shed`, `deadline`, `fault`,
`over_limit`. Retained journeys are exported at GET /debug/journeys on the
debug port and dumped to stderr on SIGUSR2 (runner.py).

Cost model: recorder OFF (no global recorder registered — the default for
library use; the runner registers one per JOURNEY_RECORDER_ENABLED) is one
None-check per instrumentation site and allocates nothing. Recorder ON
appends to a per-thread deque (no lock) and takes the recorder lock only
to promote a tail journey or to fold a duration sample into the live-p99
window — both O(1).
"""

from __future__ import annotations

import collections
import json
import threading
import time

# canonical stage order (the dispatch-arm parity test pins the set)
STAGES = ("publish", "take", "pack", "launch", "redeem", "scatter")
# the owner-thread half of the itinerary, as carried by dispatch tickets
OWNER_STAGES = ("take", "pack", "launch", "redeem", "scatter")
# requests answered on the host from a leased budget slice
# (backends/lease.py) mark this single stage instead of the device set:
# /debug/journeys shows which requests never reached the card
STAGE_LEASE_LOCAL = "lease_local"
# per-algorithm decision tags (backends/cuda.py ALGO_JOURNEY_STAGES marks
# one on every over-limit decision): a slow or shed journey shows which
# decision kernel — fixed/sliding window, GCRA, concurrency — denied it
ALGO_STAGES = (
    "algo_fixed_window",
    "algo_sliding_window",
    "algo_gcra",
    "algo_concurrency",
)

FLAG_SLOW = "slow"
FLAG_SHED = "shed"
FLAG_DEADLINE = "deadline"
FLAG_FAULT = "fault"
FLAG_OVER_LIMIT = "over_limit"
# the request rode a device-owner failover: the sidecar client switched
# to a standby address (backends/sidecar.py), or this request's write
# promoted a standby (persist/replication.py) — always tail-worthy
FLAG_FAILOVER = "failover"
# a descriptor in this request was ranked hot by the heavy-hitter sketch's
# last drain (backends/cuda.py drain_hotkeys): "slow AND hot" is the gold
# tail-sample — contention on the hot head, not a cold-path stall
FLAG_HOTKEY = "hotkey"
# a descriptor in this request was served from a federation quota share
# (cluster/federation.py consume_for_fallback): the cluster answered from
# budget another cluster's home pre-committed, or from its own home
# budget, while the card failed — relaxed-consistency traffic worth
# spotting in the tail
FLAG_FED = "fed"


class Journey:
    """One request's recorded itinerary. Mutated only by its owning
    request thread (owner-thread stages arrive via merge_owner AFTER the
    ticket hand-off, still on the request thread)."""

    __slots__ = (
        "kind",
        "trace_id",
        "span_id",
        "start_ns",
        "wall_start",
        "stages",
        "flags",
        "duration_ms",
        "thread",
    )

    def __init__(self, kind: str, trace_id: int = 0, span_id: int = 0):
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = span_id
        self.start_ns = time.monotonic_ns()
        self.wall_start = time.time()
        self.stages: dict[str, int] = {}
        self.flags: tuple = ()
        self.duration_ms = 0.0
        self.thread = threading.current_thread().name

    def mark(self, stage: str, t_ns: int | None = None) -> None:
        self.stages[stage] = time.monotonic_ns() if t_ns is None else t_ns

    def merge_owner(self, stage_ns) -> None:
        """Fold the owner thread's (take, pack, launch, redeem, scatter)
        timestamp tuple — carried across the thread hop by the dispatch
        ticket — into this journey."""
        if stage_ns is None:
            return
        stages = self.stages
        for name, ns in zip(OWNER_STAGES, stage_ns):
            stages[name] = ns

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "trace_id": f"{self.trace_id:032x}" if self.trace_id else "",
            "span_id": f"{self.span_id:016x}" if self.span_id else "",
            "wall_start": self.wall_start,
            "start_ns": self.start_ns,
            "stages": dict(self.stages),
            "flags": list(self.flags),
            "duration_ms": round(self.duration_ms, 4),
            "thread": self.thread,
        }


class JourneyRecorder:
    """Per-thread recent rings + the tail-sampled retained buffer."""

    # recompute the live p99 estimate every N finishes, over the last
    # _P99_WINDOW durations — cheap, and plenty for a promotion threshold
    _P99_EVERY = 128
    _P99_WINDOW = 1024
    _P99_MIN_SAMPLES = 64

    def __init__(
        self,
        slow_ms: float = 0.0,
        retain: int = 256,
        ring: int = 64,
        scope=None,
    ):
        """slow_ms: promote journeys slower than this; 0 tracks the live
        p99 estimate instead. retain: bound of the promoted tail buffer.
        ring: per-thread recent-journey ring size. scope: optional stats
        Scope — registers the ratelimit.journeys.* family."""
        if retain <= 0 or ring <= 0:
            raise ValueError(
                f"journey buffers must be positive (retain={retain}, "
                f"ring={ring})"
            )
        if slow_ms < 0:
            raise ValueError(f"JOURNEY_SLOW_MS must be >= 0, got {slow_ms}")
        self.slow_ms = float(slow_ms)
        self._ring = int(ring)
        self._tls = threading.local()
        self._lock = threading.Lock()
        # thread name -> recent deque (appends are thread-local and
        # lock-free; the lock guards only registration and snapshots)
        self._recent: dict[str, collections.deque] = {}
        self._retained: collections.deque = collections.deque(maxlen=retain)
        self._durations: collections.deque = collections.deque(
            maxlen=self._P99_WINDOW
        )
        self._since_p99 = 0
        self._p99_ms = float("inf")
        self._c_recorded = self._c_retained = self._g_depth = None
        if scope is not None:
            self._c_recorded = scope.counter("recorded")
            self._c_retained = scope.counter("retained")
            self._g_depth = scope.gauge("retained_depth")

    # -- request-thread API --

    def begin(
        self, kind: str = "request", trace_id: int = 0, span_id: int = 0
    ) -> Journey:
        journey = Journey(kind, trace_id=trace_id, span_id=span_id)
        self._tls.current = journey
        return journey

    def current(self) -> Journey | None:
        return getattr(self._tls, "current", None)

    def finish(self, journey: Journey, duration_ms: float, flags=()) -> bool:
        """Close a journey with its outcome; returns True when the tail
        sampler promoted it into the retained buffer."""
        if getattr(self._tls, "current", None) is journey:
            self._tls.current = None
        journey.duration_ms = float(duration_ms)
        flags = list(flags)
        # flags noted mid-flight (note_flag — e.g. an allow/deny-posture
        # shed that answers without raising) merge with the outcome's
        for noted in journey.flags:
            if noted not in flags:
                flags.append(noted)
        recent = getattr(self._tls, "recent", None)
        if recent is None:
            recent = self._tls.recent = collections.deque(maxlen=self._ring)
            with self._lock:
                self._recent[threading.current_thread().name] = recent
        with self._lock:
            self._durations.append(journey.duration_ms)
            self._since_p99 += 1
            if self._since_p99 >= self._P99_EVERY:
                self._since_p99 = 0
                if len(self._durations) >= self._P99_MIN_SAMPLES:
                    ordered = sorted(self._durations)
                    self._p99_ms = ordered[
                        min(len(ordered) - 1, int(len(ordered) * 0.99))
                    ]
        threshold = self.slow_ms if self.slow_ms > 0 else self._p99_ms
        if journey.duration_ms > threshold:
            flags.append(FLAG_SLOW)
        journey.flags = tuple(flags)
        recent.append(journey)
        if self._c_recorded is not None:
            self._c_recorded.inc()
        if not flags:
            return False
        with self._lock:
            self._retained.append(journey)
            depth = len(self._retained)
        if self._c_retained is not None:
            self._c_retained.inc()
        if self._g_depth is not None:
            self._g_depth.set(depth)
        return True

    # -- export --

    @property
    def live_p99_ms(self) -> float:
        return self._p99_ms

    def retained(self) -> list[Journey]:
        with self._lock:
            return list(self._retained)

    def snapshot(self) -> dict:
        with self._lock:
            retained = list(self._retained)
            recent = {
                name: list(ring) for name, ring in self._recent.items()
            }
        return {
            "enabled": True,
            "slow_ms": self.slow_ms,
            "live_p99_ms": (
                None if self._p99_ms == float("inf") else self._p99_ms
            ),
            "retained": [j.to_json() for j in retained],
            "recent": {
                name: [j.to_json() for j in ring]
                for name, ring in recent.items()
            },
        }

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2) + "\n"


_global_recorder: JourneyRecorder | None = None


def set_global_recorder(recorder: JourneyRecorder | None) -> None:
    global _global_recorder
    _global_recorder = recorder


def global_recorder() -> JourneyRecorder | None:
    return _global_recorder


def begin_request(
    kind: str = "request", trace_id: int = 0, span_id: int = 0
) -> Journey | None:
    """Start the current thread's journey; None when recording is off.
    The service boundary calls this (service/ratelimit.py) so every
    transport records the same itinerary."""
    recorder = _global_recorder
    if recorder is None:
        return None
    return recorder.begin(kind, trace_id=trace_id, span_id=span_id)


def mark(stage: str, t_ns: int | None = None) -> None:
    """Stamp a stage on the current thread's journey (no-op when off) —
    the one-line hook the batcher/dispatch hot paths call."""
    recorder = _global_recorder
    if recorder is None:
        return
    journey = recorder.current()
    if journey is not None:
        journey.mark(stage, t_ns)


def merge_owner_stages(stage_ns) -> None:
    """Fold a ticket's owner-thread stage tuple into the current journey
    (no-op when off)."""
    recorder = _global_recorder
    if recorder is None:
        return
    journey = recorder.current()
    if journey is not None:
        journey.merge_owner(stage_ns)


def note_flag(flag: str) -> None:
    """Attach a promotion flag to the current journey mid-flight (no-op
    when off) — for outcomes that never surface as exceptions, like an
    allow/deny-posture overload shed."""
    recorder = _global_recorder
    if recorder is None:
        return
    journey = recorder.current()
    if journey is not None and flag not in journey.flags:
        journey.flags = (*journey.flags, flag)


def recording() -> bool:
    """One-branch probe the owner/dispatcher threads use to decide whether
    to stamp stage timestamps at all."""
    return _global_recorder is not None
