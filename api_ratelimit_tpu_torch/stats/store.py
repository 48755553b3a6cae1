"""Port of api_ratelimit_tpu/stats/store.py (unchanged semantics).

Statsd-style metrics pipeline.

A fresh implementation of the slice of lyft/gostats the reference uses
(SURVEY.md section 2.3): Store with scoped Counter/Gauge creation, periodic
flush to a sink, and StatGenerator hooks evaluated at flush time
(reference usage: src/server/server_impl.go:176-181,
src/limiter/local_cache_stats.go:20-43).

Counters flush deltas (statsd "|c"), gauges flush absolute values ("|g").
Stat objects are cached per name so repeated counter(name) calls return the
same instance — per-rule stats in the config tree rely on this across hot
reloads so counts survive a config swap.

Beyond the gostats slice, the hot path records into fixed-bucket Histograms
(log-spaced millisecond boundaries, one small lock per histogram, in-process
p50/p99 estimation) — the pull-model twin of the statsd timers: scraped via
the Prometheus renderer (stats/prometheus.py -> GET /metrics on the debug
port) instead of being shipped sample-by-sample. A request landing in the
top (overflow) bucket may attach its trace id as an exemplar, linking the
p99 tail straight to its span in /debug/traces.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Protocol

# Log-spaced (1-2.5-5 decades) millisecond boundaries covering 50us..2.5s —
# chosen so the 2ms north-star p99 sits mid-ladder with resolution on both
# sides. The overflow (+Inf) bucket is the exemplar-attaching "slow" bucket.
DEFAULT_LATENCY_BUCKETS_MS: tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)

# Power-of-two boundaries for size distributions (batch sizes, queue depths).
DEFAULT_SIZE_BUCKETS: tuple[float, ...] = tuple(
    float(1 << i) for i in range(0, 17)
)  # 1 .. 65536

# Sub-millisecond ladder for the host-path stage histograms (matcher /
# key-compose / response build): these stages run in single-digit
# microseconds, far below the request-latency ladder's 50us floor.
HOST_STAGE_BUCKETS_MS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

# Hot-path discipline note: every stat on the request path must be
# resolved to a handle ONCE (service/backend __init__, or rule-compile
# time for per-rule counters — config/compiled.py) — scope.counter()/
# histogram() take the store registry lock and build dotted names, which
# is flush-time work, never per-request work.


class Counter:
    """Monotonic counter. add/inc are thread-safe."""

    __slots__ = ("name", "_value", "_flushed", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._flushed = 0
        self._lock = threading.Lock()

    def inc(self) -> None:
        self.add(1)

    def add(self, delta: int) -> None:
        with self._lock:
            self._value += int(delta)

    def value(self) -> int:
        return self._value

    def latch_delta(self) -> int:
        """Value accumulated since the previous flush."""
        with self._lock:
            delta = self._value - self._flushed
            self._flushed = self._value
            return delta


class Gauge:
    """Instantaneous value. set/add/sub are thread-safe enough for stats."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def set(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    def add(self, delta: int) -> None:
        with self._lock:
            self._value += int(delta)

    def sub(self, delta: int) -> None:
        self.add(-delta)

    def value(self) -> int:
        return self._value


class Timer:
    """Millisecond timing observations, flushed individually ("|ms").

    The sample buffer is CAPPED: with no flush loop running (tests, tools,
    a misconfigured deploy) an uncapped list grows without bound at hot-path
    rates. Past the cap new samples are counted in `dropped()` instead of
    retained — the flush emits what it has, and the drop counter makes the
    loss visible rather than silent.
    """

    MAX_SAMPLES = 16384

    __slots__ = ("name", "_samples", "_count", "_sum", "_dropped", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._dropped = 0
        self._lock = threading.Lock()

    def add_value_ms(self, ms: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += ms
            if len(self._samples) >= self.MAX_SAMPLES:
                self._dropped += 1
                return
            self._samples.append(ms)

    def count(self) -> int:
        return self._count

    def dropped(self) -> int:
        """Samples discarded by the overflow cap (cumulative)."""
        return self._dropped

    def latch(self) -> list[float]:
        with self._lock:
            out = self._samples
            self._samples = []
            return out

    def summary(self) -> dict:
        """count/p50/p99 over the currently buffered (un-latched) samples,
        plus cumulative totals — the debug_snapshot view of a timer."""
        with self._lock:
            samples = sorted(self._samples)
            count, total, dropped = self._count, self._sum, self._dropped
        out = {"count": count, "sum_ms": total, "dropped": dropped}
        if samples:
            out["p50_ms"] = samples[len(samples) // 2]
            out["p99_ms"] = samples[min(len(samples) - 1, int(len(samples) * 0.99))]
        else:
            out["p50_ms"] = 0.0
            out["p99_ms"] = 0.0
        return out


class Histogram:
    """Fixed-bucket millisecond histogram for the request hot path.

    Lock-cheap by construction: the bucket index is computed OUTSIDE the
    lock (bisect over an immutable boundary tuple), so the critical section
    is three integer/float updates. Cumulative count/sum never reset —
    Prometheus scrapes are monotone — and p50/p99 are estimated in-process
    by linear interpolation inside the owning bucket, the same estimate
    histogram_quantile() would compute server-side.

    Values past the last boundary land in the overflow (+Inf) bucket — the
    "slow" bucket. A recorder that passes `exemplar=` (a trace id) for such
    a value gets it retained in the snapshot, so the p99 tail links
    straight to its span in /debug/traces.
    """

    __slots__ = (
        "name", "boundaries", "_counts", "_count", "_sum", "_exemplar",
        "_lock",
    )

    def __init__(self, name: str, boundaries=DEFAULT_LATENCY_BUCKETS_MS):
        if not boundaries:
            raise ValueError(f"histogram {name!r} needs at least one boundary")
        self.name = name
        self.boundaries: tuple[float, ...] = tuple(
            sorted(float(b) for b in boundaries)
        )
        self._counts = [0] * (len(self.boundaries) + 1)  # +1: overflow bucket
        self._count = 0
        self._sum = 0.0
        self._exemplar: dict | None = None
        self._lock = threading.Lock()

    def is_slow(self, value: float) -> bool:
        """True when `value` would land in the overflow (top) bucket —
        the recorder's cue to attach an exemplar / force-sample its span."""
        return value > self.boundaries[-1]

    def record(self, value: float, exemplar: str | None = None) -> None:
        value = float(value)
        i = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if exemplar is not None and i == len(self.boundaries):
                self._exemplar = {
                    "trace_id": exemplar,
                    "value": value,
                    "ts": time.time(),
                }

    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 < q <= 1)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        return self._percentile_from(counts, total, q)

    def _percentile_from(self, counts: list[int], total: int, q: float) -> float:
        if total == 0:
            return 0.0
        rank = q * total
        cumulative = 0
        for i, c in enumerate(counts):
            cumulative += c
            if cumulative >= rank:
                hi = (
                    self.boundaries[i]
                    if i < len(self.boundaries)
                    else self.boundaries[-1]  # overflow: clamp to last edge
                )
                lo = self.boundaries[i - 1] if i > 0 else 0.0
                if c == 0 or i >= len(self.boundaries):
                    return hi
                frac = (rank - (cumulative - c)) / c
                return lo + (hi - lo) * frac
        return self.boundaries[-1]

    def snapshot(self) -> dict:
        """Point-in-time view: cumulative per-bucket counts (Prometheus
        `le` semantics are derived by the renderer), count/sum, p50/p99
        estimates, and the latest slow-bucket exemplar if any."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            total_sum = self._sum
            exemplar = dict(self._exemplar) if self._exemplar else None
        out = {
            "boundaries": self.boundaries,
            "counts": counts,
            "count": total,
            "sum": total_sum,
            "p50": self._percentile_from(counts, total, 0.50),
            "p99": self._percentile_from(counts, total, 0.99),
        }
        if exemplar is not None:
            out["exemplar"] = exemplar
        return out


class StatGenerator(Protocol):
    """Evaluated at each flush to populate computed gauges
    (gostats StatGenerator equivalent)."""

    def generate_stats(self) -> None: ...


class Scope:
    """A dotted-name namespace over a Store."""

    __slots__ = ("_store", "_prefix")

    def __init__(self, store: "Store", prefix: str):
        self._store = store
        self._prefix = prefix

    def _full(self, name: str) -> str:
        return f"{self._prefix}.{name}" if self._prefix else name

    def scope(self, name: str) -> "Scope":
        return Scope(self._store, self._full(name))

    def counter(self, name: str) -> Counter:
        return self._store._counter(self._full(name))

    def gauge(self, name: str) -> Gauge:
        return self._store._gauge(self._full(name))

    def timer(self, name: str) -> Timer:
        return self._store._timer(self._full(name))

    def histogram(self, name: str, boundaries=None) -> Histogram:
        """boundaries=None uses the store default (settings-configurable);
        the first registration of a name pins its boundaries."""
        return self._store._histogram(self._full(name), boundaries)

    def add_stat_generator(self, generator: "StatGenerator") -> None:
        """Layers that only hold a Scope (the batcher, the engine) can still
        hang flush-time generators off the owning store."""
        self._store.add_stat_generator(generator)


class Store(Scope):
    """Root scope + flush loop. start_flushing spawns a daemon thread that
    flushes every interval to the sink; flush() can also be called manually
    (tests use a TestSink + manual flush)."""

    def __init__(self, sink=None, latency_buckets=None):
        from .sinks import NullSink

        self._sink = sink if sink is not None else NullSink()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._timers: dict[str, Timer] = {}
        self._histograms: dict[str, Histogram] = {}
        # default boundaries for histogram() calls that don't pass their
        # own — METRICS_LATENCY_BUCKETS_MS lands here via the runner
        self._latency_buckets = (
            tuple(sorted(float(b) for b in latency_buckets))
            if latency_buckets
            else DEFAULT_LATENCY_BUCKETS_MS
        )
        self._generators: list[StatGenerator] = []
        self._reg_lock = threading.Lock()
        self._flush_thread: threading.Thread | None = None
        self._stop = threading.Event()
        super().__init__(self, "")

    # -- stat registration (cached by full name) --

    def _counter(self, name: str) -> Counter:
        with self._reg_lock:
            stat = self._counters.get(name)
            if stat is None:
                stat = self._counters[name] = Counter(name)
            return stat

    def _gauge(self, name: str) -> Gauge:
        with self._reg_lock:
            stat = self._gauges.get(name)
            if stat is None:
                stat = self._gauges[name] = Gauge(name)
            return stat

    def _timer(self, name: str) -> Timer:
        with self._reg_lock:
            stat = self._timers.get(name)
            if stat is None:
                stat = self._timers[name] = Timer(name)
            return stat

    def _histogram(self, name: str, boundaries=None) -> Histogram:
        with self._reg_lock:
            stat = self._histograms.get(name)
            if stat is None:
                stat = self._histograms[name] = Histogram(
                    name, boundaries or self._latency_buckets
                )
            return stat

    def add_stat_generator(self, generator: StatGenerator) -> None:
        with self._reg_lock:
            self._generators.append(generator)

    def _run_generators(self) -> None:
        with self._reg_lock:
            generators = list(self._generators)
        for gen in generators:
            try:
                gen.generate_stats()
            except Exception:  # stats must never take the service down
                pass

    def debug_snapshot(self) -> dict:
        """Current stat values by full name — backs the debug-port /stats
        endpoint (expvar dump in the reference, server_impl.go:227-234).
        Counters/gauges dump their value; timers and histograms dump
        count/p50/p99 summaries (flattened as name.count etc.) so GET /stats
        reflects latency, not just counts. Runs the generators first so
        computed gauges are fresh."""
        self._run_generators()
        with self._reg_lock:
            out: dict = {name: c.value() for name, c in self._counters.items()}
            out.update({name: g.value() for name, g in self._gauges.items()})
            timers = list(self._timers.values())
            histograms = list(self._histograms.values())
        for t in timers:
            s = t.summary()
            out[f"{t.name}.count"] = s["count"]
            out[f"{t.name}.p50_ms"] = round(s["p50_ms"], 4)
            out[f"{t.name}.p99_ms"] = round(s["p99_ms"], 4)
            if s["dropped"]:
                out[f"{t.name}.dropped"] = s["dropped"]
        for h in histograms:
            s = h.snapshot()
            out[f"{h.name}.count"] = s["count"]
            out[f"{h.name}.p50"] = round(s["p50"], 4)
            out[f"{h.name}.p99"] = round(s["p99"], 4)
            if "exemplar" in s:
                out[f"{h.name}.exemplar"] = s["exemplar"]["trace_id"]
        return dict(sorted(out.items()))

    def metrics_snapshot(self) -> dict:
        """Typed point-in-time view of every stat — the source for the
        Prometheus renderer and for bench.py's per-stage artifact fields
        (one snapshot path, so live telemetry and BENCH can never
        disagree). Generators run first, like every other export."""
        self._run_generators()
        with self._reg_lock:
            counters = {n: c.value() for n, c in self._counters.items()}
            gauges = {n: g.value() for n, g in self._gauges.items()}
            timers = list(self._timers.values())
            histograms = list(self._histograms.values())
        return {
            "counters": counters,
            "gauges": gauges,
            "timers": {t.name: t.summary() for t in timers},
            "histograms": {h.name: h.snapshot() for h in histograms},
        }

    # -- flushing --

    def flush(self) -> None:
        self._run_generators()
        with self._reg_lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            timers = list(self._timers.values())
            histograms = list(self._histograms.values())
        try:
            for c in counters:
                delta = c.latch_delta()
                if delta:
                    self._sink.flush_counter(c.name, delta)
            for g in gauges:
                self._sink.flush_gauge(g.name, g.value())
            for t in timers:
                for ms in t.latch():
                    self._sink.flush_timer(t.name, ms)
            # histograms are pull-model (GET /metrics); sinks that also
            # want them push-side (TestSink) opt in via flush_histogram
            flush_histogram = getattr(self._sink, "flush_histogram", None)
            if flush_histogram is not None:
                for h in histograms:
                    flush_histogram(h.name, h.snapshot())
            self._sink.flush()
        except Exception:  # a failing sink must not kill the flush loop
            pass

    def start_flushing(self, interval_seconds: float = 5.0) -> None:
        if self._flush_thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_seconds):
                self.flush()

        self._flush_thread = threading.Thread(
            target=loop, name="stats-flush", daemon=True
        )
        self._flush_thread.start()

    def stop_flushing(self) -> None:
        self._stop.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=1.0)
            self._flush_thread = None


def new_null_store() -> Store:
    """A store that drops everything — the stats.NewStore(NullSink) idiom the
    reference tests use (test/common/common.go:15-20)."""
    return Store()
