"""Port of api_ratelimit_tpu/backends/lease.py: hierarchical quota leasing,
frontend-local decisions with bounded overshoot.

At millions of users the cheapest — and most failure-tolerant — decision is
one that never leaves the frontend. The device-authoritative slab GRANTS
leases: budget slices of N counter tokens with a sub-window TTL. A frontend
holding a live lease answers subsequent decisions for that (key, window)
locally from the leased budget; only lease grant/renew/settle traffic
reaches the dispatch loop, so the hot head of a Zipf stream stops funneling
every request to the device.

Reservation semantics (the correctness core): a grant is a batched INCRBY
of the lease size riding the EXISTING row-block machinery — the granting
request's row ships hits = hits_addend + lease_n, no new kernel, no extra
device traffic. The returned post-increment counter `after` splits by
convention: the caller's own decision ends at after - lease_n, and the
lease owns the counter range (after - lease_n, after]. Every local decision
is therefore an exact continuation of the global counter (local after =
base + consumed), so a single-frontend sequential stream makes byte-
identical decisions with leasing on or off (pinned by test). Inexactness is
one-sided and bounded:

  * tokens unconsumed at TTL expiry are BURNED (the counter stays high) —
    under-admission of at most the lease size per key per window, kept
    small by adaptive sizing;
  * overshoot (total admitted > limit) requires the device to FORGET a
    grant — a crash that loses the INCRBY — and is bounded by the sum of
    outstanding lease budgets; the lease-liability snapshot section
    (persist/) closes even that: restore floors each restored counter at
    its post-grant watermark, so a warm restart never double-grants.

Adaptive sizing: a lease renewed because demand exhausted it before its TTL
doubles (up to LEASE_MAX); a lease that expires mostly unconsumed halves
(down to LEASE_MIN); near the limit the grant shrinks toward 1
(min(size, headroom // 2) past LEASE_NEAR_LIMIT_RATIO) so accuracy degrades
smoothly instead of reserving past the limit.

Failure ladder: the lease decide path needs no backend, so a dead device
owner keeps being answered from outstanding leases until their TTL — the
sticky `lease.degraded` probe surfaces that state on /healthcheck — and an
expired/exhausted lease falls through to the existing FAILURE_MODE_DENY
rungs exactly like the fail-open rung (backends/fallback.py consults the
lease table per descriptor before answering by rung).

Two halves live here:

  LeaseTable     the frontend half: the (fp, window) -> lease map consulted
                 in service/ratelimit.py before do_limit_resolved, grant
                 planning/registration for the device path, settle queue,
                 degraded probe. One small lock; critical sections are a
                 dict probe + integer arithmetic.
  LeaseRegistry  the device-owner half: outstanding-liability accounting
                 (granted/settled/floor per (fp, window)), exported into
                 the warm-restart snapshot and reconciled at boot.

Wire: grants/settles ride the sidecar SUBMIT frame as a length-prefixed
trailer signalled by header-flags bit 1 (the reference's backends/sidecar.py,
the same u16 flags-trailer discipline the B3 trace trailer uses). The port
has no sidecar yet: in process the ops ride submit_rows(lease_ops=...)
(backends/cuda.py), and the codec is kept for the sidecar to come.

stdlib + numpy only — the sidecar server and offline tools import this
without paying a torch import.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np

from ..limiter.base_limiter import LimitInfo
from ..models.response import DoLimitResponse
from ..models.units import unit_to_divider
from ..ops.hashing import fingerprint64

logger = logging.getLogger("ratelimit.lease")

# lease-ops wire trailer (sidecar SUBMIT frame, header-flags bit 1):
#   u32 n_grant | u32 n_settle
#   grants:  n_grant  x uint32[4]  (row_idx, lease_n, window, ttl_s)
#   settles: n_settle x uint32[4]  (fp_lo, fp_hi, window, consumed)
_U32x2 = struct.Struct("<II")
_OP_WORDS = 4

# snapshot row layout for the registry (persist/snapshot.py writes these
# as an (n, 8) uint32 table in leases.snap; 8 keeps parity with the slab
# row width so the CRC/atomic-write machinery is reused verbatim)
LEASE_ROW_WIDTH = 8
(
    LEASE_COL_FP_LO,
    LEASE_COL_FP_HI,
    LEASE_COL_WINDOW,
    LEASE_COL_GRANTED,
    LEASE_COL_SETTLED,
    LEASE_COL_FLOOR,
    LEASE_COL_EXPIRE,
) = range(7)


class PlannedGrant(NamedTuple):
    """One descriptor's grant decision, made while building the row block:
    the row ships hits + size, and after the response the lease registers
    with base = after - size."""

    fp: int
    window: int
    size: int
    ttl_s: int
    expires_at: int


class LeaseOps(NamedTuple):
    """Lease traffic piggybacked on one row-block submit. grants reference
    block columns by index (the fp travels in the block itself); settles
    carry their own fp — they may outlive the block that granted them."""

    grants: Sequence[tuple[int, int, int, int]]  # (row_idx, n, window, ttl_s)
    settles: Sequence[tuple[int, int, int]]  # (fp, window, consumed)


def encode_lease_ops(ops: LeaseOps) -> bytes:
    """Length-prefixed wire trailer body for one SUBMIT frame."""
    grants, settles = ops
    body = np.empty((len(grants) + len(settles), _OP_WORDS), dtype="<u4")
    for i, (idx, n, window, ttl_s) in enumerate(grants):
        body[i] = (idx, n, window, ttl_s)
    off = len(grants)
    for i, (fp, window, consumed) in enumerate(settles):
        body[off + i] = (fp & 0xFFFFFFFF, fp >> 32, window, consumed)
    raw = _U32x2.pack(len(grants), len(settles)) + body.tobytes()
    return struct.pack("<I", len(raw)) + raw


def decode_lease_ops(raw: bytes) -> LeaseOps:
    """Inverse of encode_lease_ops (the trailer body, length prefix already
    consumed by the framing layer). Raises ValueError on a malformed body —
    the server answers with an error reply, never crashes."""
    if len(raw) < _U32x2.size:
        raise ValueError(f"lease trailer too short ({len(raw)} bytes)")
    n_grant, n_settle = _U32x2.unpack_from(raw)
    want = _U32x2.size + (n_grant + n_settle) * _OP_WORDS * 4
    if len(raw) != want:
        raise ValueError(
            f"lease trailer is {len(raw)} bytes, counts say {want}"
        )
    body = np.frombuffer(raw, dtype="<u4", offset=_U32x2.size).reshape(
        n_grant + n_settle, _OP_WORDS
    )
    grants = [tuple(int(v) for v in row) for row in body[:n_grant]]
    settles = [
        (int(row[0]) | (int(row[1]) << 32), int(row[2]), int(row[3]))
        for row in body[n_grant:]
    ]
    return LeaseOps(grants=grants, settles=settles)


class _Lease:
    """One outstanding frontend-held budget slice. Mutated only under the
    owning LeaseTable's lock."""

    __slots__ = ("base", "granted", "consumed", "expires_at")

    def __init__(self, base: int, granted: int, expires_at: int):
        self.base = base
        self.granted = granted
        self.consumed = 0
        self.expires_at = expires_at


class LeaseTable:
    """The frontend half: local decide path + grant planning + settles.

    Stats (under <scope>, the runner mounts it at ratelimit.lease):
        decisions_seen   descriptor decisions seen by the lease decide path
        local_hits       decisions answered from a live lease (no device)
        cache_hits       decisions answered by the over-limit local cache
                         inside the lease path (also device-free)
        misses           try_answer passes that fell through to the device
        grants           leases granted (one INCRBY rider each)
        grant_tokens     counter tokens reserved across all grants
        renews           grants that replaced an exhausted-but-live lease
        expired          leases retired at TTL with the window still open
        burned_tokens    reserved tokens unconsumed at retirement — the
                         bounded under-admission cost
        settles          settle records queued for the device owner
        fallback_hits    decisions served from a lease by the failure
                         ladder while the device owner was dark
        outstanding      live leases held (gauge)
        outstanding_tokens  unconsumed reserved tokens held (gauge)
        degraded         1 while device-failing and serving lease-only
        local_ms         latency of locally-answered requests (histogram)
    """

    def __init__(
        self,
        base_limiter,
        min_size: int = 8,
        max_size: int = 1024,
        ttl_fraction: float = 0.25,
        near_limit_ratio: float = 0.9,
        max_leases: int = 1 << 16,
        scope=None,
    ):
        if min_size < 1:
            raise ValueError(f"LEASE_MIN must be >= 1, got {min_size}")
        if max_size < min_size:
            raise ValueError(
                f"LEASE_MAX ({max_size}) must be >= LEASE_MIN ({min_size})"
            )
        if not 0.0 < ttl_fraction <= 1.0:
            raise ValueError(
                f"LEASE_TTL_FRACTION must be in (0, 1], got {ttl_fraction}"
            )
        if not 0.0 < near_limit_ratio <= 1.0:
            raise ValueError(
                f"LEASE_NEAR_LIMIT_RATIO must be in (0, 1], "
                f"got {near_limit_ratio}"
            )
        self._base = base_limiter
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.ttl_fraction = float(ttl_fraction)
        self.near_limit_ratio = float(near_limit_ratio)
        self._max_leases = int(max_leases)
        self._lock = threading.Lock()
        self._leases: dict[tuple[int, int], _Lease] = {}
        # fp -> adaptive grant size; fp -> (window, device-counter watermark)
        self._sizes: dict[int, int] = {}
        self._after_hint: dict[int, tuple[int, int]] = {}
        self._pending_settles: list[tuple[int, int, int]] = []
        # (fp, window) keys with a grant rider currently in flight to the
        # device: concurrent misses for the same key must not both carry a
        # rider — the loser's budget would be retired unconsumed (burned)
        # the moment the winner registers
        self._inflight: set[tuple[int, int]] = set()
        self._degraded = False
        self._reason = ""
        self._ops_since_sweep = 0
        self._outstanding_tokens = 0

        self._h_local = None
        self._c: dict = {}
        self._g_outstanding = self._g_tokens = self._g_degraded = None
        if scope is not None:
            # literal registrations (tools/metrics_lint.py scans these)
            self._c = {
                "decisions": scope.counter("decisions_seen"),
                "local_hits": scope.counter("local_hits"),
                "cache_hits": scope.counter("cache_hits"),
                "misses": scope.counter("misses"),
                "grants": scope.counter("grants"),
                "grant_tokens": scope.counter("grant_tokens"),
                "renews": scope.counter("renews"),
                "expired": scope.counter("expired"),
                "burned_tokens": scope.counter("burned_tokens"),
                "settles": scope.counter("settles"),
                "fallback_hits": scope.counter("fallback_hits"),
                "hot_preseeded": scope.counter("hot_preseeded"),
            }
            self._g_outstanding = scope.gauge("outstanding")
            self._g_tokens = scope.gauge("outstanding_tokens")
            self._g_degraded = scope.gauge("degraded")
            self._g_degraded.set(0)
            self._h_local = scope.histogram("local_ms")
            scope.add_stat_generator(self)

    # -- stats --

    def _count(self, name: str, delta: int = 1) -> None:
        c = self._c.get(name)
        if c is not None and delta:
            c.add(delta)

    def generate_stats(self) -> None:
        """StatGenerator hook: refresh the outstanding gauges per flush."""
        with self._lock:
            n, tokens = len(self._leases), self._outstanding_tokens
        if self._g_outstanding is not None:
            self._g_outstanding.set(n)
            self._g_tokens.set(max(0, tokens))

    def outstanding(self) -> tuple[int, int]:
        """(live leases held, unconsumed reserved tokens) — the Σ budgets
        term of the documented overshoot bound."""
        now = self._base.time_source.unix_now()
        with self._lock:
            live = [
                lease
                for lease in self._leases.values()
                if lease.expires_at > now
            ]
            return len(live), sum(
                lease.granted - lease.consumed for lease in live
            )

    # -- failure-ladder probe --

    def note_device_failure(self, error: Exception) -> None:
        """Sticky lease.degraded probe: the device owner is failing and
        this frontend is running on outstanding leases until their TTL."""
        with self._lock:
            entered = not self._degraded
            self._degraded = True
            self._reason = (
                f"lease.degraded: device owner failing ({error}); serving "
                f"from outstanding leases until TTL"
            )
        if self._g_degraded is not None:
            self._g_degraded.set(1)
        if entered:
            logger.warning(
                "device owner failing; serving from outstanding leases "
                "until TTL (%s)",
                error,
            )

    def note_success(self) -> None:
        with self._lock:
            if not self._degraded:
                return
            self._degraded = False
            self._reason = ""
        if self._g_degraded is not None:
            self._g_degraded.set(0)
        logger.warning("device owner recovered; leaving lease.degraded")

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def degraded_reason(self) -> str | None:
        """HealthChecker degraded-probe contract."""
        with self._lock:
            return self._reason if self._degraded else None

    # -- internal lease lifecycle (call under self._lock) --

    def _retire_locked(
        self, key: tuple[int, int], lease: _Lease, expired: bool
    ) -> None:
        del self._leases[key]
        self._outstanding_tokens -= lease.granted - lease.consumed
        if lease.consumed:
            if len(self._pending_settles) < 8192:  # settles are advisory
                self._pending_settles.append(
                    (key[0], key[1], lease.consumed)
                )
                self._count("settles")
        burned = lease.granted - lease.consumed
        if burned:
            self._count("burned_tokens", burned)
        if expired:
            self._count("expired")
            if lease.consumed * 2 < lease.granted:
                # mostly unconsumed at TTL: the size overshot demand
                self._sizes[key[0]] = max(
                    self.min_size, lease.granted // 2
                )

    def _get_live_locked(
        self, fp: int, window: int, now: int
    ) -> _Lease | None:
        lease = self._leases.get((fp, window))
        if lease is None:
            return None
        if lease.expires_at <= now:
            self._retire_locked((fp, window), lease, expired=True)
            return None
        return lease

    def _maybe_sweep_locked(self, now: int) -> None:
        """Amortized expiry sweep: old-window leases must not accrete."""
        self._ops_since_sweep += 1
        if self._ops_since_sweep < 256 and len(self._leases) < self._max_leases:
            return
        self._ops_since_sweep = 0
        for key in [
            k for k, v in self._leases.items() if v.expires_at <= now
        ]:
            self._retire_locked(key, self._leases[key], expired=True)
        if len(self._after_hint) > (1 << 16):
            self._after_hint.clear()
        if len(self._sizes) > (1 << 16):
            self._sizes.clear()

    # -- the frontend-local decide path (service/ratelimit.py) --

    def try_answer(self, request, resolved) -> DoLimitResponse | None:
        """All-or-nothing local answer: every matched descriptor must be
        coverable by the over-limit cache or a live lease with budget, or
        the WHOLE request rides the device path (which plans grants for
        the misses). Decision-identical to do_limit_resolved by
        construction: the same BaseRateLimiter oracle builds every status
        from counter positions that exactly continue the device counter."""
        t0 = time.perf_counter() if self._h_local is not None else 0.0
        base = self._base
        hits_addend = max(1, request.hits_addend)
        now = base.time_source.unix_now()
        local_cache = base.local_cache
        n = len(resolved)
        checked = sum(1 for rec in resolved if rec is not None)
        # plan[i]: None (unchecked) | (key, None) over-limit-cache hit
        #        | (key, after) lease-consumed local decision
        plan: list = [None] * n
        with self._lock:
            self._maybe_sweep_locked(now)
            consumable: list[tuple[int, _Lease, str]] = []
            for i in range(n):
                rec = resolved[i]
                if rec is None:
                    continue
                window = (now // rec.divider) * rec.divider
                if local_cache is not None:
                    key = rec.key_prefix + str(window)
                    if not rec.shadow_mode and local_cache.contains(key):
                        plan[i] = (key, None)
                        continue
                else:
                    key = rec.key_prefix
                lease = self._get_live_locked(rec.fp, window, now)
                if (
                    lease is None
                    or lease.consumed + hits_addend > lease.granted
                ):
                    self._count("decisions", checked)
                    self._count("misses")
                    return None
                consumable.append((i, lease, key))
            # every checked descriptor is coverable: consume atomically
            for i, lease, key in consumable:
                lease.consumed += hits_addend
                self._outstanding_tokens -= hits_addend
                plan[i] = (key, lease.base + lease.consumed)
        self._count("decisions", checked)
        if not checked:
            # nothing matched any rule; let the normal path answer (it
            # allocates nothing for unchecked-only requests anyway)
            return None
        # statuses outside the lock: the oracle only touches per-rule stat
        # counters and the (internally locked) local cache
        response = DoLimitResponse()
        statuses = response.descriptor_statuses
        get_status = base.get_response_descriptor_status
        local_hits = cache_hits = 0
        for i in range(n):
            rec = resolved[i]
            if rec is None:
                statuses.append(
                    get_status("", None, False, hits_addend, response)
                )
                continue
            rec.stats.total_hits.add(hits_addend)
            key, after = plan[i]
            if after is None:
                cache_hits += 1
                statuses.append(
                    get_status(
                        key,
                        LimitInfo(rec.limit, -hits_addend, 0),
                        True,
                        hits_addend,
                        response,
                    )
                )
                continue
            local_hits += 1
            statuses.append(
                get_status(
                    key,
                    LimitInfo(rec.limit, after - hits_addend, after),
                    False,
                    hits_addend,
                    response,
                )
            )
        self._count("local_hits", local_hits)
        self._count("cache_hits", cache_hits)
        if self._h_local is not None:
            self._h_local.record((time.perf_counter() - t0) * 1e3)
        return response

    # -- sketch-driven adaptive sizing (backends/cuda.py drain_hotkeys) --

    def note_hot_fps(self, fps) -> None:
        """Pre-seed the adaptive size map for sketch-ranked hot keys: their
        next grant starts at LEASE_MAX instead of climbing there through
        exhaustion-renewal doublings (each doubling is a device round trip
        the local decide path then misses). Overshoot stays bounded by the
        existing grant clamps — plan_grant still shrinks toward headroom
        past the near-limit ratio and never reserves past the limit — and
        the mostly-unused-expiry halving still rules a key that cools
        faster than the next drain re-seeds it. fps: combined 64-bit
        fingerprints (the _sizes key)."""
        preseeded = 0
        with self._lock:
            for fp in fps:
                if self._sizes.get(fp, self.min_size) < self.max_size:
                    self._sizes[fp] = self.max_size
                    preseeded += 1
        self._count("hot_preseeded", preseeded)

    # -- grant planning/registration (the device path, do_limit_resolved) --

    def plan_grant(self, rec, hits_addend: int, now: int) -> PlannedGrant | None:
        """Decide whether this descriptor's device row should carry a lease
        INCRBY rider, and how big. Returns None for no grant.

        Per-algorithm lease story: fixed/sliding-window leases are counter
        slices of the current window (the original semantics). A GCRA
        lease is a TAT SLICE — the rider's extra hits advance the
        theoretical arrival time by size*T, reserving that many emissions
        for frontend-local admission (a denied rider reserved nothing and
        is aborted by the caller, backends/cuda.py). CONCURRENCY is never
        leased: in-flight slots must be released, and a frontend-local
        slot could never observe another frontend's Release — every
        acquire/release goes to the device."""
        if getattr(rec, "algorithm", 0) == 3:  # ALGO_ID_CONCURRENCY
            return None
        divider = rec.divider
        window = (now // divider) * divider
        limit = rec.requests_per_unit
        fp = rec.fp
        with self._lock:
            lease = self._leases.get((fp, window))
            if lease is not None:
                if lease.expires_at <= now:
                    self._retire_locked((fp, window), lease, expired=True)
                elif lease.consumed + hits_addend <= lease.granted:
                    return None  # a usable lease raced in since the miss
                else:
                    # exhausted before its TTL: demand beat the size — grow.
                    # max() against the CURRENT size, not a plain assign: a
                    # hot-key pre-seed (note_hot_fps) that landed while this
                    # small lease was live must not be clobbered back down
                    # to granted*2 — exhaustion only ever argues for MORE
                    # budget (the mostly-unused-expiry halving is the one
                    # legitimate shrink path)
                    self._sizes[fp] = min(
                        self.max_size,
                        max(
                            self._sizes.get(fp, self.min_size),
                            self.min_size,
                            lease.granted * 2,
                        ),
                    )
                    self._count("renews")
                    self._retire_locked((fp, window), lease, expired=False)
            if len(self._leases) >= self._max_leases:
                return None
            if (fp, window) in self._inflight:
                return None  # another thread's rider is already out
            size = self._sizes.get(fp, self.min_size)
            hint = self._after_hint.get(fp)
            if hint is not None and hint[0] == window:
                headroom = limit - hint[1]
                if headroom <= 0:
                    # at/over the limit: reserving more only serves denials,
                    # which the over-limit cache already short-circuits
                    return None
                if hint[1] >= int(limit * self.near_limit_ratio):
                    # shrink toward 1 as headroom closes: accuracy degrades
                    # smoothly instead of burning a big slice at the edge
                    size = max(1, headroom // 2)
                size = min(size, headroom)
            else:
                size = min(size, limit)
            if size <= 0:
                return None
            self._inflight.add((fp, window))
        ttl_s = max(1, int(divider * self.ttl_fraction))
        expires_at = min(now + ttl_s, window + divider)
        return PlannedGrant(
            fp=fp,
            window=window,
            size=size,
            ttl_s=expires_at - now,
            expires_at=expires_at,
        )

    def register_grant(self, planned: PlannedGrant, after_total: int) -> int:
        """Install the granted lease once the device answered. after_total
        is the row's post-increment counter INCLUDING the lease rider;
        returns the caller's own post-increment position (after - size)."""
        base = after_total - planned.size
        key = (planned.fp, planned.window)
        now = self._base.time_source.unix_now()
        with self._lock:
            self._inflight.discard(key)
            old = self._leases.get(key)
            if old is not None:
                # a concurrent grant won the race; retire the loser's
                # budget (its tokens settle/burn, never double-serve)
                self._retire_locked(key, old, expired=old.expires_at <= now)
            self._leases[key] = _Lease(
                base=base, granted=planned.size, expires_at=planned.expires_at
            )
            self._outstanding_tokens += planned.size
            hint = self._after_hint.get(planned.fp)
            if (
                hint is None
                or hint[0] != planned.window
                or hint[1] < after_total
            ):
                self._after_hint[planned.fp] = (planned.window, after_total)
        self._count("grants")
        self._count("grant_tokens", planned.size)
        return base

    def abort_grant(self, planned: PlannedGrant) -> None:
        """Release a planned grant whose submit failed (the rider never
        executed, or its answer was lost) — unblocks the next miss's
        rider for this key."""
        with self._lock:
            self._inflight.discard((planned.fp, planned.window))

    def drain_settles(self) -> list[tuple[int, int, int]]:
        """Take the queued (fp, window, consumed) settle records — they
        piggyback on the next device submit."""
        with self._lock:
            settles, self._pending_settles = self._pending_settles, []
        return settles

    def requeue_settles(self, settles) -> None:
        """Put drained settles back after a failed submit (advisory data;
        the registry's TTL sweep bounds the loss if they never land)."""
        if not settles:
            return
        with self._lock:
            self._pending_settles = (
                list(settles) + self._pending_settles
            )[:8192]

    # -- the failure-ladder hook (backends/fallback.py) --

    def consume_for_fallback(
        self, domain: str, descriptor, limit, hits_addend: int, response
    ):
        """Serve one descriptor from an outstanding lease while the device
        owner is dark. Returns a DescriptorStatus or None (no usable
        lease — the caller's rung answers). Cold path: the fingerprint is
        recomputed here; the hot path carries it precompiled."""
        divider = unit_to_divider(limit.unit)
        now = self._base.time_source.unix_now()
        window = (now // divider) * divider
        fp = fingerprint64(domain, descriptor.entries, divider)
        with self._lock:
            lease = self._get_live_locked(fp, window, now)
            if lease is None or lease.consumed + hits_addend > lease.granted:
                return None
            lease.consumed += hits_addend
            self._outstanding_tokens -= hits_addend
            after = lease.base + lease.consumed
        self._count("fallback_hits")
        parts = [domain]
        for entry in descriptor.entries:
            parts.append(entry.key)
            parts.append(entry.value)
        key = "_".join(parts) + f"_{window}"
        return self._base.get_response_descriptor_status(
            key,
            LimitInfo(limit, after - hits_addend, after),
            False,
            hits_addend,
            response,
        )


class _Liability:
    """Device-owner-side record of one (fp, window)'s outstanding grants."""

    __slots__ = ("granted", "settled", "floor", "expires_at")

    def __init__(self, granted=0, settled=0, floor=0, expires_at=0):
        self.granted = granted
        self.settled = settled
        self.floor = floor
        self.expires_at = expires_at


class LeaseRegistry:
    """The device-owner half: who holds how much un-settled budget, and the
    counter watermark (`floor`) each restored slab row must respect so a
    warm restart never double-grants. Rides the snapshot as leases.snap
    (persist/snapshotter.py)."""

    def __init__(self, time_source, max_entries: int = 1 << 17):
        self._time_source = time_source
        self._max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: dict[tuple[int, int], _Liability] = {}
        self._ops_since_sweep = 0
        self.grants_total = 0
        self.settles_total = 0

    def grant(
        self, fp: int, window: int, n: int, expires_at: int, floor: int
    ) -> None:
        with self._lock:
            entry = self._entries.get((fp, window))
            if entry is None:
                if len(self._entries) >= self._max_entries:
                    self._sweep_locked(self._time_source.unix_now())
                if len(self._entries) >= self._max_entries:
                    return  # bounded: an over-full registry drops tracking
                entry = self._entries[(fp, window)] = _Liability()
            entry.granted += int(n)
            entry.floor = max(entry.floor, int(floor))
            entry.expires_at = max(entry.expires_at, int(expires_at))
            self.grants_total += 1
            self._ops_since_sweep += 1
            if self._ops_since_sweep >= 512:
                self._sweep_locked(self._time_source.unix_now())

    def settle(self, fp: int, window: int, consumed: int) -> None:
        with self._lock:
            entry = self._entries.get((fp, window))
            if entry is None:
                return
            entry.settled = min(entry.granted, entry.settled + int(consumed))
            self.settles_total += 1
            if entry.settled >= entry.granted:
                del self._entries[(fp, window)]

    def _sweep_locked(self, now: int) -> None:
        self._ops_since_sweep = 0
        for key in [
            k for k, v in self._entries.items() if v.expires_at <= now
        ]:
            del self._entries[key]

    def sweep(self, now: int | None = None) -> None:
        with self._lock:
            self._sweep_locked(
                self._time_source.unix_now() if now is None else now
            )

    def outstanding(self) -> tuple[int, int]:
        """(entries, unsettled tokens) across live liabilities."""
        now = self._time_source.unix_now()
        with self._lock:
            live = [
                v for v in self._entries.values() if v.expires_at > now
            ]
            return len(live), sum(v.granted - v.settled for v in live)

    # -- snapshot integration (persist/) --

    def export_rows(self, now: int | None = None) -> np.ndarray:
        """Live liabilities as an (n, LEASE_ROW_WIDTH) uint32 table."""
        if now is None:
            now = self._time_source.unix_now()
        with self._lock:
            self._sweep_locked(now)
            rows = np.zeros(
                (len(self._entries), LEASE_ROW_WIDTH), dtype=np.uint32
            )
            for i, ((fp, window), v) in enumerate(self._entries.items()):
                rows[i] = (
                    fp & 0xFFFFFFFF,
                    fp >> 32,
                    window,
                    v.granted,
                    v.settled,
                    v.floor,
                    v.expires_at,
                    0,
                )
        return rows

    def import_rows(self, rows: np.ndarray) -> int:
        """Seed the registry from reconciled snapshot rows (boot restore);
        returns the number imported. Replaces any same-key entry."""
        rows = np.asarray(rows, dtype=np.uint32)
        count = 0
        with self._lock:
            for row in rows:
                fp = int(row[LEASE_COL_FP_LO]) | (
                    int(row[LEASE_COL_FP_HI]) << 32
                )
                self._entries[(fp, int(row[LEASE_COL_WINDOW]))] = _Liability(
                    granted=int(row[LEASE_COL_GRANTED]),
                    settled=int(row[LEASE_COL_SETTLED]),
                    floor=int(row[LEASE_COL_FLOOR]),
                    expires_at=int(row[LEASE_COL_EXPIRE]),
                )
                count += 1
        return count


class LeaseRegistryStats:
    """StatGenerator exporting the device-owner liability gauges:

        ratelimit.lease.registry_outstanding   live (fp, window) liabilities
        ratelimit.lease.registry_tokens        unsettled granted tokens —
                                               the Σ budgets term of the
                                               crash-overshoot bound
    """

    def __init__(self, registry: LeaseRegistry, scope):
        self._registry = registry
        self._g_entries = scope.gauge("registry_outstanding")
        self._g_tokens = scope.gauge("registry_tokens")

    def generate_stats(self) -> None:
        entries, tokens = self._registry.outstanding()
        self._g_entries.set(entries)
        self._g_tokens.set(tokens)


def apply_lease_ops(
    registry: LeaseRegistry,
    block: np.ndarray,
    afters,
    ops: LeaseOps,
    now: int,
) -> None:
    """Register one submit's piggybacked lease traffic against the owner
    registry: each grant's floor is the row's post-increment counter (the
    watermark a restored slab row must respect), keyed by the fingerprint
    riding the block. Invalid row indices are skipped — a malformed frame
    must not take the device owner down."""
    n = block.shape[1]
    for idx, size, window, ttl_s in ops.grants:
        if not 0 <= idx < n:
            continue
        fp = int(block[0, idx]) | (int(block[1, idx]) << 32)
        registry.grant(
            fp, window, size, expires_at=now + ttl_s, floor=int(afters[idx])
        )
    for fp, window, consumed in ops.settles:
        registry.settle(fp, window, consumed)
