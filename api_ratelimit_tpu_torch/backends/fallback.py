"""Port of api_ratelimit_tpu/backends/fallback.py: the fail-open degradation
ladder.

The reference service ships FailureModeDeny because a dead cache must
degrade to a POLICY DECISION, not an error storm ("the request is assumed
allowed on error", README.md:567-568). This module is that policy layer:
when the cache raises CacheError (a failed kernel launch or readback on the
card, a closed batcher), the service consults a FallbackLimiter instead of
surfacing the error, when FAILURE_MODE_DENY names a rung (settings.py; empty,
the default, keeps the raise-through):

    deny      every descriptor answers OVER_LIMIT (deny-all)
    allow     every descriptor answers OK (fail-open, the upstream default
              posture: availability over enforcement)

The reference's third rung, `degraded`, answers from a process-local
in-memory limiter: the rate-limit decision would move to the CPU when the
card fails, so this package has no such rung and settings.py refuses
FAILURE_MODE_DENY=degraded (ROADMAP "Deliberate departures").

The degraded flag is sticky until the next successful primary decision, and
is exported as the ratelimit.fallback.degraded gauge plus the /healthcheck
body (HealthChecker.set_degraded_probe) so orchestrators can see an
instance running on fallback policy while it keeps taking traffic.

The ladder is a policy answer, never a second execution: it computes no
decision, on the card or on the CPU, and every answer it gives is counted
(ratelimit.fallback.{deny,allow}). With a lease table (LEASE_ENABLED) a
descriptor that still holds a live lease is answered from that budget, which
the card granted before it failed, and with quota federation (FED_ENABLED)
the next rung is the cluster's share ledger: home budget this cluster owns,
or a share another cluster's home granted it, counted on the host. Only the
rest fall to the deny or allow rung.

CircuitBreaker is the sidecar client's transport breaker
(backends/sidecar.py): while the device owner is dark it fails fast, and
the CacheError it raises lands on this ladder.
"""

from __future__ import annotations

import logging
import threading
from typing import Sequence

from ..models.config import RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import Code, DescriptorStatus, DoLimitResponse

logger = logging.getLogger("ratelimit.fallback")

FAILURE_MODE_DENY = "deny"
FAILURE_MODE_ALLOW = "allow"
FAILURE_MODES = (FAILURE_MODE_DENY, FAILURE_MODE_ALLOW)


class CircuitBreaker:
    """Consecutive-failure circuit breaker: closed -> open after
    `threshold` consecutive failures; open fails fast for `reset_seconds`;
    then one half-open probe is let through: success closes the breaker,
    failure re-opens it for another reset window. threshold <= 0 disables
    (always allows, records nothing).

    on_transition(old_state, new_state) is invoked on every state change
    (stat gauges); it must be cheap: it runs under the breaker lock."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    # numeric codes for the breaker_state gauge (gauges are ints)
    STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, threshold: int, reset_seconds: float, clock=None, on_transition=None):
        self._threshold = int(threshold)
        self._reset = float(reset_seconds)
        if clock is None:
            # reset windows are time-semantic: the process clock authority
            from ..utils.timeutil import process_time_source

            clock = process_time_source().monotonic
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._open_until = 0.0
        self._probe_in_flight = False

    @property
    def enabled(self) -> bool:
        return self._threshold > 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True when a request may proceed. While open, False until the
        reset window elapses; the first caller after that becomes the
        half-open probe (others keep failing fast until it resolves)."""
        if not self.enabled:
            return True
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and self._clock() >= self._open_until:
                self._transition(self.HALF_OPEN)
                self._probe_in_flight = True
                return True
            if self._state == self.HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._failures += 1
            self._probe_in_flight = False
            if self._state == self.HALF_OPEN or (
                self._state == self.CLOSED and self._failures >= self._threshold
            ):
                self._open_until = self._clock() + self._reset
                self._transition(self.OPEN)
            elif self._state == self.OPEN:
                # failures while open (requests racing the transition)
                # push the probe window out: the backend is still dark
                self._open_until = self._clock() + self._reset

    def _transition(self, state: str) -> None:
        prev, self._state = self._state, state
        if self._on_transition is not None:
            try:
                self._on_transition(prev, state)
            except Exception:  # noqa: BLE001 - stats must never take the breaker down
                pass


class FallbackLimiter:
    """The degradation ladder the service consults on backend CacheError.

    Stats (under <scope>.fallback):
        deny / allow           requests answered by each rung (counters)
        degraded               1 while running on fallback policy (gauge;
                               sticky until the next primary success)
    """

    def __init__(self, mode: str, scope=None, lease_table=None, fed_shares=None):
        """mode: deny or allow (FAILURE_MODES); scope roots the
        <scope>.fallback.* stats.

        lease_table: optional backends.lease.LeaseTable. When set, every
        descriptor is first offered to its outstanding lease (the card
        granted real budget for it before it failed) and only the rest are
        answered by the rung, so an outage degrades lease by lease as TTLs
        run out. An expired or exhausted lease falls through to the rung.

        fed_shares: optional cluster/federation.py FederationCoordinator.
        The same discipline one level up: a descriptor whose (key, window)
        the cluster's share ledger covers (home budget this cluster owns,
        or an outstanding share another cluster's home pre-committed) is
        served from that global budget, so a cluster whose card fails keeps
        answering within its slice before the rung sees anything. Leases
        win over shares (they carry the card's own counters); an exhausted
        share falls through to the rung."""
        if mode not in FAILURE_MODES:
            raise ValueError(
                f"failure mode must be one of {FAILURE_MODES}, got {mode!r}"
            )
        self.mode = mode
        self._lease = lease_table
        self._fed = fed_shares
        self._lock = threading.Lock()
        self._degraded = False
        self._reason = ""
        self._g_degraded = None
        self._c_deny = self._c_allow = None
        if scope is not None:
            fb = scope.scope("fallback")
            self._g_degraded = fb.gauge("degraded")
            self._g_degraded.set(0)
            self._c_deny = fb.counter("deny")
            self._c_allow = fb.counter("allow")

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def degraded_reason(self) -> str | None:
        """None while healthy; a short reason string while degraded — the
        HealthChecker degraded-probe contract."""
        with self._lock:
            return self._reason if self._degraded else None

    def note_success(self) -> None:
        """Primary backend answered: leave the degraded state."""
        with self._lock:
            if not self._degraded:
                return
            self._degraded = False
            self._reason = ""
        if self._g_degraded is not None:
            self._g_degraded.set(0)
        logger.warning("backend recovered; leaving %s fallback", self.mode)

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
        error: Exception,
    ) -> DoLimitResponse:
        """Answer one request by fallback policy. Logs once per outage (on
        the transition into degraded), not once per request — a dead
        backend at service rates must not become a log storm."""
        with self._lock:
            entered = not self._degraded
            self._degraded = True
            self._reason = f"mode={self.mode}: {error}"
        if self._g_degraded is not None:
            self._g_degraded.set(1)
        if entered:
            logger.warning(
                "backend error (%s); degrading to failure mode %r",
                error,
                self.mode,
            )
        # lease-backed degradation (backends/lease.py): descriptors whose
        # (key, window) still holds an outstanding lease are answered from
        # that granted budget, consuming what the primary path would have,
        # so recovery continues the same counter
        lease_statuses: dict[int, DescriptorStatus] = {}
        lease_response = DoLimitResponse()
        if self._lease is not None:
            hits_addend = max(1, request.hits_addend)
            for i, descriptor in enumerate(request.descriptors):
                limit = limits[i] if i < len(limits) else None
                if limit is None:
                    continue
                status = self._lease.consume_for_fallback(
                    request.domain, descriptor, limit, hits_addend, lease_response
                )
                if status is not None:
                    lease_statuses[i] = status
        # federation-share degradation (cluster/federation.py): descriptors
        # the share ledger covers keep consuming global budget this cluster
        # already owns, so an outage degrades share by share, bounded by the
        # outstanding grants, before the rung answers; leases come first
        if self._fed is not None:
            hits_addend = max(1, request.hits_addend)
            for i, descriptor in enumerate(request.descriptors):
                if i in lease_statuses:
                    continue
                limit = limits[i] if i < len(limits) else None
                if limit is None:
                    continue
                status = self._fed.consume_for_fallback(
                    request.domain, descriptor, limit, hits_addend, lease_response
                )
                if status is not None:
                    lease_statuses[i] = status
        if self.mode == FAILURE_MODE_DENY:
            if self._c_deny is not None:
                self._c_deny.inc()
            code = Code.OVER_LIMIT
        else:
            if self._c_allow is not None:
                self._c_allow.inc()
            code = Code.OK
        statuses = []
        for i in range(len(request.descriptors)):
            status = lease_statuses.get(i)
            if status is not None:
                statuses.append(status)
                continue
            limit = limits[i] if i < len(limits) else None
            statuses.append(
                DescriptorStatus(
                    code=code,
                    current_limit=limit.limit if limit is not None else None,
                    limit_remaining=0,
                )
            )
        lease_response.descriptor_statuses = statuses
        return lease_response
