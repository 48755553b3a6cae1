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
(ratelimit.fallback.{deny,allow}). The reference's CircuitBreaker (for the
sidecar client) comes with item 8; its lease and federation-share
consultation before the rung with items 8 and 9.
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


class FallbackLimiter:
    """The degradation ladder the service consults on backend CacheError.

    Stats (under <scope>.fallback):
        deny / allow           requests answered by each rung (counters)
        degraded               1 while running on fallback policy (gauge;
                               sticky until the next primary success)
    """

    def __init__(self, mode: str, scope=None):
        """mode: deny or allow (FAILURE_MODES); scope roots the
        <scope>.fallback.* stats."""
        if mode not in FAILURE_MODES:
            raise ValueError(
                f"failure mode must be one of {FAILURE_MODES}, got {mode!r}"
            )
        self.mode = mode
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
            limit = limits[i] if i < len(limits) else None
            statuses.append(
                DescriptorStatus(
                    code=code,
                    current_limit=limit.limit if limit is not None else None,
                    limit_remaining=0,
                )
            )
        return DoLimitResponse(descriptor_statuses=statuses)
