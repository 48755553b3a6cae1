"""Port of api_ratelimit_tpu/backends/overload.py: overload admission control.

Two shed triggers, one policy:

    QueueFullError      the micro-batcher's / dispatch loop's hard
                        OVERLOAD_MAX_QUEUE bound
    BrownoutError       the latency brownout: EWMA of batcher queue wait
                        crossed OVERLOAD_BROWNOUT_TARGET_MS (hysteresis:
                        exits below OVERLOAD_BROWNOUT_EXIT_MS)

Both subclass OverloadError (itself a CacheError, so layers that only know
the generic failure contract stay safe). The service maps a shed to the
configured posture (OVERLOAD_SHED_MODE, service/ratelimit.py _shed_answer):

    unavailable  the error surfaces as gRPC UNAVAILABLE / HTTP 503
                 (retriable by Envoy), the default
    allow        fail open: OK plus an `x-ratelimit-shed` header
    deny         OVER_LIMIT for every descriptor

The shed state is sticky until the next normally-admitted request, and is
exported through the `overload.*` stats and the /healthcheck degraded body.
"""

from __future__ import annotations

import logging
import threading

from ..limiter.cache import CacheError

logger = logging.getLogger("ratelimit.overload")

SHED_MODE_UNAVAILABLE = "unavailable"
SHED_MODE_ALLOW = "allow"
SHED_MODE_DENY = "deny"
SHED_MODES = (SHED_MODE_UNAVAILABLE, SHED_MODE_ALLOW, SHED_MODE_DENY)


class OverloadError(CacheError):
    """Request shed by admission control (not a backend failure). `token`
    is the short cause tag the reference carries in the `x-ratelimit-shed`
    response header."""

    token = "overload"


class QueueFullError(OverloadError):
    """The micro-batcher queue is at its hard OVERLOAD_MAX_QUEUE bound."""

    token = "queue_full"


class BrownoutError(OverloadError):
    """The latency brownout is active: queue-wait EWMA over target."""

    token = "brownout"


class AdmissionController:
    """One per process: owns the brownout signal, the shed policy, and the
    `overload.*` stats.

    Hot-path cost by design: admitted requests touch one boolean read
    (`should_shed`) plus, in windowed batching, one EWMA update per batch
    take (not per item). The stats work happens only on sheds and state
    transitions.

    Stats (under <scope>.overload):
        shed               requests shed by admission control (counter)
        queue_full         sheds from the hard queue bound (counter)
        brownout_shed      sheds from the latency brownout (counter)
        deadline_expired   items dropped after their deadline (counter)
        sleep_shed         throttle sleeps skipped under drain/overload
                           (counter; counted by the service)
        brownout           1 while the brownout is active (gauge)
        shedding           1 while the shed state is sticky (gauge)
        queue_wait_ewma_us EWMA of batcher queue wait, microseconds (gauge)
    """

    def __init__(
        self,
        shed_mode: str = SHED_MODE_UNAVAILABLE,
        max_queue: int = 0,
        brownout_target_ms: float = 0.0,
        brownout_exit_ms: float = 0.0,
        ewma_alpha: float = 0.2,
        scope=None,
    ):
        if shed_mode not in SHED_MODES:
            raise ValueError(
                f"shed mode must be one of {SHED_MODES}, got {shed_mode!r}"
            )
        self.shed_mode = shed_mode
        self.max_queue = int(max_queue)
        self._target_ms = float(brownout_target_ms)
        self._exit_ms = float(brownout_exit_ms) or self._target_ms / 2.0
        if self._target_ms > 0 and self._exit_ms >= self._target_ms:
            raise ValueError(
                f"brownout exit threshold ({self._exit_ms}ms) must sit below "
                f"the enter target ({self._target_ms}ms) for hysteresis"
            )
        self._alpha = float(ewma_alpha)
        if not 0.0 < self._alpha <= 1.0:
            raise ValueError(f"ewma alpha must be in (0, 1], got {ewma_alpha}")
        self._lock = threading.Lock()
        self._ewma_ms = 0.0
        # lock-free fast-path flags: single attribute reads on the hot path;
        # transitions happen under the lock
        self._brownout = False
        self._shedding = False
        self._shed_reason = ""
        self._c_shed = self._c_sleep_shed = self._c_deadline = None
        self._c_kind = {}
        self._g_brownout = self._g_shedding = self._g_ewma = None
        if scope is not None:
            ov = scope.scope("overload")
            self._c_shed = ov.counter("shed")
            self._c_kind = {
                QueueFullError: ov.counter("queue_full"),
                BrownoutError: ov.counter("brownout_shed"),
            }
            self._c_deadline = ov.counter("deadline_expired")
            self._c_sleep_shed = ov.counter("sleep_shed")
            self._g_brownout = ov.gauge("brownout")
            self._g_brownout.set(0)
            self._g_shedding = ov.gauge("shedding")
            self._g_shedding.set(0)
            self._g_ewma = ov.gauge("queue_wait_ewma_us")

    # -- brownout signal (fed by the micro-batcher / dispatch loop) --

    @property
    def brownout(self) -> bool:
        return self._brownout

    @property
    def queue_wait_ewma_ms(self) -> float:
        return self._ewma_ms

    def observe_queue_wait(self, ms: float) -> None:
        """EWMA update + hysteresis. Called once per batch take (windowed
        mode) or per submit (direct mode)."""
        if self._target_ms <= 0:
            return
        with self._lock:
            self._ewma_ms += self._alpha * (float(ms) - self._ewma_ms)
            ewma = self._ewma_ms
            if not self._brownout and ewma > self._target_ms:
                self._brownout = True
                logger.warning(
                    "entering brownout: queue_wait ewma %.2fms > target %.2fms",
                    ewma,
                    self._target_ms,
                )
                if self._g_brownout is not None:
                    self._g_brownout.set(1)
            elif self._brownout and ewma < self._exit_ms:
                self._brownout = False
                logger.warning(
                    "leaving brownout: queue_wait ewma %.2fms < exit %.2fms",
                    ewma,
                    self._exit_ms,
                )
                if self._g_brownout is not None:
                    self._g_brownout.set(0)
        if self._g_ewma is not None:
            self._g_ewma.set(int(ewma * 1000.0))

    def should_shed(self) -> bool:
        """The cheap pre-dispatch admission check: True while the brownout
        is active. One attribute read on the admitted path."""
        return self._brownout

    # -- shed bookkeeping --

    def note_shed(self, error: OverloadError) -> None:
        """Count one shed request and make the state sticky until the next
        normally-admitted answer (note_ok). Logged once per episode."""
        if self._c_shed is not None:
            self._c_shed.inc()
            counter = self._c_kind.get(type(error))
            if counter is not None:
                counter.inc()
        with self._lock:
            entered = not self._shedding
            self._shedding = True
            self._shed_reason = f"{type(error).__name__}: {error}"
        if self._g_shedding is not None:
            self._g_shedding.set(1)
        if entered:
            logger.warning(
                "overload: shedding by policy %r (%s)", self.shed_mode, error
            )

    def note_deadline_expired(self, n: int = 1) -> None:
        if self._c_deadline is not None:
            self._c_deadline.add(n)

    def note_sleep_shed(self) -> None:
        if self._c_sleep_shed is not None:
            self._c_sleep_shed.inc()

    def note_ok(self) -> None:
        """A request was admitted and answered normally: clear the sticky
        shed state. Lock-free no-op on the common (healthy) path."""
        if not self._shedding:
            return
        with self._lock:
            if not self._shedding:
                return
            self._shedding = False
            self._shed_reason = ""
        if self._g_shedding is not None:
            self._g_shedding.set(0)
        logger.warning("overload: load admitted normally again; shed state clear")

    def degraded_reason(self) -> str | None:
        """Degraded-probe contract: None while healthy, a short reason
        while shedding or browned out."""
        if self._brownout:
            return (
                f"overload brownout: queue_wait ewma "
                f"{self._ewma_ms:.1f}ms > {self._target_ms:.1f}ms "
                f"(shed mode {self.shed_mode})"
            )
        if self._shedding:
            with self._lock:
                reason = self._shed_reason
            if reason:
                return f"overload shed ({self.shed_mode}): {reason}"
        return None
