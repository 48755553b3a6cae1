"""Port of api_ratelimit_tpu/utils/deadline.py (unchanged semantics).

Per-request deadline propagation (the Go context.Context deadline twin): a
contextvar holding the ABSOLUTE monotonic deadline, set by the transport for
the duration of one request and readable by any layer on the same thread of
execution. The service aborts a request that arrives already expired
(service/ratelimit.py), and the micro-batcher and the dispatch loop read it
at enqueue time and drop already-expired work before packing a device
launch (backends/batcher.py, backends/dispatch.py).

Monotonic clock only: deadlines are durations from "now", so they must be
immune to wall-clock steps.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

_DEADLINE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "request_deadline", default=None
)


def current_deadline() -> float | None:
    """The absolute ``time.monotonic()`` deadline of the current request,
    or None when the caller set none (no deadline == infinite)."""
    return _DEADLINE.get()


def time_remaining() -> float | None:
    """Seconds until the current deadline (may be negative once expired),
    or None when no deadline is set."""
    deadline = _DEADLINE.get()
    if deadline is None:
        return None
    return deadline - time.monotonic()


def expired() -> bool:
    """True when a deadline is set and has already passed."""
    deadline = _DEADLINE.get()
    return deadline is not None and time.monotonic() >= deadline


@contextlib.contextmanager
def deadline_scope(remaining_seconds: float | None):
    """Bind the current request's deadline for the duration of the block.

    ``remaining_seconds`` is the transport's view of time left. None means
    no deadline. A non-positive value is kept as an already-expired
    deadline so the layers below shed the work instead of answering late.
    """
    if remaining_seconds is None:
        yield
        return
    token = _DEADLINE.set(time.monotonic() + float(remaining_seconds))
    try:
        yield
    finally:
        _DEADLINE.reset(token)
