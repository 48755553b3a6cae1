"""Port of api_ratelimit_tpu/assertx.py (unchanged semantics).

Panic-style assertion helper.

Reference parity: src/assert/assert.go:8-16 (assert with caller location,
used for response-length parity at src/service/ratelimit.go:178 and
src/limiter/base_limiter.go:41).
"""

import inspect


class AssertionFailure(Exception):
    pass


def assert_(condition: bool, message: str = "assertion failed") -> None:
    """Raise AssertionFailure with the caller's location when condition is false.

    Unlike the built-in ``assert`` statement this is never stripped by -O and
    always carries file:line of the call site.
    """
    if condition:
        return
    frame = inspect.currentframe()
    caller = frame.f_back if frame is not None else None
    if caller is not None:
        loc = f"{caller.f_code.co_filename}:{caller.f_lineno}"
    else:  # pragma: no cover - CPython always has a caller frame here
        loc = "<unknown>"
    raise AssertionFailure(f"{loc}: {message}")
