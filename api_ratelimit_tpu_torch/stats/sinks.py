"""Port of the NullSink of api_ratelimit_tpu/stats/sinks.py.

The statsd and recording sinks wait for the slice that ports the runner;
the service and limiter record into a Store whose sink drops everything.
"""

from __future__ import annotations


class NullSink:
    def flush_counter(self, name: str, delta: int) -> None:
        pass

    def flush_gauge(self, name: str, value: int) -> None:
        pass

    def flush_timer(self, name: str, ms: float) -> None:
        pass

    def flush(self) -> None:
        pass
