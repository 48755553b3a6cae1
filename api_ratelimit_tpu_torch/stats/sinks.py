"""Port of api_ratelimit_tpu/stats/sinks.py: stat sinks (statsd over UDP,
null, and a recording test sink).

The statsd wire format matches what lyft/gostats emits, so the reference's
prom-statsd-exporter mapping works unchanged. The runner picks StatsdSink
when USE_STATSD is true (the default) and NullSink otherwise.
"""

from __future__ import annotations

import socket
import threading
from typing import Protocol


class Sink(Protocol):
    def flush_counter(self, name: str, delta: int) -> None: ...
    def flush_gauge(self, name: str, value: int) -> None: ...
    def flush_timer(self, name: str, ms: float) -> None: ...
    def flush(self) -> None: ...


class NullSink:
    def flush_counter(self, name: str, delta: int) -> None:
        pass

    def flush_gauge(self, name: str, value: int) -> None:
        pass

    def flush_timer(self, name: str, ms: float) -> None:
        pass

    def flush(self) -> None:
        pass


class TestSink:
    """Records the latest flushed values by stat name
    (test/common/common.go:22-42 equivalent)."""

    __test__ = False  # not a pytest class

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, int] = {}
        self.timers: dict[str, list[float]] = {}
        self.histograms: dict[str, dict] = {}
        self._lock = threading.Lock()

    def flush_counter(self, name: str, delta: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def flush_gauge(self, name: str, value: int) -> None:
        with self._lock:
            self.gauges[name] = value

    def flush_timer(self, name: str, ms: float) -> None:
        with self._lock:
            self.timers.setdefault(name, []).append(ms)

    def flush_histogram(self, name: str, snapshot: dict) -> None:
        with self._lock:
            self.histograms[name] = snapshot

    def flush(self) -> None:
        pass


def format_statsd_ms(ms: float) -> str:
    """Fixed-point millisecond value for a statsd '|ms' line.

    `{ms:g}` emits exponential notation below 1e-4 (e.g. `1e-05`), which
    statsd line parsers reject — sub-microsecond timings then poison the
    whole datagram. Clamp to fixed-point with enough places for ns
    resolution, then strip trailing zeros so common values stay compact
    (1.5, not 1.500000)."""
    out = f"{ms:.9f}".rstrip("0").rstrip(".")
    return out or "0"


class StatsdSink:
    """Plain-UDP statsd sink with datagram batching.

    Lines are accumulated and sent in <=1400-byte datagrams at flush() —
    one syscall per packet instead of per stat.
    """

    MAX_DATAGRAM = 1400

    def __init__(self, host: str = "localhost", port: int = 8125, prefix: str = ""):
        self._addr = (host, port)
        self._prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._buf: list[str] = []
        self._buf_len = 0
        self._lock = threading.Lock()

    def _emit(self, line: str) -> None:
        with self._lock:
            if self._buf_len + len(line) + 1 > self.MAX_DATAGRAM and self._buf:
                self._send_locked()
            self._buf.append(line)
            self._buf_len += len(line) + 1

    def _send_locked(self) -> None:
        payload = "\n".join(self._buf).encode()
        self._buf = []
        self._buf_len = 0
        self._send(payload)

    def _send(self, payload: bytes) -> None:
        try:
            self._sock.sendto(payload, self._addr)
        except OSError:
            pass  # stats are best-effort

    def _name(self, name: str) -> str:
        return f"{self._prefix}.{name}" if self._prefix else name

    def flush_counter(self, name: str, delta: int) -> None:
        self._emit(f"{self._name(name)}:{delta}|c")

    def flush_gauge(self, name: str, value: int) -> None:
        self._emit(f"{self._name(name)}:{value}|g")

    def flush_timer(self, name: str, ms: float) -> None:
        self._emit(f"{self._name(name)}:{format_statsd_ms(ms)}|ms")

    def flush(self) -> None:
        with self._lock:
            if self._buf:
                self._send_locked()
