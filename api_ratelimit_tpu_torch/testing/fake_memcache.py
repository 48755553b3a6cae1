"""Port of api_ratelimit_tpu/testing/fake_memcache.py: an in-process fake
memcached (text protocol) for hermetic backend tests — the memcache twin of
fake_redis.py. Supports get (multi-key), incr, add, flush_all, with expiry
via an injectable clock, plus failure injection for the add/increment race
tests (test/memcached/cache_impl_test.go:542+). Beside the command lines
(commands_seen) it keeps each command's bytes exactly as they arrived
(wire: the line, and an add's data block)."""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable


class FakeMemcacheServer:
    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._data: dict[bytes, tuple[int, float | None]] = {}
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self.commands_seen: list[bytes] = []
        # each command's raw bytes, in the order they were served
        self.wire: list[bytes] = []
        # test hook: when set, the next `add` answers NOT_STORED even if the
        # key is absent (simulates losing the add race)
        self.force_not_stored_once = False
        threading.Thread(
            target=self._accept_loop, name="fake-memcache", daemon=True
        ).start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def get_int(self, key: str) -> int | None:
        with self._lock:
            entry = self._live(key.encode())
            return entry[0] if entry else None

    def set_int(self, key: str, value: int) -> None:
        with self._lock:
            self._data[key.encode()] = (value, None)

    def _live(self, key: bytes):
        entry = self._data.get(key)
        if entry is None:
            return None
        if entry[1] is not None and entry[1] <= self._clock():
            del self._data[key]
            return None
        return entry

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        buf = b""
        try:
            while not self._stop.is_set():
                while b"\r\n" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                line, buf = buf.split(b"\r\n", 1)
                self.commands_seen.append(line)
                parts = line.split()
                if not parts:
                    continue
                raw = line + b"\r\n"
                verb = parts[0]
                if verb != b"add":
                    self.wire.append(raw)
                if verb == b"get":
                    out = b""
                    with self._lock:
                        for key in parts[1:]:
                            entry = self._live(key)
                            if entry is not None:
                                data = b"%d" % entry[0]
                                out += b"VALUE %s 0 %d\r\n%s\r\n" % (
                                    key,
                                    len(data),
                                    data,
                                )
                    conn.sendall(out + b"END\r\n")
                elif verb == b"incr":
                    key, delta = parts[1], int(parts[2])
                    with self._lock:
                        entry = self._live(key)
                        if entry is None:
                            conn.sendall(b"NOT_FOUND\r\n")
                        else:
                            value = entry[0] + delta
                            self._data[key] = (value, entry[1])
                            conn.sendall(b"%d\r\n" % value)
                elif verb == b"add":
                    key, _flags, exptime, size = (
                        parts[1],
                        parts[2],
                        int(parts[3]),
                        int(parts[4]),
                    )
                    while len(buf) < size + 2:
                        chunk = conn.recv(65536)
                        if not chunk:
                            return
                        buf += chunk
                    data, buf = buf[:size], buf[size + 2 :]
                    self.wire.append(raw + data + b"\r\n")
                    with self._lock:
                        if self.force_not_stored_once:
                            self.force_not_stored_once = False
                            self._data.setdefault(
                                key, (0, self._expiry(exptime))
                            )
                            conn.sendall(b"NOT_STORED\r\n")
                        elif self._live(key) is not None:
                            conn.sendall(b"NOT_STORED\r\n")
                        else:
                            self._data[key] = (int(data), self._expiry(exptime))
                            conn.sendall(b"STORED\r\n")
                elif verb == b"flush_all":
                    with self._lock:
                        self._data.clear()
                    conn.sendall(b"OK\r\n")
                else:
                    conn.sendall(b"ERROR\r\n")
        except OSError:
            pass
        finally:
            conn.close()

    def _expiry(self, exptime: int) -> float | None:
        return self._clock() + exptime if exptime > 0 else None
