"""Port of api_ratelimit_tpu/testing/fake_redis.py: an in-process fake Redis
— the miniredis analog (the reference's driver tests run against miniredis
the same way, test/redis/driver_impl_test.go:13-20). Beside the parsed
commands (commands_seen) it keeps each command's bytes exactly as they
arrived (wire), so two clients can be held to the same wire bytes.

A thread-per-connection TCP server speaking enough RESP2 for the backend
and its failure modes: AUTH (with optional required password), PING,
INCRBY, EXPIRE, GET, SET, DEL, FLUSHALL, plus SENTINEL
get-master-addr-by-name and a single-node CLUSTER SLOTS so the sentinel and
cluster topologies are testable without real fleets. Keys honor expiry via
a injectable clock. Not safe for production use — tests only.
"""

from __future__ import annotations

import atexit
import os
import shutil
import socket
import ssl
import subprocess
import tempfile
import threading
import time
from typing import Callable

_TLS_CERT_DIR: str | None = None
_tls_lock = threading.Lock()


def _self_signed_context() -> ssl.SSLContext:
    """Server-side TLS context with a lazily generated self-signed cert —
    the stand-in for the reference's stunnel TLS proxies (Makefile:50-61).
    One cert per process, cached on disk in a temp dir."""
    global _TLS_CERT_DIR
    with _tls_lock:
        if _TLS_CERT_DIR is None:
            d = tempfile.mkdtemp(prefix="fake-redis-tls-")
            atexit.register(shutil.rmtree, d, ignore_errors=True)
            subprocess.run(
                [
                    "openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-keyout", os.path.join(d, "key.pem"),
                    "-out", os.path.join(d, "cert.pem"),
                    "-days", "1", "-nodes", "-subj", "/CN=localhost",
                ],
                check=True,
                capture_output=True,
                timeout=60,
            )
            _TLS_CERT_DIR = d
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(
        os.path.join(_TLS_CERT_DIR, "cert.pem"),
        os.path.join(_TLS_CERT_DIR, "key.pem"),
    )
    return ctx


class FakeRedisServer:
    def __init__(
        self,
        password: str = "",
        clock: Callable[[], float] = time.time,
        sentinel_master: tuple[str, str, int] | None = None,
        tls: bool = False,
    ):
        """sentinel_master: (name, host, port) this instance reports when
        asked as a sentinel. tls wraps every accepted connection with a
        self-signed server cert (clients dial with verification off, like
        the reference's local stunnel setup)."""
        self._password = password
        self._clock = clock
        self._sentinel_master = sentinel_master
        self._tls_ctx = _self_signed_context() if tls else None
        self._data: dict[bytes, tuple[bytes, float | None]] = {}
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.commands_seen: list[list[bytes]] = []
        # each command's raw RESP bytes, in the order they were served
        self.wire: list[bytes] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fake-redis", daemon=True
        )
        self._accept_thread.start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    # -- data plane helpers for assertions --

    def get_int(self, key: str) -> int | None:
        with self._lock:
            entry = self._live(key.encode())
            return int(entry[0]) if entry else None

    def ttl(self, key: str) -> float | None:
        with self._lock:
            entry = self._live(key.encode())
            if entry is None or entry[1] is None:
                return None
            return entry[1] - self._clock()

    def get_int_prefix(self, prefix: str) -> int | None:
        """First live counter whose key starts with `prefix` — assertions
        don't need to reconstruct the window suffix."""
        p = prefix.encode()
        with self._lock:
            for k in list(self._data):
                if k.startswith(p):
                    entry = self._live(k)
                    if entry is not None:
                        return int(entry[0])
        return None

    def flushall(self) -> None:
        with self._lock:
            self._data.clear()

    def _live(self, key: bytes):
        entry = self._data.get(key)
        if entry is None:
            return None
        if entry[1] is not None and entry[1] <= self._clock():
            del self._data[key]
            return None
        return entry

    # -- server plumbing --

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
            # each reply goes out at once: without it a pipeline's second
            # reply waits out the client's delayed ACK (~40 ms a call)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        if self._tls_ctx is not None:
            # handshake on the connection thread so a bad client can't
            # stall the accept loop
            try:
                conn.settimeout(5.0)
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (OSError, ssl.SSLError):
                conn.close()
                return
        buf = b""
        got = bytearray()  # bytes received and not yet attributed to a command
        authed = not self._password
        try:
            while not self._stop.is_set():
                cmd, buf = self._read_command(conn, buf, got)
                if cmd is None:
                    return
                used = len(got) - len(buf)
                self.wire.append(bytes(got[:used]))
                del got[:used]
                self.commands_seen.append(cmd)
                name = cmd[0].upper()
                if name == b"AUTH":
                    if cmd[1].decode() == self._password:
                        authed = True
                        conn.sendall(b"+OK\r\n")
                    else:
                        conn.sendall(b"-ERR invalid password\r\n")
                    continue
                if not authed:
                    conn.sendall(b"-NOAUTH Authentication required.\r\n")
                    continue
                conn.sendall(self._execute(name, cmd[1:]))
        except OSError:
            pass
        finally:
            conn.close()

    def _read_command(self, conn, buf, got: bytearray):
        def read_line():
            nonlocal buf
            while b"\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    return None
                buf += chunk
                got.extend(chunk)
            line, buf = buf.split(b"\r\n", 1)
            return line

        line = read_line()
        if line is None:
            return None, buf
        if not line.startswith(b"*"):
            return None, buf  # inline commands unsupported
        n = int(line[1:])
        args = []
        for _ in range(n):
            header = read_line()
            if header is None or not header.startswith(b"$"):
                return None, buf
            size = int(header[1:])
            while len(buf) < size + 2:
                chunk = conn.recv(65536)
                if not chunk:
                    return None, buf
                buf += chunk
                got.extend(chunk)
            args.append(buf[:size])
            buf = buf[size + 2 :]
        return args, buf

    def _execute(self, name: bytes, args: list[bytes]) -> bytes:
        with self._lock:
            if name == b"PING":
                return b"+PONG\r\n"
            if name == b"INCRBY":
                key, delta = args[0], int(args[1])
                entry = self._live(key)
                value = int(entry[0]) + delta if entry else delta
                expire = entry[1] if entry else None
                self._data[key] = (b"%d" % value, expire)
                return b":%d\r\n" % value
            if name == b"EXPIRE":
                key, seconds = args[0], int(args[1])
                entry = self._live(key)
                if entry is None:
                    return b":0\r\n"
                self._data[key] = (entry[0], self._clock() + seconds)
                return b":1\r\n"
            if name == b"GET":
                entry = self._live(args[0])
                if entry is None:
                    return b"$-1\r\n"
                return b"$%d\r\n%s\r\n" % (len(entry[0]), entry[0])
            if name == b"SET":
                self._data[args[0]] = (args[1], None)
                return b"+OK\r\n"
            if name == b"DEL":
                removed = 0
                for key in args:
                    if self._live(key) is not None:
                        del self._data[key]
                        removed += 1
                return b":%d\r\n" % removed
            if name == b"FLUSHALL":
                self._data.clear()
                return b"+OK\r\n"
            if name == b"SENTINEL":
                if (
                    self._sentinel_master
                    and args
                    and args[0].lower() == b"get-master-addr-by-name"
                    and args[1].decode() == self._sentinel_master[0]
                ):
                    _, host, port = self._sentinel_master
                    h, p = host.encode(), str(port).encode()
                    return (
                        b"*2\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
                        % (len(h), h, len(p), p)
                    )
                return b"*-1\r\n"
            if name == b"CLUSTER":
                if args and args[0].upper() == b"SLOTS":
                    # single node owning all slots
                    host = b"127.0.0.1"
                    return (
                        b"*1\r\n*3\r\n:0\r\n:16383\r\n*2\r\n$%d\r\n%s\r\n:%d\r\n"
                        % (len(host), host, self.port)
                    )
                return b"-ERR unknown CLUSTER subcommand\r\n"
            return b"-ERR unknown command '%s'\r\n" % name
