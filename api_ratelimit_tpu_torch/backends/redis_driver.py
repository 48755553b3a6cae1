"""Port of api_ratelimit_tpu/backends/redis_driver.py (stdlib sockets and
ssl; unchanged): the Redis driver, a RESP wire client with pooling and
pipelining.

From-scratch equivalent of the radix/v3 wrapper in src/redis/driver_impl.go:
dial with auth/TLS options (:60-78), a connection pool with lifecycle stats
(:17-42, gauges cx_active/cx_total/cx_local_close), startup PING fail-fast
(:124-128), explicit one-RTT pipelines and optional implicit cross-request
pipelining governed by window/limit knobs (:84-90, :149-164). Errors raise
RedisError (a CacheError), which the service boundary counts and surfaces
(driver_impl.go:50-54).

Topologies (driver_impl.go:101-119): "single" connects directly; "sentinel"
resolves the master via SENTINEL GET-MASTER-ADDR-BY-NAME then connects
single; "cluster" uses client-side CRC16 slot routing with MOVED redirect
handling.

The protocol layer speaks RESP2: commands go as arrays of bulk strings;
replies are simple strings, errors, integers, bulk strings, or arrays.
"""

from __future__ import annotations

import socket
import ssl
import threading
from typing import Iterable, Sequence

from ..limiter.cache import CacheError


class RedisError(CacheError):
    pass


Command = tuple  # ("INCRBY", key, hits) — str/int/bytes operands


def encode_commands(commands: Sequence[Command]) -> bytes:
    """RESP array-of-bulk-strings encoding, all commands in one buffer."""
    out = bytearray()
    for cmd in commands:
        out += b"*%d\r\n" % len(cmd)
        for arg in cmd:
            if isinstance(arg, bytes):
                data = arg
            elif isinstance(arg, str):
                data = arg.encode()
            elif isinstance(arg, int):
                data = b"%d" % arg
            else:
                raise TypeError(f"bad redis argument type: {type(arg)!r}")
            out += b"$%d\r\n%s\r\n" % (len(data), data)
    return bytes(out)


class _Reader:
    """Buffered RESP reply parser over a socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _read_line(self) -> bytes:
        while True:
            idx = self._buf.find(b"\r\n")
            if idx >= 0:
                line, self._buf = self._buf[:idx], self._buf[idx + 2 :]
                return line
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed by redis")
            self._buf += chunk

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed by redis")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    # Redis's own proto-max-bulk-len default; a corrupt length past this
    # must be a protocol error, not a multi-GB buffering attempt.
    _MAX_BULK = 512 << 20

    @staticmethod
    def _parse_len(rest: bytes) -> int:
        """Corrupt wire bytes must surface as RedisError (counted at the
        service boundary like any backend failure), never as a raw
        ValueError escaping the pool."""
        try:
            return int(rest)
        except ValueError:
            raise RedisError(f"bad RESP length: {rest!r}") from None

    def read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode(errors="replace")
        if kind == b"-":
            return RedisReplyError(rest.decode(errors="replace"))
        if kind == b":":
            return self._parse_len(rest)
        if kind == b"$":
            n = self._parse_len(rest)
            if n == -1:
                return None
            if n < 0 or n > self._MAX_BULK:
                raise RedisError(f"bad RESP bulk length: {n}")
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = self._parse_len(rest)
            if n == -1:
                return None
            if n < 0 or n > 1 << 20:
                raise RedisError(f"bad RESP array length: {n}")
            return [self.read_reply() for _ in range(n)]
        raise RedisError(f"bad RESP reply type: {line!r}")


class RedisReplyError(Exception):
    """A -ERR reply for one command; carried per-command, raised by callers
    that treat command errors as fatal."""


def _dial(
    socket_type: str,
    url: str,
    auth: str = "",
    use_tls: bool = False,
    timeout: float = 5.0,
) -> socket.socket:
    """Dial options (driver_impl.go:60-78): socket type tcp|unix, optional
    TLS wrap, optional AUTH."""
    if socket_type == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(url)
    elif socket_type == "tcp":
        host, _, port = url.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if use_tls:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            sock = ctx.wrap_socket(sock, server_hostname=host)
    else:
        raise RedisError(f"bad redis socket type: {socket_type!r}")
    if auth:
        conn = _Conn(sock)
        reply = conn.do([("AUTH", auth)])[0]
        if isinstance(reply, RedisReplyError):
            sock.close()
            raise RedisError(f"redis auth failed: {reply}")
        return sock
    return sock


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.reader = _Reader(sock)

    def do(self, commands: Sequence[Command]) -> list:
        """One RTT: write all commands, read all replies."""
        self.sock.sendall(encode_commands(commands))
        return [self.reader.read_reply() for _ in commands]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class PoolStats:
    """cx_active / cx_total / cx_local_close gauges (driver_impl.go:17-29)."""

    def __init__(self, scope):
        self.active = scope.gauge("cx_active")
        self.total = scope.gauge("cx_total")
        self.local_close = scope.gauge("cx_local_close")


class ConnectionPool:
    """Fixed-size lazy pool. Broken connections are discarded and re-dialed
    (the radix pool re-dials the same way)."""

    def __init__(
        self,
        socket_type: str,
        url: str,
        pool_size: int,
        auth: str = "",
        use_tls: bool = False,
        stats: PoolStats | None = None,
    ):
        self._dial_args = (socket_type, url, auth, use_tls)
        self._size = max(1, pool_size)
        self._idle: list[_Conn] = []
        self._lock = threading.Lock()
        self._created = 0
        self._cond = threading.Condition(self._lock)
        self._stats = stats

    def _new_conn(self) -> _Conn:
        socket_type, url, auth, use_tls = self._dial_args
        try:
            conn = _Conn(_dial(socket_type, url, auth, use_tls))
        except OSError as e:
            raise RedisError(f"redis dial failed: {e}") from e
        if self._stats:
            self._stats.total.add(1)
        return conn

    def checkout(self) -> _Conn:
        with self._cond:
            while True:
                if self._idle:
                    conn = self._idle.pop()
                    break
                if self._created < self._size:
                    self._created += 1
                    conn = None
                    break
                self._cond.wait(timeout=5.0)
        if conn is None:
            try:
                conn = self._new_conn()
            except Exception:
                with self._cond:
                    self._created -= 1
                    self._cond.notify()
                raise
        if self._stats:
            self._stats.active.add(1)
        return conn

    def checkin(self, conn: _Conn, broken: bool = False) -> None:
        if self._stats:
            self._stats.active.sub(1)
        with self._cond:
            if broken:
                conn.close()
                self._created -= 1
                if self._stats:
                    self._stats.total.sub(1)
                    self._stats.local_close.add(1)
            else:
                self._idle.append(conn)
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            for conn in self._idle:
                conn.close()
            self._idle.clear()

    def num_active_conns(self) -> int:
        with self._lock:
            return self._created


class _ImplicitPipeliner:
    """Cross-request command coalescing (implicit pipelining,
    driver_impl.go:84-90): callers enqueue (commands, future); a flusher
    drains the queue when the window elapses or the batch limit is reached,
    issuing everything as one RTT. The window/limit knobs are
    REDIS_PIPELINE_WINDOW / REDIS_PIPELINE_LIMIT."""

    def __init__(self, pool: ConnectionPool, window_seconds: float, limit: int):
        self._pool = pool
        self._window = window_seconds
        self._limit = limit if limit > 0 else 1 << 30
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._queue: list[tuple[Sequence[Command], "_Result"]] = []
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="redis-pipeline", daemon=True
        )
        self._thread.start()

    def submit(self, commands: Sequence[Command]) -> "_Result":
        result = _Result(len(commands))
        with self._lock:
            self._queue.append((commands, result))
            should_wake = sum(len(c) for c, _ in self._queue) >= self._limit
        if should_wake:
            self._wake.set()
        return result

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self._window)
            self._wake.clear()
            with self._lock:
                batch, self._queue = self._queue, []
            if not batch:
                continue
            flat: list[Command] = []
            for commands, _ in batch:
                flat.extend(commands)
            try:
                replies = _pool_do(self._pool, flat)
            except Exception as e:  # deliver the failure to every waiter
                for _, result in batch:
                    result.set_error(e)
                continue
            offset = 0
            for commands, result in batch:
                result.set(replies[offset : offset + len(commands)])
                offset += len(commands)

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2.0)


class _Result:
    def __init__(self, n: int):
        self._event = threading.Event()
        self._replies: list | None = None
        self._error: Exception | None = None
        self.n = n

    def set(self, replies: list) -> None:
        self._replies = replies
        self._event.set()

    def set_error(self, error: Exception) -> None:
        self._error = error
        self._event.set()

    def get(self, timeout: float = 30.0) -> list:
        if not self._event.wait(timeout):
            raise RedisError("redis pipeline timed out")
        if self._error is not None:
            raise self._error
        return self._replies


def _pool_do(pool: ConnectionPool, commands: Sequence[Command]) -> list:
    conn = pool.checkout()
    try:
        replies = conn.do(commands)
    except (OSError, RedisError) as e:
        pool.checkin(conn, broken=True)
        raise RedisError(f"redis pipeline failed: {e}") from e
    pool.checkin(conn)
    return replies


class RedisClient:
    """The narrow driver verb set (src/redis/driver.go:13-47): do_cmd,
    pipe_do, close, num_active_conns, implicit_pipelining_enabled."""

    def __init__(
        self,
        socket_type: str,
        url: str,
        pool_size: int = 10,
        auth: str = "",
        use_tls: bool = False,
        pipeline_window_seconds: float = 0.0,
        pipeline_limit: int = 0,
        stats_scope=None,
        redis_type: str = "SINGLE",
    ):
        stats = PoolStats(stats_scope) if stats_scope is not None else None
        redis_type = redis_type.upper()
        if redis_type == "SENTINEL":
            socket_type, url = _resolve_sentinel(socket_type, url, auth, use_tls)
        elif redis_type == "CLUSTER":
            # handled by RedisClusterClient; RedisClient is a single-node path
            raise RedisError("use RedisClusterClient for cluster topology")
        elif redis_type != "SINGLE":
            raise RedisError(f"bad redis type: {redis_type!r}")
        self._pool = ConnectionPool(socket_type, url, pool_size, auth, use_tls, stats)
        # implicit pipelining iff both knobs set (driver_impl.go:84-90)
        self._pipeliner = None
        if pipeline_window_seconds > 0 and pipeline_limit > 0:
            self._pipeliner = _ImplicitPipeliner(
                self._pool, pipeline_window_seconds, pipeline_limit
            )
        # startup health check (driver_impl.go:124-128)
        reply = self.do_cmd("PING")
        if reply != "PONG":
            raise RedisError(f"redis ping failed: {reply!r}")

    def implicit_pipelining_enabled(self) -> bool:
        return self._pipeliner is not None

    def do_cmd(self, *cmd):
        reply = _pool_do(self._pool, [tuple(cmd)])[0]
        if isinstance(reply, RedisReplyError):
            raise RedisError(str(reply))
        return reply

    def pipe_do(self, commands: Sequence[Command]) -> list:
        """Execute a batch in one RTT (or via the implicit pipeliner when
        enabled). Raises RedisError if any command errored."""
        if not commands:
            return []
        if self._pipeliner is not None:
            replies = self._pipeliner.submit(commands).get()
        else:
            replies = _pool_do(self._pool, commands)
        for reply in replies:
            if isinstance(reply, RedisReplyError):
                raise RedisError(str(reply))
        return replies

    def num_active_conns(self) -> int:
        return self._pool.num_active_conns()

    def close(self) -> None:
        if self._pipeliner is not None:
            self._pipeliner.stop()
        self._pool.close()


def crc16(data: bytes) -> int:
    """CRC16-CCITT (XModem) — redis cluster's key->slot hash."""
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
    return crc


def key_slot(key: str | bytes) -> int:
    """Hash slot for a key, honoring {hash tags}."""
    data = key.encode() if isinstance(key, str) else key
    start = data.find(b"{")
    if start >= 0:
        end = data.find(b"}", start + 1)
        if end > start + 1:
            data = data[start + 1 : end]
    return crc16(data) % 16384


class RedisClusterClient:
    """CLUSTER topology (driver_impl.go:104-110 — radix does the same
    client-side): CLUSTER SLOTS discovery from seed nodes, per-node pools,
    commands grouped by key slot, MOVED redirects refresh the slot map and
    retry once. The reference requires implicit pipelining in cluster mode
    (driver_impl.go:106-110); here per-node grouping already batches each
    node's commands into one RTT, so the pipeliner knobs are optional."""

    def __init__(
        self,
        url: str,
        pool_size: int = 10,
        auth: str = "",
        use_tls: bool = False,
        stats_scope=None,
    ):
        self._seeds = [p.strip() for p in url.split(",") if p.strip()]
        if not self._seeds:
            raise RedisError("cluster url must list seed host:port nodes")
        self._auth = auth
        self._use_tls = use_tls
        self._pool_size = pool_size
        self._stats_scope = stats_scope
        self._pools: dict[str, ConnectionPool] = {}
        self._slots: list[tuple[int, int, str]] = []  # (start, end, addr)
        self._lock = threading.Lock()
        self._refresh_topology()
        self.do_cmd("PING")

    def _pool_for(self, addr: str) -> ConnectionPool:
        with self._lock:
            pool = self._pools.get(addr)
            if pool is None:
                stats = (
                    PoolStats(self._stats_scope.scope(addr.replace(":", "_")))
                    if self._stats_scope is not None
                    else None
                )
                pool = ConnectionPool(
                    "tcp", addr, self._pool_size, self._auth, self._use_tls, stats
                )
                self._pools[addr] = pool
            return pool

    def _refresh_topology(self) -> None:
        last_error: Exception | None = None
        for seed in self._seeds:
            try:
                reply = _pool_do(self._pool_for(seed), [("CLUSTER", "SLOTS")])[0]
            except (RedisError, OSError) as e:
                last_error = e
                continue
            if isinstance(reply, RedisReplyError):
                last_error = RedisError(str(reply))
                continue
            slots = []
            for entry in reply:
                start, end, master = entry[0], entry[1], entry[2]
                host = master[0].decode()
                port = int(master[1])
                slots.append((int(start), int(end), f"{host}:{port}"))
            with self._lock:
                self._slots = slots
            return
        raise RedisError(f"cluster topology refresh failed: {last_error}")

    def _addr_for_slot(self, slot: int) -> str:
        with self._lock:
            for start, end, addr in self._slots:
                if start <= slot <= end:
                    return addr
        raise RedisError(f"no cluster node covers slot {slot}")

    def implicit_pipelining_enabled(self) -> bool:
        return True  # per-node grouping batches cross-request commands

    def do_cmd(self, *cmd):
        return self.pipe_do([tuple(cmd)])[0]

    def pipe_do(self, commands: Sequence[Command]) -> list:
        if not commands:
            return []
        replies: list = [None] * len(commands)
        by_node: dict[str, list[int]] = {}
        for i, cmd in enumerate(commands):
            if len(cmd) > 1:
                addr = self._addr_for_slot(key_slot(cmd[1]))
            else:  # keyless (PING): any node
                addr = self._addr_for_slot(0)
            by_node.setdefault(addr, []).append(i)
        for addr, indices in by_node.items():
            node_replies = _pool_do(self._pool_for(addr), [commands[i] for i in indices])
            for i, reply in zip(indices, node_replies):
                if isinstance(reply, RedisReplyError) and str(reply).startswith(
                    "MOVED "
                ):
                    # slot migrated: refresh and retry this command once
                    self._refresh_topology()
                    new_addr = str(reply).split()[2]
                    reply = _pool_do(self._pool_for(new_addr), [commands[i]])[0]
                if isinstance(reply, RedisReplyError):
                    raise RedisError(str(reply))
                replies[i] = reply
        return replies

    def num_active_conns(self) -> int:
        with self._lock:
            return sum(p.num_active_conns() for p in self._pools.values())

    def close(self) -> None:
        with self._lock:
            for pool in self._pools.values():
                pool.close()


def _resolve_sentinel(
    socket_type: str, url: str, auth: str, use_tls: bool
) -> tuple[str, str]:
    """SENTINEL topology (driver_impl.go:111-116): url is
    "<master-name>,<sentinel1 host:port>,<sentinel2>..."; ask the first
    reachable sentinel for the master address."""
    parts = [p.strip() for p in url.split(",") if p.strip()]
    if len(parts) < 2:
        raise RedisError(
            "sentinel url must be master-name,host:port[,host:port...]"
        )
    master_name, sentinels = parts[0], parts[1:]
    last_error: Exception | None = None
    for addr in sentinels:
        try:
            conn = _Conn(_dial("tcp", addr, auth="", use_tls=False))
            try:
                reply = conn.do(
                    [("SENTINEL", "get-master-addr-by-name", master_name)]
                )[0]
            finally:
                conn.close()
        except (OSError, RedisError) as e:
            last_error = e
            continue
        if isinstance(reply, list) and len(reply) == 2:
            host = reply[0].decode()
            port = reply[1].decode()
            return "tcp", f"{host}:{port}"
        last_error = RedisError(f"sentinel has no master {master_name!r}: {reply!r}")
    raise RedisError(f"no sentinel reachable: {last_error}")
