"""Port of api_ratelimit_tpu/backends/memcache.py (unchanged): the memcache
parity backend, read-now, increment-async.

Mirror of src/memcached/cache_impl.go: one read RTT (`get` multi, :95-100)
decides every descriptor from the fetched values with after = before + hits
(:102-122); the increments run asynchronously (:124-125) via the
add/increment dance — Increment, on miss Add(value=hits, expiry=unit+jitter),
on add race Increment again (:130-168, dance documented at :1-14). flush()
joins the async work (:170-172) — tests use it; production accepts the
eventual consistency (brief over-admission), exactly like the reference
(README.md:567-568).

The client speaks the memcached text protocol over a pooled TCP connection
set; the 250-char key limit is memcached's own (client.go:13-14).
"""

from __future__ import annotations

import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from ..limiter.base_limiter import BaseRateLimiter, LimitInfo
from ..limiter.cache import CacheError
from ..models.config import RateLimit
from ..models.descriptors import RateLimitRequest
from ..models.response import DescriptorStatus, DoLimitResponse
from ..models.units import unit_to_divider
from ..tracing import tag_do_limit_start

MAX_KEY_LENGTH = 250


class MemcacheError(CacheError):
    pass


class NotFoundError(MemcacheError):
    """Increment on a missing key (ErrCacheMiss)."""


class NotStoredError(MemcacheError):
    """Add on an existing key (ErrNotStored) — the add/increment race."""


class MemcacheClient:
    """GetMulti / Increment / Add — the narrow verb set the backend needs
    (src/memcached/client.go:10-14)."""

    def __init__(self, host_port: str, pool_size: int = 4, timeout: float = 5.0):
        self._addr = host_port
        self._timeout = timeout
        self._pool_size = max(1, pool_size)
        self._idle: list[socket.socket] = []
        self._lock = threading.Lock()

    def _dial(self) -> socket.socket:
        host, _, port = self._addr.rpartition(":")
        try:
            sock = socket.create_connection((host, int(port)), timeout=self._timeout)
        except OSError as e:
            raise MemcacheError(f"memcache dial failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return self._dial()

    def _checkin(self, sock: socket.socket, broken: bool = False) -> None:
        if not broken:
            with self._lock:
                if len(self._idle) < self._pool_size:
                    self._idle.append(sock)
                    return
        # broken, or idle pool full: burst connections don't linger
        try:
            sock.close()
        except OSError:
            pass

    def _roundtrip(self, payload: bytes, terminators: tuple[bytes, ...]) -> bytes:
        sock = self._checkout()
        try:
            sock.sendall(payload)
            buf = b""
            while not buf.endswith(terminators):
                chunk = sock.recv(65536)
                if not chunk:
                    raise MemcacheError("connection closed by memcached")
                buf += chunk
        except (OSError, MemcacheError):
            self._checkin(sock, broken=True)
            raise
        self._checkin(sock)
        return buf

    def get_multi(self, keys: Sequence[str]) -> dict[str, int]:
        """One read RTT for all keys; missing keys are absent from the
        result (gomemcache GetMulti)."""
        if not keys:
            return {}
        for key in keys:
            _check_key(key)
        payload = ("get " + " ".join(keys) + "\r\n").encode()
        buf = self._roundtrip(payload, (b"END\r\n",))
        values: dict[str, int] = {}
        lines = buf.split(b"\r\n")
        i = 0
        while i < len(lines):
            line = lines[i]
            if line.startswith(b"VALUE "):
                # Corrupt/truncated VALUE lines (missing key, binary key,
                # missing data line) are treated like the non-numeric
                # foreign-value case below: absent => counted as 0, the
                # backend's documented tolerance (memcached errors are
                # logged and tolerated, cache_impl.go:96-99) — never an
                # IndexError/UnicodeDecodeError out of the client.
                parts = line.split()
                try:
                    key = parts[1].decode()
                    values[key] = int(lines[i + 1])
                except (IndexError, UnicodeDecodeError, ValueError):
                    pass
                i += 2
            else:
                i += 1
        return values

    def increment(self, key: str, delta: int) -> int:
        _check_key(key)
        payload = f"incr {key} {delta}\r\n".encode()
        buf = self._roundtrip(payload, (b"\r\n",))
        line = buf.strip()
        if line == b"NOT_FOUND":
            raise NotFoundError(key)
        if line.startswith(b"ERROR") or line.startswith(b"CLIENT_ERROR"):
            raise MemcacheError(line.decode(errors="replace"))
        try:
            return int(line)
        except ValueError:
            # any other reply shape is a protocol error, not a ValueError
            raise MemcacheError(f"bad incr reply: {line!r}") from None

    def add(self, key: str, value: int, expiry_seconds: int) -> None:
        _check_key(key)
        data = str(value).encode()
        payload = (
            f"add {key} 0 {expiry_seconds} {len(data)}\r\n".encode() + data + b"\r\n"
        )
        buf = self._roundtrip(payload, (b"STORED\r\n", b"NOT_STORED\r\n"))
        if buf.strip() == b"NOT_STORED":
            raise NotStoredError(key)


def _check_key(key: str) -> None:
    if len(key) > MAX_KEY_LENGTH:
        raise MemcacheError(f"key too long ({len(key)} > {MAX_KEY_LENGTH})")


class MemcacheRateLimitCache:
    def __init__(
        self,
        client: MemcacheClient,
        base_limiter: BaseRateLimiter,
        max_async_workers: int = 8,
    ):
        self._client = client
        self._base = base_limiter
        self._executor = ThreadPoolExecutor(
            max_workers=max_async_workers, thread_name_prefix="memcache-incr"
        )
        self._pending_lock = threading.Lock()
        self._pending: set = set()

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[RateLimit | None],
    ) -> DoLimitResponse:
        hits_addend = max(1, request.hits_addend)
        cache_keys = self._base.generate_cache_keys(request, limits, hits_addend)

        tag_do_limit_start("memcache", len(limits), len(cache_keys))

        n = len(request.descriptors)
        over_local = [False] * n
        to_fetch: list[str] = []
        for i, cache_key in enumerate(cache_keys):
            if cache_key.key == "":
                continue
            if self._base.is_over_limit_with_local_cache(cache_key.key, limits[i]):
                over_local[i] = True
                continue
            to_fetch.append(cache_key.key)

        # GetMulti errors are tolerated: counts read as 0 => allowed
        # (cache_impl.go:96-99).
        fetched: dict[str, int] = {}
        if to_fetch:
            try:
                fetched = self._client.get_multi(to_fetch)
            except MemcacheError:
                fetched = {}

        response = DoLimitResponse()
        for i, cache_key in enumerate(cache_keys):
            limit_info = None
            if cache_key.key != "" and not over_local[i]:
                before = fetched.get(cache_key.key, 0)
                limit_info = LimitInfo(
                    limits[i], before=before, after=before + hits_addend
                )
            elif over_local[i]:
                limit_info = LimitInfo(limits[i], before=0, after=0)
            response.descriptor_statuses.append(
                self._base.get_response_descriptor_status(
                    cache_key.key, limit_info, over_local[i], hits_addend, response
                )
            )

        # async settle (cache_impl.go:124-168)
        to_increment = [
            (cache_keys[i].key, unit_to_divider(limits[i].unit))
            for i in range(n)
            if cache_keys[i].key != "" and not over_local[i]
        ]
        if to_increment:
            future = self._executor.submit(
                self._increase_async, to_increment, hits_addend
            )
            with self._pending_lock:
                self._pending.add(future)
            future.add_done_callback(self._discard_pending)
        return response

    def _discard_pending(self, future) -> None:
        with self._pending_lock:
            self._pending.discard(future)

    def _increase_async(self, items: list[tuple[str, int]], hits: int) -> None:
        for key, divider in items:
            try:
                self._client.increment(key, hits)
            except NotFoundError:
                expiry = self._base.expiration_seconds(divider)
                try:
                    self._client.add(key, hits, expiry)
                except NotStoredError:
                    # another caller won the add race; apply our hits on top
                    try:
                        self._client.increment(key, hits)
                    except MemcacheError:
                        pass  # logged-and-tolerated in the reference
                except MemcacheError:
                    pass
            except MemcacheError:
                pass

    def flush(self) -> None:
        """Join in-flight increments (cache_impl.go:170-172; tests)."""
        while True:
            with self._pending_lock:
                pending = list(self._pending)
            if not pending:
                return
            for future in pending:
                future.result(timeout=10.0)


def new_memcache_cache_from_settings(settings, base_limiter: BaseRateLimiter):
    if not settings.memcache_host_port:
        raise ValueError("MEMCACHE_HOST_PORT must be set for memcache backend")
    return MemcacheRateLimitCache(
        MemcacheClient(settings.memcache_host_port), base_limiter
    )
