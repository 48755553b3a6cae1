"""Port of api_ratelimit_tpu/cluster/federation.py: global quota
federation, bounded-divergence quota shares across clusters.

The lease algebra (backends/lease.py) one level up. A single cluster
bounds frontend overshoot by outstanding lease budgets; federation bounds
global overshoot by outstanding inter-cluster quota shares:

  * every key has one home cluster, deterministic over the sorted
    membership (``home_of(fp) = members[fp % n]``), whose share ledger is
    authoritative for the key's global limit;
  * the home spends directly against the limit; borrower clusters hold
    shares: the home commits the share into its authoritative count at
    grant time (the INCRBY-rider discipline: budget is reserved before it
    is served, never after), and the borrower admits locally while
    ``spent < granted``;
  * borrowers ship cumulative spent watermarks back on the settle cadence
    (FED_SETTLE_INTERVAL_MS); settlement is bookkeeping, not permission:
    the tokens were already counted at grant.

Invariant: at any instant

    global admits  <=  limit  +  sum(reclaimed unsettled shares)

A healthy federation never overshoots: grants are pre-counted. Overshoot
enters only through reclamation: when a borrower goes dark (share TTL
expired with no settle or renew, or its dial breaker is open) the home
returns the unsettled remainder ``granted - settled`` to the pool and bumps
that borrower's fence epoch; if the partitioned borrower was still serving
from the share, those tokens are counted twice, and that double count is
bounded by the outstanding shares reclaimed. A resurrected borrower's late
settlements carry the old epoch and are rejected (``stale_epoch_rejected``),
the split-brain guard of replication's epoch fence.

Wire: a borrower dials each home's sidecar address and sends
OP_FED_EXCHANGE (backends/sidecar.py); the connection becomes a framed
request/response exchange on replication's frame codec
(persist/replication.py: magic, CRC32, per-connection contiguous sequence
numbers) with the kinds 3-8 below. A gap, a CRC failure or an unknown kind
is a ReplProtocolError answered the replication way: drop the connection
and resync; the (re)connect handshake always starts with a full
KIND_FED_SNAPSHOT of the grantor's view for that borrower. Fault sites
``fed.exchange`` (borrower send: error, drop, delay_ms, corrupt,
torn_write) and ``fed.apply`` (home receive: error, drop, delay_ms) drive
the failure menu of repl.ship/repl.apply (testing/faults.py).

Degradation: settlement lag past FED_MAX_LAG_MS flips the sticky
``fed.degraded`` health probe and shrinks share sizing toward 1 (the
lease ladder: start FED_SHARE_MIN, double on renew-after-exhaustion up to
FED_SHARE_MAX, halve while degraded, shrink near the limit). A cluster
whose card fails, or that is cut off from every peer, keeps serving from
its outstanding shares and its home budget (backends/fallback.py consults
this ledger after the lease table) before the failure-mode rung answers.
The ledger is host bookkeeping around the served step: no kernel changes,
and the card's slab is its own count.

The ledger rides the snapshot set as fed.snap (persist/snapshotter.py,
FLAG_FED section): the boot restore drops settled and TTL-dead shares and
floors the restored slab counters at the live shares' watermarks before
the table is uploaded to the card (persist/snapshot.py
reconcile_fed_shares / apply_fed_floors). A restart raises the fence
floor to "now", so pre-crash grants can only be reclaimed, never settled.

Two departures from the reference. consume_for_fallback queues a share
request for a borrowed key that holds no share yet, as well as for a dry
one, so the share rung of a cluster whose card failed asks the home for
budget on its first miss (the reference queues one only for a share that
ran dry, so a key with no share never gets one through the rung). And the
pump's garbage collection keeps a home's committed count of a window until
WINDOW_HOLD_S after the window starts and its grants are gone (ROADMAP C7:
the reference's collection raised on every pump of a home once a granted
window's start had passed, and a collection that ran would have dropped
the count of a window still open, letting the home grant its limit again).

FED_ENABLED=false builds none of this: no coordinator, no wire op, the
byte-identical rollback arm.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading

import numpy as np

from ..backends.fallback import CircuitBreaker
from ..limiter.base_limiter import LimitInfo
from ..models.units import unit_to_divider
from ..ops.hashing import fingerprint64
from ..persist.replication import (
    ReplProtocolError,
    encode_frame,
    read_frame,
)
from ..persist.snapshot import (
    FED_COL_EXPIRE,
    FED_COL_FP_HI,
    FED_COL_FP_LO,
    FED_COL_GRANTED,
    FED_COL_OUT,
    FED_COL_SETTLED,
    FED_COL_SPENT,
    FED_COL_WINDOW,
    FED_ROW_WIDTH,
)
from ..tracing import journeys

logger = logging.getLogger("ratelimit.federation")

FAULT_SITE_EXCHANGE = "fed.exchange"  # testing/faults.py chaos site
FAULT_SITE_APPLY = "fed.apply"  # testing/faults.py chaos site

# Frame kinds on the OP_FED_EXCHANGE stream. Disjoint from replication's
# KIND_SNAPSHOT=1 / KIND_DELTA=2 so a frame can never masquerade across
# protocols; read_frame(kinds=FED_KINDS) enforces the whitelist.
KIND_FED_REQUEST = 3  # borrower -> home: rows (fp, window, want, limit)
KIND_FED_GRANT = 4  # home -> borrower: rows (fp, window, granted, used_after)
KIND_FED_SETTLE = 5  # borrower -> home: rows (fp, window, spent_total, _)
KIND_FED_SETTLE_ACK = 6  # home -> borrower: rows (fp, window, settled, _)
KIND_FED_SNAPSHOT = 7  # home -> borrower: full grantor view (handshake/resync)
KIND_FED_FENCE = 8  # home -> borrower: u32 current fence epoch (stale reject)
FED_KINDS = (
    KIND_FED_REQUEST,
    KIND_FED_GRANT,
    KIND_FED_SETTLE,
    KIND_FED_SETTLE_ACK,
    KIND_FED_SNAPSHOT,
    KIND_FED_FENCE,
)

# exchange hello: u32 fence epoch last known | u16 borrower-name length,
# then the name bytes (utf-8) — sent once after the OP_FED_EXCHANGE header
_HELLO = struct.Struct("<IH")
# one ledger row on the wire: fp, window, a, b (meaning per kind above)
_ROW = struct.Struct("<QQII")
_FENCE = struct.Struct("<I")

MAX_EXCHANGE_ROWS = 1 << 16  # protocol cap per frame (u32-count safety)
# a home keeps a window's committed count at least this long after the
# window starts: a grant row carries the window's start but not its
# divider, so the home cannot tell when the window ends, and a day is the
# longest rule unit (ROADMAP C7)
WINDOW_HOLD_S = 86_400


def _pack_rows(rows) -> bytes:
    return b"".join(_ROW.pack(int(fp), int(w), int(a), int(b)) for fp, w, a, b in rows)


def _unpack_rows(payload: bytes) -> list:
    if len(payload) % _ROW.size:
        raise ReplProtocolError(
            f"fed exchange payload of {len(payload)} bytes is not a row multiple"
        )
    n = len(payload) // _ROW.size
    if n > MAX_EXCHANGE_ROWS:
        raise ReplProtocolError(f"fed exchange frame of {n} rows exceeds cap")
    return [
        _ROW.unpack_from(payload, i * _ROW.size) for i in range(n)
    ]


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("fed exchange connection closed")
        buf.extend(chunk)
    return bytes(buf)


class _Share:
    """Borrower-side record of one (fp, window) share from its home."""

    __slots__ = ("granted", "spent", "settled", "base", "expire_at", "limit")

    def __init__(self, granted=0, spent=0, settled=0, base=0, expire_at=0, limit=0):
        self.granted = granted  # tokens the home committed to us
        self.spent = spent  # tokens we admitted locally
        self.settled = settled  # spent watermark the home has acked
        self.base = base  # home's committed count when our share began
        self.expire_at = expire_at  # unix seconds; renew-or-lose TTL
        self.limit = limit  # the rule's limit (for renewal requests)


class _GrantOut:
    """Home-side record of one borrower's outstanding share of a row."""

    __slots__ = ("granted", "settled", "expire_at")

    def __init__(self, granted=0, settled=0, expire_at=0):
        self.granted = granted
        self.settled = settled
        self.expire_at = expire_at


class _PeerLink:
    """Borrower-side connection state to one home peer."""

    __slots__ = (
        "name", "address", "sock", "out_seq", "in_seq", "epoch",
        "breaker", "last_ok", "ever_ok",
    )

    def __init__(self, name: str, address: str, breaker: CircuitBreaker):
        self.name = name
        self.address = address
        self.sock = None
        self.out_seq = 0
        self.in_seq = 0
        self.epoch = 0  # home's fence epoch for US, learned at handshake
        self.breaker = breaker
        self.last_ok = None  # unix seconds of the last successful exchange
        self.ever_ok = False


class FederationCoordinator:
    """One cluster's federation half: share ledger + exchange protocol.

    Thread-safe; drive it either with start() (a pump thread on the
    settle cadence, production) or by calling pump() directly between
    load rounds (tests, which run in-process cluster pairs on a
    FakeTimeSource).
    """

    def __init__(
        self,
        self_name: str,
        peers: dict,
        time_source,
        share_min: int = 8,
        share_max: int = 1024,
        settle_interval_ms: float = 50.0,
        max_lag_ms: float = 250.0,
        share_ttl_ms: float = 500.0,
        scope=None,
        fault_injector=None,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 0.5,
    ):
        if self_name not in peers:
            raise ValueError(f"self {self_name!r} missing from peers {sorted(peers)}")
        if len(peers) < 2:
            raise ValueError("federation needs at least two clusters")
        self.self_name = self_name
        self.members = sorted(peers)
        self._peer_addrs = dict(peers)
        self._time = time_source
        self._share_min = max(1, int(share_min))
        self._share_max = max(self._share_min, int(share_max))
        self._interval_s = float(settle_interval_ms) / 1000.0
        self._max_lag_s = float(max_lag_ms) / 1000.0
        self._ttl_s = float(share_ttl_ms) / 1000.0
        self._faults = fault_injector
        self._lock = threading.RLock()
        self._base = None  # bound limiter for consume_for_fallback responses

        # borrower state: shares we hold, keyed (fp, window)
        self._shares: dict = {}
        # keys we want shares for before the next pump: (fp, window) ->
        # (limit, deadline)
        self._wants: dict = {}
        # adaptive sizing ladder per fp
        self._size: dict = {}
        # home state: committed count per (fp, window) (local spend +
        # grants out) and its window deadline
        self._used: dict = {}
        self._deadline: dict = {}
        # home state: outstanding grants per (fp, window) -> {peer: _GrantOut}
        self._out: dict = {}
        # home state: fence epoch per borrower; the floor rises on
        # restart so pre-crash settles are rejected, not merged
        self._fence: dict = {}
        self._fence_floor = 0

        self._links = {
            name: _PeerLink(
                name,
                addr,
                CircuitBreaker(
                    breaker_threshold,
                    breaker_reset_s,
                    # the coordinator's clock authority drives breaker
                    # reset windows too, so federation chaos runs (and
                    # clock-skew nemeses) stay deterministic
                    clock=self._time.monotonic,
                ),
            )
            for name, addr in peers.items()
            if name != self_name
        }

        self._degraded = False  # sticky until settlement recovers
        self._degraded_reason = ""
        self._stop = threading.Event()
        self._thread = None

        # plain totals (always available, stats scope or not)
        self.grants_total = 0
        self.grant_tokens_total = 0
        self.settles_total = 0
        self.settle_tokens_total = 0
        self.reclaims_total = 0
        self.reclaimed_tokens_total = 0
        self.stale_epoch_rejected_total = 0
        self.resyncs_total = 0
        self.exchange_errors_total = 0
        self.fallback_hits_total = 0

        self._g_outstanding = self._g_share_tokens = None
        self._g_settle_lag = self._g_degraded = None
        self._c_settles = self._c_reclaims = self._c_stale = None
        self._c_grants = self._c_grant_tokens = None
        self._c_resyncs = self._c_errors = None
        if scope is not None:
            sc = scope.scope("fed")
            self._g_outstanding = sc.gauge("shares_outstanding")
            self._g_share_tokens = sc.gauge("share_tokens")
            self._c_settles = sc.counter("settles")
            self._g_settle_lag = sc.gauge("settle_lag_ms")
            self._c_reclaims = sc.counter("reclaims")
            self._c_stale = sc.counter("stale_epoch_rejected")
            self._g_degraded = sc.gauge("degraded")
            self._c_grants = sc.counter("grants")
            self._c_grant_tokens = sc.counter("grant_tokens")
            self._c_resyncs = sc.counter("resyncs")
            self._c_errors = sc.counter("exchange_errors")
            sc.add_stat_generator(self)

    # -- membership ----------------------------------------------------

    def home_of(self, fp: int) -> str:
        return self.members[int(fp) % len(self.members)]

    def is_home(self, fp: int) -> bool:
        return self.home_of(fp) == self.self_name

    # -- admission (the local floor; no kernel change) -----------------

    def consume(
        self, fp: int, window: int, limit: int, n: int = 1, deadline: int = 0
    ) -> bool:
        """Admit n tokens for (fp, window) against the federated global
        limit, or deny. Home keys spend directly against the committed
        count; borrowed keys spend from the outstanding share and queue a
        (re)grant request for the next pump when the share runs dry —
        always a verdict, never an error (the zero-failed-requests
        contract under partition)."""
        fp, window, n = int(fp), int(window), int(n)
        deadline = int(deadline) if deadline else window + 1
        key = (fp, window)
        with self._lock:
            if self.is_home(fp):
                used = self._used.get(key, 0)
                if used + n > int(limit):
                    return False
                self._used[key] = used + n
                self._deadline[key] = max(self._deadline.get(key, 0), deadline)
                return True
            share = self._shares.get(key)
            # NOTE: no TTL check here — the share TTL is the GRANTOR's
            # reclamation trigger, not a serving bound. A partitioned
            # borrower keeps serving its unspent balance (those tokens
            # were pre-committed at the home; serving them is exactly
            # the overshoot the bound permits) and the fence rejects its
            # late settlements after the home reclaims.
            if share is not None and share.spent + n <= share.granted:
                share.spent += n
                return True
            # dry (or no) share: remember the want for the next pump —
            # the request itself never rides the admission path
            self._wants[key] = (int(limit), deadline)
            if share is not None:
                share.limit = int(limit)
            return False

    def _now_s(self) -> float:
        return float(self._time.unix_now())

    # -- adaptive share sizing (the lease ladder) ----------------------

    def _plan_size(self, fp: int, prev: "_Share | None") -> int:
        size = self._size.get(fp, self._share_min)
        if (
            prev is not None
            and prev.granted > 0
            and prev.spent >= prev.granted
        ):
            # renew-after-exhaustion: the share was fully burned — double
            size = min(size * 2, self._share_max)
        if self._degraded:
            # WAN-lag degradation: shrink toward 1 while settlement lags
            size = max(1, size // 2)
        self._size[fp] = size
        return size

    # -- home side: serve one borrower's exchange connection -----------

    def serve_exchange(self, conn) -> None:
        """Serve one borrower over an OP_FED_EXCHANGE connection: read
        the hello, ship the full-snapshot resync frame, then answer
        request/settle frames until the connection breaks or a frame
        fails validation (gap/CRC/kind) — which drops the connection,
        the replication resync discipline."""
        try:
            hdr = _recv_exact(conn, _HELLO.size)
            _epoch_known, name_len = _HELLO.unpack(hdr)
            name = _recv_exact(conn, int(name_len)).decode("utf-8", "replace")
        except (OSError, ConnectionError, struct.error) as e:
            logger.info("fed exchange hello failed: %s", e)
            return
        if name not in self.members or name == self.self_name:
            logger.warning("fed exchange from unknown borrower %r", name)
            return
        out_seq = 0
        expect_seq = 0
        try:
            with self._lock:
                fence = self._fence_of(name)
                snap = self._grantor_rows_for(name)
            conn.sendall(
                encode_frame(KIND_FED_SNAPSHOT, fence, out_seq, _pack_rows(snap))
            )
            out_seq += 1
            while True:
                kind, epoch, seq, payload = read_frame(
                    lambda nb: _recv_exact(conn, nb), kinds=FED_KINDS
                )
                if self._faults is not None:
                    action = self._faults.fire(FAULT_SITE_APPLY)
                    if action == "drop":
                        # frame lost pre-apply: no reply ever sent — the
                        # borrower times out and resyncs
                        expect_seq += 1
                        continue
                    if action in ("error", "torn_write", "corrupt"):
                        raise ReplProtocolError(f"injected fed.apply {action}")
                if seq != expect_seq:
                    raise ReplProtocolError(
                        f"fed exchange sequence gap: got {seq}, want {expect_seq}"
                    )
                expect_seq += 1
                reply = self._apply_exchange_frame(name, kind, epoch, payload)
                conn.sendall(
                    encode_frame(reply[0], reply[1], out_seq, reply[2])
                )
                out_seq += 1
        except (OSError, ConnectionError, ReplProtocolError) as e:
            logger.info("fed exchange with %s ended: %s", name, e)

    def _fence_of(self, name: str) -> int:
        return max(self._fence.get(name, 0), self._fence_floor)

    def _grantor_rows_for(self, name: str) -> list:
        rows = []
        for (fp, window), per_peer in self._out.items():
            go = per_peer.get(name)
            if go is not None:
                rows.append((fp, window, go.granted, go.settled))
        return rows

    def _apply_exchange_frame(
        self, name: str, kind: int, epoch: int, payload: bytes
    ) -> tuple:
        """Handle one borrower frame; returns (reply_kind, reply_epoch,
        reply_payload). Every frame is fenced first: a stale epoch gets
        KIND_FED_FENCE with the current epoch (and, for settles, the
        pinned stale_epoch_rejected count) — the resurrected-peer guard."""
        with self._lock:
            fence = self._fence_of(name)
            if epoch != fence:
                if kind == KIND_FED_SETTLE:
                    n = len(payload) // _ROW.size
                    self.stale_epoch_rejected_total += n
                    if self._c_stale is not None:
                        self._c_stale.add(n)
                return KIND_FED_FENCE, fence, _FENCE.pack(fence)
            if kind == KIND_FED_REQUEST:
                return KIND_FED_GRANT, fence, _pack_rows(
                    self._grant_locked(name, _unpack_rows(payload))
                )
            if kind == KIND_FED_SETTLE:
                return KIND_FED_SETTLE_ACK, fence, _pack_rows(
                    self._settle_locked(name, _unpack_rows(payload))
                )
            raise ReplProtocolError(f"unexpected fed frame kind {kind}")

    def _grant_locked(self, name: str, rows: list) -> list:
        """Grant shares against the committed count — the INCRBY rider:
        the tokens enter the authoritative count NOW, before the borrower
        serves a single request from them. Near the limit, grants shrink
        toward 1 (the lease near-limit ladder) so federation accuracy
        degrades smoothly instead of reserving past the edge."""
        now = self._now_s()
        out = []
        for fp, window, want, limit in rows:
            if not self.is_home(fp):
                out.append((fp, window, 0, 0))  # misrouted: nothing granted
                continue
            key = (fp, window)
            used = self._used.get(key, 0)
            headroom = max(0, int(limit) - used)
            grant = min(int(want), headroom)
            if used >= 0.9 * int(limit):
                grant = min(grant, max(1 if headroom else 0, headroom // 2))
            if grant > 0:
                self._used[key] = used + grant
                self._deadline[key] = max(
                    self._deadline.get(key, 0), int(window) + 1
                )
                per_peer = self._out.setdefault(key, {})
                go = per_peer.setdefault(name, _GrantOut())
                go.granted += grant
                go.expire_at = now + self._ttl_s
                self.grants_total += 1
                self.grant_tokens_total += grant
                if self._c_grants is not None:
                    self._c_grants.inc()
                if self._c_grant_tokens is not None:
                    self._c_grant_tokens.add(grant)
            out.append((fp, window, grant, self._used.get(key, used)))
        return out

    def _settle_locked(self, name: str, rows: list) -> list:
        """Apply cumulative spent watermarks from a borrower. Settlement
        moves nothing in the committed count (grants were pre-counted);
        it converts outstanding liability into settled history and
        renews the share's TTL — the signal that the borrower is alive."""
        now = self._now_s()
        out = []
        for fp, window, spent_total, _b in rows:
            key = (fp, window)
            go = self._out.get(key, {}).get(name)
            if go is None:
                # settled after reclaim under the SAME epoch cannot
                # happen (reclaim bumps the fence); an unknown row is a
                # borrower bug — ack its own number, grant nothing
                out.append((fp, window, int(spent_total), 0))
                continue
            accepted = min(int(spent_total), go.granted)
            delta = max(0, accepted - go.settled)
            go.settled = max(go.settled, accepted)
            go.expire_at = now + self._ttl_s
            self.settles_total += 1
            self.settle_tokens_total += delta
            if self._c_settles is not None:
                self._c_settles.inc()
            out.append((fp, window, go.settled, 0))
        return out

    # -- home side: reclamation ----------------------------------------

    def reclaim_sweep(self, now: float | None = None) -> int:
        """Return dead borrowers' unsettled shares to the pool: a share
        not settled/renewed within its TTL — or whose borrower's dial
        breaker is open — is reclaimed (committed count shrinks by the
        unsettled remainder, the global limit re-tightens) and the
        borrower's fence epoch bumps so a resurrected peer's late
        settlements are rejected instead of merged. Returns the number
        of reclaimed tokens."""
        now = self._now_s() if now is None else float(now)
        reclaimed = 0
        with self._lock:
            fenced: set = set()
            for key in list(self._out):
                per_peer = self._out[key]
                for name in list(per_peer):
                    go = per_peer[name]
                    link = self._links.get(name)
                    breaker_open = (
                        link is not None
                        and link.breaker.enabled
                        and link.breaker.state == CircuitBreaker.OPEN
                    )
                    if go.expire_at > now and not breaker_open:
                        continue
                    unsettled = max(0, go.granted - go.settled)
                    if unsettled:
                        self._used[key] = max(
                            0, self._used.get(key, 0) - unsettled
                        )
                        reclaimed += unsettled
                    del per_peer[name]
                    fenced.add(name)
                    self.reclaims_total += 1
                    self.reclaimed_tokens_total += unsettled
                    if self._c_reclaims is not None:
                        self._c_reclaims.inc()
                if not per_peer:
                    del self._out[key]
            for name in fenced:
                self._fence[name] = self._fence_of(name) + 1
        if reclaimed:
            logger.warning(
                "fed reclaimed %d unsettled tokens (fenced %s)",
                reclaimed,
                sorted(fenced),
            )
        return reclaimed

    # -- borrower side: the pump ---------------------------------------

    def pump(self) -> dict:
        """One settle/request cycle against every home we borrow from,
        plus the home-side reclaim sweep and window GC. Production runs
        this on a thread every FED_SETTLE_INTERVAL_MS; tests and the
        bench tier call it directly. Returns per-peer outcome strings
        (diagnostic)."""
        outcome: dict = {}
        now = self._now_s()
        with self._lock:
            by_peer: dict = {}
            for (fp, window), share in self._shares.items():
                if share.spent > share.settled:
                    by_peer.setdefault(self.home_of(fp), {}).setdefault(
                        "settle", []
                    ).append((fp, window, share.spent, 0))
            for (fp, window), (limit, _deadline) in self._wants.items():
                by_peer.setdefault(self.home_of(fp), {}).setdefault(
                    "request", []
                ).append((fp, window, 0, limit))
        for name, work in by_peer.items():
            link = self._links.get(name)
            if link is None:
                continue
            outcome[name] = self._pump_peer(link, work)
        self.reclaim_sweep(now)
        self._gc(now)
        self._update_degraded(now)
        return outcome

    def _pump_peer(self, link: _PeerLink, work: dict) -> str:
        if not link.breaker.allow():
            return "breaker_open"
        try:
            self._ensure_link(link)
            settle_rows = work.get("settle") or []
            if settle_rows:
                kind, epoch, payload = self._exchange(
                    link, KIND_FED_SETTLE, _pack_rows(settle_rows)
                )
                self._handle_reply(link, kind, epoch, payload)
            request_rows = work.get("request")
            if request_rows:
                sized = []
                with self._lock:
                    for fp, window, _a, limit in request_rows:
                        prev = self._shares.get((fp, window))
                        sized.append(
                            (fp, window, self._plan_size(fp, prev), limit)
                        )
                kind, epoch, payload = self._exchange(
                    link, KIND_FED_REQUEST, _pack_rows(sized)
                )
                self._handle_reply(link, kind, epoch, payload)
            link.breaker.record_success()
            link.last_ok = self._now_s()
            link.ever_ok = True
            return "ok"
        except (OSError, ConnectionError, ReplProtocolError, socket.timeout) as e:
            self._drop_link(link)
            link.breaker.record_failure()
            self.exchange_errors_total += 1
            if self._c_errors is not None:
                self._c_errors.inc()
            logger.info("fed pump to %s failed: %s", link.name, e)
            return f"error:{type(e).__name__}"

    def _ensure_link(self, link: _PeerLink) -> None:
        if link.sock is not None:
            return
        from ..backends.sidecar import (
            MAGIC,
            OP_FED_EXCHANGE,
            VERSION,
            _HDR,
            parse_sidecar_address,
        )

        scheme, target = parse_sidecar_address(link.address)
        if scheme == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(max(1.0, 10.0 * self._interval_s))
            sock.connect(target)
        elif scheme == "tcp":
            sock = socket.create_connection(
                target, timeout=max(1.0, 10.0 * self._interval_s)
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        else:
            raise ConnectionError(
                f"fed peer {link.name} has unsupported scheme {scheme}://"
            )
        try:
            name = self.self_name.encode("utf-8")
            sock.sendall(
                _HDR.pack(MAGIC, VERSION, OP_FED_EXCHANGE, 0)
                + _HELLO.pack(int(link.epoch), len(name))
                + name
            )
            link.out_seq = 0
            link.in_seq = 0
            kind, epoch, seq, payload = read_frame(
                lambda nb: _recv_exact(sock, nb), kinds=FED_KINDS
            )
            if kind != KIND_FED_SNAPSHOT or seq != 0:
                raise ReplProtocolError(
                    f"fed handshake wanted snapshot/0, got kind {kind} seq {seq}"
                )
            link.in_seq = 1
            link.sock = sock
            self._resync_from_snapshot(link, epoch, payload)
        except BaseException:
            sock.close()
            link.sock = None
            raise

    def _drop_link(self, link: _PeerLink) -> None:
        if link.sock is not None:
            try:
                link.sock.close()
            except OSError:
                pass
            link.sock = None

    def _exchange(self, link: _PeerLink, kind: int, payload: bytes):
        """Ship one frame and read its reply, consulting the
        fed.exchange chaos site first: 'drop' consumes the sequence
        number without sending (the home sees a gap on the NEXT frame
        and drops the connection), 'corrupt' flips a payload byte (the
        home's CRC check drops the connection), 'torn_write' sends half
        a frame, 'error' fails the pump outright — every arm lands in
        the same drop-and-resync discipline."""
        frame = encode_frame(kind, link.epoch, link.out_seq, payload)
        link.out_seq += 1
        if self._faults is not None:
            action = self._faults.fire(FAULT_SITE_EXCHANGE)
            if action == "error":
                raise ConnectionError("injected fed.exchange error")
            if action == "drop":
                raise ConnectionError("injected fed.exchange drop")
            if action == "corrupt":
                body = bytearray(frame)
                body[-5] ^= 0xFF  # flip a payload/CRC byte
                link.sock.sendall(bytes(body))
                # the home drops the connection without replying
                raise ConnectionError("injected fed.exchange corrupt")
            if action == "torn_write":
                link.sock.sendall(frame[: max(1, len(frame) // 2)])
                raise ConnectionError("injected fed.exchange torn_write")
        link.sock.sendall(frame)
        kind, epoch, seq, payload = read_frame(
            lambda nb: _recv_exact(link.sock, nb), kinds=FED_KINDS
        )
        if seq != link.in_seq:
            raise ReplProtocolError(
                f"fed reply sequence gap: got {seq}, want {link.in_seq}"
            )
        link.in_seq += 1
        return kind, epoch, payload

    def _handle_reply(self, link: _PeerLink, kind: int, epoch: int, payload: bytes):
        now = self._now_s()
        if kind == KIND_FED_FENCE:
            # our epoch is stale: the home reclaimed our shares (we were
            # presumed dead). Adopt the new fence, zero the balances
            # homed there, and re-request on the next pump.
            (new_epoch,) = _FENCE.unpack(payload)
            with self._lock:
                link.epoch = int(new_epoch)
                for (fp, window), share in self._shares.items():
                    if self.home_of(fp) == link.name:
                        share.granted = min(share.granted, share.spent)
                        share.settled = share.spent
                        if share.limit:
                            self._wants.setdefault(
                                (fp, window), (share.limit, window + 1)
                            )
                self.resyncs_total += 1
                if self._c_resyncs is not None:
                    self._c_resyncs.inc()
            return
        if kind == KIND_FED_GRANT:
            with self._lock:
                for fp, window, granted, used_after in _unpack_rows(payload):
                    if granted <= 0:
                        continue
                    key = (fp, window)
                    want = self._wants.pop(key, None)
                    share = self._shares.get(key)
                    if share is None:
                        share = self._shares[key] = _Share(
                            base=max(0, int(used_after) - int(granted))
                        )
                    share.granted += int(granted)
                    share.expire_at = now + self._ttl_s
                    if want is not None:
                        share.limit = want[0]
            return
        if kind == KIND_FED_SETTLE_ACK:
            with self._lock:
                for fp, window, settled, _b in _unpack_rows(payload):
                    share = self._shares.get((fp, window))
                    if share is not None:
                        share.settled = max(share.settled, int(settled))
                        share.expire_at = now + self._ttl_s
            return
        raise ReplProtocolError(f"unexpected fed reply kind {kind}")

    def _resync_from_snapshot(self, link: _PeerLink, epoch: int, payload: bytes):
        """Adopt the home's authoritative view of OUR shares — the
        (re)connect handshake. Rows the home no longer carries were
        reclaimed: their remaining balance is gone (never served twice
        under a live exchange); rows it does carry set the granted/
        settled watermarks. Local spent is ours and survives."""
        rows = {
            (fp, window): (granted, settled)
            for fp, window, granted, settled in _unpack_rows(payload)
        }
        now = self._now_s()
        with self._lock:
            link.epoch = int(epoch)
            for (fp, window), share in self._shares.items():
                if self.home_of(fp) != link.name:
                    continue
                snap = rows.get((fp, window))
                if snap is None:
                    share.granted = min(share.granted, share.spent)
                    share.settled = share.spent
                else:
                    share.granted = int(snap[0])
                    share.settled = max(share.settled, int(snap[1]))
                    share.expire_at = max(share.expire_at, now + self._ttl_s)
            self.resyncs_total += 1
            if self._c_resyncs is not None:
                self._c_resyncs.inc()

    def _gc(self, now: float) -> None:
        with self._lock:
            for key in [
                k
                for k, s in self._shares.items()
                if s.expire_at <= now and s.settled >= s.spent
            ]:
                del self._shares[key]
            for key in [
                k
                for k, d in self._deadline.items()
                if d <= now and k[1] + WINDOW_HOLD_S <= now and k not in self._out
            ]:
                self._deadline.pop(key, None)
                self._used.pop(key, None)
            for key in [k for k, w in self._wants.items() if w[1] <= now]:
                del self._wants[key]

    # -- degradation (sticky fed.degraded probe) -----------------------

    def settle_lag_ms(self, now: float | None = None) -> float:
        """Worst settlement lag across peers we actively borrow from:
        how long since the last successful exchange with each. A peer we
        have never reached counts from the first borrow attempt."""
        now = self._now_s() if now is None else float(now)
        worst = 0.0
        with self._lock:
            active = {
                self.home_of(fp)
                for (fp, _w) in list(self._shares) + list(self._wants)
                if self.home_of(fp) != self.self_name
            }
            for name in active:
                link = self._links.get(name)
                if link is None:
                    continue
                if link.last_ok is None:
                    link.last_ok = now  # first sighting starts the clock
                worst = max(worst, (now - link.last_ok) * 1000.0)
        return worst

    def _update_degraded(self, now: float) -> None:
        lag = self.settle_lag_ms(now)
        if self._g_settle_lag is not None:
            self._g_settle_lag.set(int(lag))
        if lag > self._max_lag_s * 1000.0:
            if not self._degraded:
                logger.warning(
                    "fed settlement lag %.0fms > %.0fms: degraded (shares "
                    "shrink toward 1)",
                    lag,
                    self._max_lag_s * 1000.0,
                )
            self._degraded = True
            self._degraded_reason = (
                f"fed settle lag {lag:.0f}ms > {self._max_lag_s * 1000.0:.0f}ms"
            )
        elif self._degraded and lag <= self._max_lag_s * 1000.0:
            # sticky until settlement actually recovers under the bound
            self._degraded = False
            self._degraded_reason = ""
            logger.warning("fed settlement recovered (lag %.0fms)", lag)
        if self._g_degraded is not None:
            self._g_degraded.set(1 if self._degraded else 0)

    @property
    def degraded(self) -> bool:
        return self._degraded

    def degraded_reason(self) -> str | None:
        """HealthChecker degraded-probe contract: None while healthy."""
        return self._degraded_reason if self._degraded else None

    # -- the failure-ladder hook (backends/fallback.py) ----------------

    def bind_base(self, base) -> None:
        """Attach the base limiter whose response vocabulary
        consume_for_fallback speaks (the LeaseTable discipline)."""
        self._base = base

    def consume_for_fallback(
        self, domain: str, descriptor, limit, hits_addend: int, response
    ):
        """Serve one descriptor from the cluster's outstanding federation
        shares while every peer (or the local device owner) is dark.
        Returns a DescriptorStatus or None (no usable share — the
        caller's rung answers). The same hook shape as
        LeaseTable.consume_for_fallback, one rung below it."""
        if self._base is None:
            return None
        divider = unit_to_divider(limit.unit)
        now = int(self._base.time_source.unix_now())
        window = (now // divider) * divider
        fp = fingerprint64(domain, descriptor.entries, divider)
        key = (int(fp), int(window))
        with self._lock:
            share = self._shares.get(key)
            if self.is_home(fp):
                admitted = self.consume(
                    fp,
                    window,
                    limit.requests_per_unit,
                    hits_addend,
                    deadline=window + divider,
                )
                after = self._used.get(key, 0)
            else:
                if (
                    share is None
                    or share.spent + hits_addend > share.granted
                ):
                    # no share, or a dry one: ask the home on the next pump
                    # (the reference asks only for a dry share)
                    self._wants[key] = (
                        limit.requests_per_unit,
                        window + divider,
                    )
                    return None
                share.spent += hits_addend
                admitted = True
                after = share.base + share.spent
        if not admitted:
            return None
        self.fallback_hits_total += 1
        journeys.note_flag(journeys.FLAG_FED)
        parts = [domain]
        for entry in descriptor.entries:
            parts.append(entry.key)
            parts.append(entry.value)
        key_str = "_".join(parts) + f"_{window}"
        return self._base.get_response_descriptor_status(
            key_str,
            LimitInfo(limit, after - hits_addend, after),
            False,
            hits_addend,
            response,
        )

    # -- snapshot section (persist/snapshotter.py, FLAG_FED) -----------

    def export_rows(self) -> np.ndarray:
        """(n, 8) uint32 share-ledger rows in the FED_COL_* layout —
        borrower rows carry granted/spent/settled, home rows carry the
        committed count in SPENT (the restore floor) and the unsettled
        grantor-side total in OUT."""
        with self._lock:
            rows = []
            for (fp, window), share in self._shares.items():
                rows.append(
                    (
                        fp & 0xFFFFFFFF,
                        (fp >> 32) & 0xFFFFFFFF,
                        window & 0xFFFFFFFF,
                        share.granted,
                        share.spent,
                        share.settled,
                        0,
                        int(share.expire_at) & 0xFFFFFFFF,
                    )
                )
            for (fp, window), used in self._used.items():
                per_peer = self._out.get((fp, window), {})
                out = sum(max(0, g.granted - g.settled) for g in per_peer.values())
                settled = sum(g.settled for g in per_peer.values())
                expire = max(
                    [int(g.expire_at) for g in per_peer.values()]
                    + [int(self._deadline.get((fp, window), 0))]
                )
                rows.append(
                    (
                        fp & 0xFFFFFFFF,
                        (fp >> 32) & 0xFFFFFFFF,
                        window & 0xFFFFFFFF,
                        0,
                        used,
                        settled,
                        out,
                        expire & 0xFFFFFFFF,
                    )
                )
        if not rows:
            return np.empty((0, FED_ROW_WIDTH), dtype=np.uint32)
        return np.asarray(rows, dtype=np.uint32)

    def import_rows(self, rows: np.ndarray, now: float | None = None) -> int:
        """Re-seed the ledger from reconciled snapshot rows (boot
        restore). The fence floor rises to "now": a grant that predates
        the crash can be reclaimed when its TTL runs out (the committed
        count re-tightens) but never settled — a resurrected borrower's
        watermarks are rejected as stale, the split-brain guard."""
        now = self._now_s() if now is None else float(now)
        restored = 0
        rows = np.asarray(rows, dtype=np.uint32)
        with self._lock:
            self._fence_floor = max(self._fence_floor, int(now))
            for row in rows:
                fp = int(row[FED_COL_FP_LO]) | (int(row[FED_COL_FP_HI]) << 32)
                window = int(row[FED_COL_WINDOW])
                key = (fp, window)
                expire = int(row[FED_COL_EXPIRE])
                if self.is_home(fp):
                    self._used[key] = max(
                        self._used.get(key, 0), int(row[FED_COL_SPENT])
                    )
                    self._deadline[key] = max(self._deadline.get(key, 0), expire)
                    out = int(row[FED_COL_OUT])
                    if out > 0:
                        # peer attribution did not survive the crash:
                        # park the liability on a synthetic borrower that
                        # can never settle (the fence floor rose), so the
                        # TTL sweep returns it to the pool
                        per_peer = self._out.setdefault(key, {})
                        go = per_peer.setdefault("", _GrantOut())
                        go.granted += out
                        go.expire_at = max(go.expire_at, expire)
                else:
                    share = self._shares.setdefault(key, _Share())
                    share.granted = max(share.granted, int(row[FED_COL_GRANTED]))
                    share.spent = max(share.spent, int(row[FED_COL_SPENT]))
                    share.settled = max(share.settled, int(row[FED_COL_SETTLED]))
                    share.expire_at = max(share.expire_at, expire)
                restored += 1
        return restored

    # -- observability -------------------------------------------------

    def outstanding_tokens(self) -> int:
        """Grantor-side unsettled tokens across all borrowers — the
        overshoot bound's numerator."""
        with self._lock:
            return sum(
                max(0, go.granted - go.settled)
                for per_peer in self._out.values()
                for go in per_peer.values()
            )

    def share_balance(self) -> int:
        """Borrower-side live unspent share tokens (what this cluster can
        still serve while cut off from every peer)."""
        with self._lock:
            return sum(
                max(0, s.granted - s.spent) for s in self._shares.values()
            )

    def generate_stats(self) -> None:
        if self._g_outstanding is not None:
            self._g_outstanding.set(self.outstanding_tokens())
        if self._g_share_tokens is not None:
            self._g_share_tokens.set(self.share_balance())
        if self._g_settle_lag is not None:
            self._g_settle_lag.set(int(self.settle_lag_ms()))
        if self._g_degraded is not None:
            self._g_degraded.set(1 if self._degraded else 0)

    def describe(self) -> dict:
        """GET /debug/federation body."""
        with self._lock:
            peers = {}
            for name, link in self._links.items():
                peers[name] = {
                    "address": link.address,
                    "connected": link.sock is not None,
                    "breaker": link.breaker.state,
                    "fence_epoch": link.epoch,
                    "last_ok_unix": link.last_ok,
                }
            return {
                "self": self.self_name,
                "members": self.members,
                "degraded": self._degraded,
                "degraded_reason": self._degraded_reason or None,
                "settle_lag_ms": self.settle_lag_ms(),
                "shares_held": len(self._shares),
                "share_tokens": self.share_balance(),
                "home_rows": len(self._used),
                "shares_outstanding": self.outstanding_tokens(),
                "fence_floor": self._fence_floor,
                "fences": dict(self._fence),
                "grants_total": self.grants_total,
                "grant_tokens_total": self.grant_tokens_total,
                "settles_total": self.settles_total,
                "reclaims_total": self.reclaims_total,
                "reclaimed_tokens_total": self.reclaimed_tokens_total,
                "stale_epoch_rejected_total": self.stale_epoch_rejected_total,
                "resyncs_total": self.resyncs_total,
                "exchange_errors_total": self.exchange_errors_total,
                "peers": peers,
            }

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Run the pump on its own thread every FED_SETTLE_INTERVAL_MS
        (the production cadence; tests call pump() directly)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._pump_loop, name="fed-pump", daemon=True
        )
        self._thread.start()

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.pump()
            except Exception:
                logger.exception("fed pump failed")
            self._stop.wait(self._interval_s)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            for link in self._links.values():
                self._drop_link(link)
