"""Port of chaos/harness.py: the in-process SUT one chaos campaign runs
against, built on the port's classes.

Three roles, one fake wall clock, each role behind its OWN
SkewableTimeSource so the clock-skew nemesis bends one process without
touching the others (exactly the production shape: every process reads
process_time_source(), and /debug/clock skews only that process):

    owner   SlabDeviceEngine (direct mode, tiny slab, victim tier on, on
            `device`: the card by default, where every launch runs the
            way scan and apply kernels and the promote pass the multi
            way scan) + the lease frontend stack (BaseRateLimiter ->
            LeaseTable -> CudaRateLimitCache -> RateLimitService, the
            tests/test_lease _stack shape) + SlabSnapshotter over a real
            tmp directory
    east    FederationCoordinator, home for even-fp federated keys
    west    FederationCoordinator, home for odd-fp federated keys

east<->west ride real loopback TCP through a cuttable WAN (the
tests/test_federation _FedNet shape), so the partition nemesis severs
live exchanges the way a dropped WAN does, and fed.exchange fault rules
fire on real frames.

Every verb that admits tokens stamps the AdmissionLedger with the
window label computed on the ADMITTING role's clock at that moment —
the ledger's window-episode accounting is what lets the bound absorb
clock skew exactly (see ledger.py).

"Kill" is SIGKILL-equivalent for an in-process role: drop the role's
entire in-memory state and rebuild it cold. The owner rebuilds through
SlabSnapshotter.restore() (slab + lease liabilities + victim rows); a
federation coordinator comes back with empty share/commit ledgers. The
ledger charges each kill's counter loss to the crash term at the kill,
so the checker knows precisely how much overshoot that crash excused.

Unlike the reference, the harvest reads the engine's victim tier, its
overflow_lost_count_sum, the lease registry's outstanding() and a
coordinator's reclaimed_tokens_total by name: a renamed attribute raises
instead of reading 0 and loosening the bound.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import threading

from ..backends import sidecar as sc
from ..backends.cuda import CudaRateLimitCache, SlabDeviceEngine
from ..backends.lease import LeaseTable
from ..cluster import federation as fed_mod
from ..cluster.federation import FederationCoordinator
from ..limiter.base_limiter import BaseRateLimiter
from ..models import Code, Descriptor, RateLimitRequest
from ..persist.snapshotter import SlabSnapshotter
from ..service import RateLimitService
from ..stats import Store, TestSink
from ..testing.faults import FaultInjector, parse_fault_spec
from ..utils.timeutil import FakeTimeSource, SkewableTimeSource

from .ledger import AdmissionLedger

START = 1_000_000  # virtual epoch, same anchor the fed tests use
DIVIDER = 60  # every tracked limit is per-minute

LEASE_YAML = """\
domain: lease
descriptors:
  - key: api_key
    rate_limit: {unit: minute, requests_per_unit: 100}
  - key: open
    rate_limit: {unit: minute, requests_per_unit: 1000000}
"""

ROLES = ("owner", "east", "west")


class _StaticRuntime:
    def __init__(self, text):
        self._t = text

    def snapshot(self):
        text = self._t

        class Snap:
            def keys(self):
                return ["config.lease"]

            def get(self, key):
                return text

        return Snap()

    def add_update_callback(self, cb):
        pass


class ChaosHarness:
    def __init__(
        self,
        seed: int,
        snap_dir: str,
        lease_limit: int = 100,
        fed_limit: int = 50,
        fed_keys=("fed/a", "fed/b"),
        n_slots: int = 32,
        victim_max_rows: int = 24,
        device="cuda",
    ):
        """device: where the owner engine runs, "cuda" (the default; raises
        without a card) or "cpu" (the kernels' plain versions)."""
        self.seed = int(seed)
        self.device = device
        self.snap_dir = snap_dir
        self.lease_limit = int(lease_limit)
        self.fed_limit = int(fed_limit)
        self.wall = FakeTimeSource(START)
        self.clocks = {r: SkewableTimeSource(self.wall) for r in ROLES}
        # disjoint integer seeds per role: rule streams must not be
        # correlated across roles (faults.py salts per-rule on top)
        self.injectors = {
            r: FaultInjector([], seed=self.seed * 10 + i + 1)
            for i, r in enumerate(ROLES)
        }
        self.ledger = AdmissionLedger()
        self._n_slots = int(n_slots)
        self._victim_max_rows = int(victim_max_rows)
        self._lease_keys: set = set()
        # fed key -> fp; consecutive ints so sorted(("east","west"))
        # membership homes them alternately east/west
        self.fed_fps = {
            key: 1002 + i for i, key in enumerate(fed_keys)
        }
        self._fed_reclaimed_accum = 0
        self._lease_outstanding_lost = 0
        self._closing = threading.Event()
        self._partitioned = threading.Event()
        self._conn_lock = threading.Lock()
        self._conns: list = []
        self._build_owner(first=True)
        self._build_fed()

    # -- construction ------------------------------------------------------

    def _new_engine(self) -> SlabDeviceEngine:
        return SlabDeviceEngine(
            time_source=self.clocks["owner"],
            n_slots=self._n_slots,
            ways=2,
            device=self.device,
            buckets=(16,),
            batch_window_seconds=0.0,
            fault_injector=self.injectors["owner"],
            victim_max_rows=self._victim_max_rows,
        )

    def _new_snapshotter(self, engine) -> SlabSnapshotter:
        return SlabSnapshotter(
            engine,
            self.snap_dir,
            interval_ms=3_600_000.0,
            time_source=self.clocks["owner"],
            fault_injector=self.injectors["owner"],
        )

    def _build_owner(self, first: bool = False):
        ts = self.clocks["owner"]
        self.engine = self._new_engine()
        self.snap = self._new_snapshotter(self.engine)
        if first:
            store = Store(TestSink())
            base = BaseRateLimiter(
                time_source=ts,
                jitter_rand=random.Random(0),
                expiration_jitter_max_seconds=0,
                local_cache=None,
            )
            self.lease_table = LeaseTable(
                base,
                min_size=4,
                max_size=16,
                scope=store.scope("ratelimit").scope("lease"),
            )
            self.cache = CudaRateLimitCache(
                base, engine=self.engine, lease_table=self.lease_table
            )
            self.service = RateLimitService(
                runtime=_StaticRuntime(LEASE_YAML),
                cache=self.cache,
                stats_scope=store.scope("ratelimit").scope("service"),
                time_source=ts,
                lease=self.lease_table,
            )
        else:
            # the frontend survives the owner crash (separate process in
            # production): swap the engine under the cache (the sidecar
            # client re-dials; the in-process cache re-binds; the port's
            # cache calls the engine's row verb through it)
            self.cache._engine_core = self.engine

    def _build_fed(self):
        self.listeners: dict = {}
        peers = {}
        for name in ("east", "west"):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", 0))
            srv.listen(16)
            self.listeners[name] = srv
            peers[name] = f"tcp://127.0.0.1:{srv.getsockname()[1]}"
        self.peers = peers
        self.coords = {
            name: self._new_coord(name) for name in ("east", "west")
        }
        for name in ("east", "west"):
            threading.Thread(
                target=self._accept_loop, args=(name,), daemon=True
            ).start()

    def _new_coord(self, name: str) -> FederationCoordinator:
        return FederationCoordinator(
            name,
            self.peers,
            self.clocks[name],
            fault_injector=self.injectors[name],
            share_min=4,
            share_max=16,
            settle_interval_ms=50.0,
            share_ttl_ms=5_000.0,
            breaker_reset_s=0.05,
        )

    def _accept_loop(self, name):
        srv = self.listeners[name]
        while not self._closing.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if self._partitioned.is_set():
                conn.close()  # the WAN cut: dials are reset
                continue
            with self._conn_lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._serve, args=(name, conn), daemon=True
            ).start()

    def _serve(self, name, conn):
        try:
            hdr = fed_mod._recv_exact(conn, sc._HDR.size)
            _magic, _version, op, _flags = sc._HDR.unpack(hdr)
            if op == sc.OP_FED_EXCHANGE:
                # late-bound lookup: a killed-and-rebuilt coordinator
                # serves the frames that arrive after its rebirth
                self.coords[name].serve_exchange(conn)
        except (OSError, ConnectionError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- clocks / labels ---------------------------------------------------

    def label(self, role: str) -> int:
        now = self.clocks[role].unix_now()
        return (int(now) // DIVIDER) * DIVIDER

    def advance(self, seconds: int = 1) -> None:
        self.wall.advance(seconds)

    # -- workload verbs ----------------------------------------------------

    def offer_lease(self, value: str, hits: int = 1) -> bool:
        """One service request against the 100/min api_key limit; admits
        are ledgered under lease/<value> with the owner-clock label."""
        key = f"lease/{value}"
        self._lease_keys.add(key)
        req = RateLimitRequest(
            domain="lease",
            descriptors=(Descriptor.of(("api_key", value)),),
            hits_addend=hits,
        )
        try:
            code, _statuses, _headers = self.service.should_rate_limit(req)
        except Exception:
            self.ledger.record_deny(key)  # fail-closed in the harness
            return False
        if code == Code.OK:
            self.ledger.record_admit(key, self.label("owner"), hits, "owner")
            return True
        self.ledger.record_deny(key)
        return False

    def offer_filler(self, value: str) -> None:
        """Keyspace pressure against the open (10^6/min) limit: fills the
        tiny slab so tracked rows demote into the victim tier. Not
        ledgered — its bound is never in question; its evictions are."""
        req = RateLimitRequest(
            domain="lease",
            descriptors=(Descriptor.of(("open", value)),),
            hits_addend=1,
        )
        try:
            self.service.should_rate_limit(req)
        except Exception:
            pass

    def offer_fed(self, role: str, key: str, n: int = 1) -> bool:
        """One federated consume on east or west against the shared
        global fed_limit; the window label rides that role's clock."""
        fp = self.fed_fps[key]
        window = self.label(role)
        ok = self.coords[role].consume(
            fp, window, self.fed_limit, n, deadline=window + 2 * DIVIDER
        )
        if ok:
            self.ledger.record_admit(key, window, n, role)
        else:
            self.ledger.record_deny(key)
        return ok

    def fed_tick(self) -> None:
        """Drive the asynchronous parts synchronously: share grants /
        settlement frames, then the homes' TTL reclamation sweeps."""
        for name in ("east", "west"):
            try:
                self.coords[name].pump()
            except Exception:
                pass
            try:
                self.coords[name].reclaim_sweep()
            except Exception:
                pass

    def victim_tick(self) -> None:
        """The tier's reclamation cadence (VictimStats in production)."""
        try:
            self.engine.victim_snapshot()
        except Exception:
            pass

    def snapshot_tick(self) -> bool:
        """One snapshot_once; only a SUCCESSFUL write advances the crash
        baseline (a snapshot.write fault leaves the old baseline — the
        next kill is charged back to the last intact snapshot)."""
        try:
            self.snap.snapshot_once()
        except Exception:
            return False
        self.ledger.note_snapshot()
        return True

    # -- nemesis verbs -----------------------------------------------------

    def apply_action(self, action: dict) -> None:
        cls = action["cls"]
        if cls == "fault_site":
            self.set_faults(action["role"], action["spec"])
        elif cls == "process_kill":
            self.kill(action["role"])
        elif cls == "clock_skew":
            self.skew(
                action["role"],
                offset_s=action["offset_s"],
                drift_ppm=action["drift_ppm"],
            )
        elif cls == "partition":
            if action["op"] == "cut":
                self.partition()
            else:
                self.heal()
        elif cls == "snapshot_corrupt":
            self.corrupt_snapshot()
        else:
            raise ValueError(f"unknown nemesis class {cls!r}")

    def set_faults(self, role: str, spec: str) -> None:
        """Runtime fault reconfiguration — the same parse + configure the
        POST /debug/faults endpoint and sidecar OP_FAULTS_SET run."""
        rules = parse_fault_spec(spec)
        self.injectors[role].configure(rules)
        for rule in rules:
            if rule.site == "victim.demote" and rule.kind in ("drop", "error"):
                fires = rule.times if rule.times > 0 else 4
                self.ledger.note_demote_drop_budget(
                    fires * self.lease_limit
                )

    def skew(self, role: str, offset_s: float, drift_ppm: float) -> None:
        self.clocks[role].set_skew(offset_s=offset_s, drift_ppm=drift_ppm)

    def partition(self) -> None:
        self._partitioned.set()
        with self._conn_lock:
            for conn in self._conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()
            self._conns.clear()

    def heal(self) -> None:
        self._partitioned.clear()

    def corrupt_snapshot(self) -> None:
        """Flip a byte mid-file in every on-disk snapshot artifact — the
        restore CRC rejects them all, so the next owner kill cold-boots
        and the ledger charges the full counter loss to the crash term."""
        corrupted = False
        for root, _dirs, files in os.walk(self.snap_dir):
            for fname in sorted(files):
                path = os.path.join(root, fname)
                try:
                    size = os.path.getsize(path)
                    if size == 0:
                        continue
                    with open(path, "r+b") as f:
                        f.seek(size // 2)
                        byte = f.read(1)
                        f.seek(size // 2)
                        f.write(bytes([byte[0] ^ 0xFF]) if byte else b"\xff")
                    corrupted = True
                except OSError:
                    pass
        if corrupted:
            self.ledger.note_snapshot_corrupt()

    def kill(self, role: str) -> None:
        if role == "owner":
            self._harvest_engine_counters()
            try:
                self.engine.close()
            except Exception:
                pass
            self._build_owner(first=False)
            self.snap = self._new_snapshotter(self.engine)
            try:
                stats = self.snap.restore()
                restored = bool(stats.get("restored"))
            except Exception:
                restored = False
            self.ledger.note_owner_kill(
                restored, keys=sorted(self._lease_keys)
            )
        elif role in ("east", "west"):
            old = self.coords[role]
            self._fed_reclaimed_accum += int(old.reclaimed_tokens_total)
            try:
                old.close()
            except Exception:
                pass
            self.coords[role] = self._new_coord(role)
            self.ledger.note_fed_kill(
                role, sorted(self.fed_fps), self.fed_limit
            )
        else:
            raise ValueError(f"unknown role {role!r}")

    # -- end-of-run accounting --------------------------------------------

    def _harvest_engine_counters(self) -> None:
        """Fold the dying engine incarnation's eviction losses into the
        ledger (counters are per-incarnation; a rebuild starts at 0). The
        tier is always on here (victim_max_rows > 0), and every name is
        read directly: a missing one raises rather than reading 0."""
        self.ledger.note_evict_loss(
            int(self.engine.victim_tier.overflow_lost_count_sum)
        )
        # leases the crash strands: granted budget the snapshot may not
        # cover — conservatively part of the lease slack
        self._lease_outstanding_lost += int(
            self.engine.lease_registry.outstanding()[1]
        )

    def finalize(self) -> dict:
        """Harvest the live incarnations and emit the checker inputs."""
        self._harvest_engine_counters()
        fed_reclaimed = self._fed_reclaimed_accum + sum(
            int(self.coords[n].reclaimed_tokens_total)
            for n in ("east", "west")
        )
        lease_outstanding = int(self.engine.lease_registry.outstanding()[1])
        lease_outstanding += self._lease_outstanding_lost
        key_limits = {k: self.lease_limit for k in sorted(self._lease_keys)}
        key_kinds = {k: "lease" for k in self._lease_keys}
        for key in self.fed_fps:
            key_limits[key] = self.fed_limit
            key_kinds[key] = "fed"
        return {
            "ledger": self.ledger.finalize(),
            "key_limits": key_limits,
            "key_kinds": key_kinds,
            "lease_outstanding": lease_outstanding,
            "fed_reclaimed": fed_reclaimed,
        }

    def close(self) -> None:
        self._closing.set()
        for name in ("east", "west"):
            try:
                self.coords[name].close()
            except Exception:
                pass
            try:
                self.listeners[name].close()
            except OSError:
                pass
        try:
            self.cache.close()
        except Exception:
            try:
                self.engine.close()
            except Exception:
                pass
