"""Port of api_ratelimit_tpu/parallel/sharded_slab.py: the multi-device engine.

The slab's rows are split over the shards of a mesh: shard d holds an
independent W-way slab of n_global / n_shards rows, and a key lives only on
its owner shard, (fp_lo ^ fp_hi) mod n_shards, as a Redis Cluster client
hashes each key to its owning node (src/redis/driver_impl.go:104-110). Each
shard's launch is the single-device step (ops/slab.py _slab_update_sorted
or _slab_step_sorted: the way scan kernel, then the apply kernel), so window
rollover, duplicate serialization, the collision policy and the decision are
the single-device engine's; the shard boundary only selects which table a
key lives in.

A mesh here is a tuple of torch devices, one per shard (make_mesh). Entries
may repeat: several shards on one card are the counterpart of the
reference's forced multi-device CPU mesh, and tests run ["cpu"] * n. One
engine's shards are all CUDA or all CPU.

Three arms, each launching every shard's step in shard order on its
device's current stream:

    routed      (routed=True, SHARD_ROUTED_BATCHING, the default): the host
                buckets the valid rows by owner; each non-empty shard gets
                its own power-of-two block (128 lanes at least) and one
                launch; the shards' health vectors sum on the host
    compact     (routed=False): the same per-shard launches, every shard
                padded to one global bucket sized to the fullest shard. The
                reference runs this arm as one SPMD program; the port has
                none, so it is the routed arm with the reference's padding,
                and gives the routed arm's bytes
    replicated  (step_packed, step_after; compact engines only): every
                shard runs the whole block with the lanes it does not own
                set to hits 0 (padding), unsorts its own output and zeroes
                those lanes; the reference's lax.psum over the mesh becomes
                a select of each lane's owner output on the first shard's
                device, exact because only the owner's lane is non-zero

The hot-key tier (hot_tier=True, HOT_TIER_ENABLED; routed arm, power-of-two
shard counts) salts a hot key across K shards (ops/hashing.py hot_slice_fp),
each slice enforcing ceil(limit / K); demotion settles the slices back into
the home row, keep-the-newest. hotkey_lanes > 0 arms HostTopK
(ops/sketch.py), the mesh engine's sketch, which feeds the tier and the
hotkeys surface.

The sticky algorithms guard flips the engine to the multi-algorithm body for
good on the first non-fixed row or restored table, as SlabDeviceEngine's
does; the reference's guard moves its kernels to the XLA twin instead.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.hashing import hot_slice_fp, set_index
from ..ops.slab import (
    ALGO_SHIFT,
    COL_COUNT,
    COL_DIVIDER,
    COL_EXPIRE,
    COL_FP_HI,
    COL_FP_LO,
    COL_WINDOW,
    HEALTH_ALGO_RESETS,
    HEALTH_DROPS,
    HEALTH_EVICT_EXPIRED,
    HEALTH_EVICT_LIVE,
    HEALTH_EVICT_WINDOW,
    HEALTH_WIDTH,
    ROW_DIVIDER,
    ROW_FP_HI,
    ROW_FP_LO,
    ROW_HITS,
    ROW_LIMIT,
    ROW_SCALARS,
    ROW_WIDTH,
    _slab_step_sorted,
    _slab_update_sorted,
    _u32,
    _unpack,
    _unsort,
    default_ways,
    find_row_host,
    live_slot_count,
    make_slab,
    resolve_device,
    slab_export_copy,
    slab_export_device,
    slab_export_host,
    slab_import_rows,
    validate_ways,
)

_log = logging.getLogger(__name__)

SHARD_AXIS = "shard"


class Mesh(NamedTuple):
    """The shards' devices, one entry a shard (repeats allowed), and the
    axis name."""

    devices: tuple
    axis: str = SHARD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = SHARD_AXIS) -> Mesh:
    """A mesh over the given devices (one shard each), or one shard on each
    card present. A CUDA entry raises without a card; CPU and CUDA shards
    do not mix."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's shards must all be on cuda or all on the cpu, got {devs}")
    return Mesh(devs, axis)


def mesh_devices(n_shards: int, device="cuda") -> list:
    """TPU_MESH_DEVICES=N's placement: shard i on cuda:(i mod the cards
    present), or N CPU shards with device="cpu" (tests). The reference
    takes jax.devices()[:N] and so shrinks the mesh to the devices there;
    here the shard count, and with it the snapshot layout, is N on every
    box. The placement is logged."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    kind = resolve_device(device).type
    if kind == "cpu":
        devices = ["cpu"] * n_shards
    else:
        cards = torch.cuda.device_count()
        devices = [f"cuda:{i % cards}" for i in range(n_shards)]
    _log.info("mesh of %d shards: %s", n_shards, ", ".join(devices))
    return devices


def _narrow_dtype(cap: int) -> torch.dtype:
    """The readback width a cap fits, as the reference narrows."""
    if cap <= 0xFF:
        return torch.uint8
    if cap <= 0xFFFF:
        return torch.uint16
    return torch.uint32


def _pcts(samples) -> dict:
    """p50/p99 of a timing deque (ns); zeros when empty."""
    if not samples:
        return {"p50": 0, "p99": 0}
    arr = np.fromiter(samples, dtype=np.int64)
    return {"p50": int(np.percentile(arr, 50)), "p99": int(np.percentile(arr, 99))}


class _HotKey:
    """Hot-set entry: the key's fp halves, its promotion epoch, and the
    round-robin cursor that deals its rows across the K salted slices."""

    __slots__ = ("lo", "hi", "epoch", "rr")

    def __init__(self, lo: int, hi: int, epoch: int):
        self.lo = int(lo)
        self.hi = int(hi)
        self.epoch = int(epoch)
        self.rr = 0


class ShardedSlabEngine:
    """The slab over the shards of a mesh, with the packed-block protocol of
    ops/slab.py (uint32[7, b] in, post-increment counters out in arrival
    order). n_slots_global must split into a power-of-two row count a
    shard. ways=0 picks the shards' platform default (128 on the card, 4 on
    the CPU).

    Verbs: launch_after_compact / collect_after_compact (and
    step_after_compact, both in one) serve either arm; step_packed and
    step_after are the replicated arm's and raise on a routed engine.
    shard_launches counts each shard's steps (one way scan and one apply
    each)."""

    def __init__(
        self,
        mesh: Mesh | None = None,
        n_slots_global: int = 1 << 22,
        ways: int = 0,
        routed: bool = False,
        hot_tier: bool = False,
        hot_salt_ways: int = 0,
        hotkey_lanes: int = 0,
        hotkey_k: int = 16,
        hot_min_count: int = 4096,
    ):
        if mesh is None:
            mesh = make_mesh()
        elif not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh)
        self.mesh = mesh
        n_dev = mesh.size
        n_local, rem = divmod(n_slots_global, n_dev)
        if rem or n_local <= 0 or n_local & (n_local - 1):
            raise ValueError(
                f"n_slots_global={n_slots_global} must be n_devices ({n_dev}) x a power of two"
            )
        self.n_slots_global = n_slots_global
        # every set lives wholly on one shard: the owner hash picks the
        # shard, the set index a set within the shard's own table, so each
        # shard's snapshot is a flat (n_local, ROW_WIDTH) table
        self._devices = list(mesh.devices)
        if not ways:
            ways = default_ways(self._devices[0].type)
        self.ways = validate_ways(n_local, ways)
        self._routed = bool(routed)
        self._cuda = self._devices[0].type == "cuda"
        self._states = [make_slab(n_local, d) for d in self._devices]
        # the sticky algorithms guard: False keeps every launch on the
        # fixed-window body
        self._algos_seen = False
        # cumulative mesh-wide health (ops/slab.py HEALTH_* layout)
        self.health_totals = [0] * HEALTH_WIDTH
        # serializes every launch, settle, export and import against the
        # health drain and the occupancy read
        self._state_lock = threading.Lock()
        self._pending_health: list = []
        self.shard_launches = [0] * n_dev

        # -- routing telemetry (both arms; shard_routing_snapshot) --
        self._launches = 0
        self._rows_routed = 0  # valid rows dispatched
        self._padded_lanes = 0  # lanes launched, padding included
        self._shard_rows = [0] * n_dev
        self._t_bucket_ns: collections.deque = collections.deque(maxlen=4096)
        self._t_pad_ns: collections.deque = collections.deque(maxlen=4096)
        self._t_launch_ns: collections.deque = collections.deque(maxlen=4096)

        # -- the replicated hot-key tier (routed arm only) --
        hot_tier = bool(hot_tier)
        if hot_tier and not self._routed:
            _log.warning(
                "hot-key tier needs routed per-shard batching; disabled "
                "(SHARD_ROUTED_BATCHING is off)"
            )
            hot_tier = False
        if hot_tier and n_dev & (n_dev - 1):
            # the salt steers the owner hash by XOR on its low bits, a
            # bijection only for a power-of-two shard count
            _log.warning("hot-key tier needs a power-of-two shard count, got %d; disabled", n_dev)
            hot_tier = False
        self._hot_tier = hot_tier
        salt_ways = int(hot_salt_ways) or n_dev
        self._salt_ways = max(1, min(salt_ways, n_dev))
        self._hot_lock = threading.Lock()
        self._hot: dict[int, _HotKey] = {}  # combined uint64 fp -> entry
        self._hot_combined = np.empty(0, dtype=np.uint64)
        self._hot_epoch = 0
        self._hot_promotions = 0
        self._hot_demotions = 0
        self._hot_settle_drops = 0
        self._hot_min_count = max(0, int(hot_min_count))

        # -- the host top-K (the mesh engine's sketch) --
        self._hotkey_k = max(1, int(hotkey_k))
        self._hotkey_lanes = int(hotkey_lanes)
        self._hostkeys = None
        if self._hotkey_lanes > 0:
            from ..ops.sketch import HostTopK

            self._hostkeys = HostTopK(self._hotkey_lanes)
        self._hotkeys_lock = threading.Lock()
        self._hot_fps: frozenset = frozenset()
        self._hotkey_drains = 0
        self._hotkey_listeners: list = []
        self._last_topk: list = []

    @property
    def devices(self) -> list:
        """Each shard's torch device, in shard order."""
        return list(self._devices)

    @property
    def algos_seen(self) -> bool:
        return self._algos_seen

    def note_algos_seen(self) -> None:
        """Flip the sticky algorithms guard: every later launch runs the
        multi-algorithm body. Called by the backend when its own guard
        flips, by import_tables on a restored table with algorithm rows,
        and by _guard_algos on direct use."""
        if not self._algos_seen:
            self._algos_seen = True
            _log.info("non-fixed rate-limit algorithm: mesh launches now run the multi-algorithm body")

    def _guard_algos(self, packed: np.ndarray) -> None:
        """Any valid lane (hits > 0) with a non-fixed algorithm id flips the
        guard before the launch."""
        if self._algos_seen:
            return
        valid = packed[ROW_HITS] > 0
        if valid.any() and int(packed[ROW_DIVIDER][valid].max()) >= (1 << ALGO_SHIFT):
            self.note_algos_seen()

    def _require_replicated(self, what: str) -> None:
        if self._routed:
            raise RuntimeError(
                f"{what} is a replicated-arm path; the routed engine serves "
                f"launches through launch_after_compact/collect_after_compact only"
            )

    def _on(self, d: int):
        """The shard's card made current for its launch (its kernels go on
        that card's current stream); nothing on the CPU."""
        if self._cuda:
            return torch.cuda.device(self._devices[d])
        return contextlib.nullcontext()

    # -- the replicated arm --------------------------------------------

    def _owners(self, packed: np.ndarray) -> np.ndarray:
        """int64[b] owner shard of every lane: (fp_lo ^ fp_hi) mod n_dev,
        the formula the routing pass uses."""
        return ((packed[ROW_FP_LO] ^ packed[ROW_FP_HI]) % np.uint32(len(self._devices))).astype(np.int64)

    def _replicated(self, packed: np.ndarray, body) -> torch.Tensor:
        """Run `body(d, state, masked block) -> (rows [.., b] in arrival
        order, health)` on every shard, each with the lanes it does not own
        at hits 0, and keep each lane's owner output, on the first shard's
        device."""
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        owner = self._owners(packed)
        dev0 = self._devices[0]
        owner_dev = torch.from_numpy(owner).to(dev0)
        combined = None
        with self._state_lock:
            for d, state in enumerate(self._states):
                blk = packed.copy()
                blk[ROW_HITS, owner != d] = 0
                with self._on(d):
                    out, health = body(state, blk)
                self.shard_launches[d] += 1
                self._note_health(health)
                out = out.to(dev0)
                combined = out if combined is None else torch.where(owner_dev == d, out, combined)
        return combined

    def step_packed(self, packed: np.ndarray) -> np.ndarray:
        """One replicated launch with the decision on the shards
        (_slab_step_sorted, the fused decide apply on the card). packed:
        uint32[7, b] -> uint32[8, b] in arrival order (code, remaining,
        duration, throttle, near, over, before, after)."""
        self._require_replicated("step_packed")
        self._guard_algos(packed)
        multi = self._algos_seen

        def body(state, blk):
            batch, now, near, burst = _unpack(blk, state.device)
            s_before, s_after, d, order, health = _slab_step_sorted(
                state, batch, now, near, self.ways, multi_algo=multi, burst_ratio=burst
            )
            rows = torch.stack([f.to(torch.int32) for f in (*d, s_before, s_after)])
            out = torch.empty_like(rows)
            out[:, order] = rows
            return out, health

        return self._replicated(packed, body).view(torch.uint32).cpu().numpy()

    def step_after(self, packed: np.ndarray, cap: int = 0xFFFFFFFF) -> np.ndarray:
        """The replicated arm's after mode: the post-increment counter of
        every lane in arrival order, saturated at cap and narrowed to the
        smallest width cap fits."""
        self._require_replicated("step_after")
        self._guard_algos(packed)
        multi = self._algos_seen

        def body(state, blk):
            batch, now, _near, burst = _unpack(blk, state.device)
            _b, s_after, _in, order, health, _d = _slab_update_sorted(
                state, batch, now, self.ways, multi_algo=multi, burst_ratio=burst
            )
            return torch.clamp(_u32(_unsort(s_after, order)), max=cap), health

        return self._replicated(packed, body).to(_narrow_dtype(cap)).cpu().numpy()

    # -- the routed and compact arms ----------------------------------

    def step_after_compact(self, packed: np.ndarray, cap: int = 0xFFFFFFFF) -> np.ndarray:
        """Owner routing on the host and the per-shard launches: packed
        uint32[7, b] -> uint32[b] post-increment counters in arrival
        order."""
        return self.collect_after_compact(self.launch_after_compact(packed, cap))

    def _shard_after(self, d: int, blk: np.ndarray, cap: int, multi: bool):
        """One shard's launch of its own block: (its counters in block
        order, saturated at cap and narrowed, on its device; health)."""
        state = self._states[d]
        with self._on(d):
            batch, now, _near, burst = _unpack(blk, state.device)
            _b, s_after, _in, order, health, _d = _slab_update_sorted(
                state, batch, now, self.ways, multi_algo=multi, burst_ratio=burst
            )
            after = torch.clamp(_u32(_unsort(s_after, order)), max=cap).to(_narrow_dtype(cap))
        self.shard_launches[d] += 1
        return after, health

    def launch_after_compact(self, packed: np.ndarray, cap: int = 0xFFFFFFFF, min_bucket: int = 128):
        """The launch half of step_after_compact: route on the host, launch
        every shard's block, and return a token for collect_after_compact.
        min_bucket floors the bucket ladder (the routed arm keeps its
        per-shard floor at 128 whatever is passed)."""
        self._guard_algos(packed)
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        n_dev = len(self._devices)
        b = packed.shape[1]
        t0 = time.perf_counter_ns()
        valid_idx = np.flatnonzero(packed[ROW_HITS] > 0)
        if valid_idx.size == 0:
            return {"mode": "routed" if self._routed else "compact", "afters": None, "b": b}

        # the host top-K sees home fingerprints, before any salting
        if self._hostkeys is not None:
            with self._hotkeys_lock:
                self._hostkeys.update(
                    packed[ROW_FP_LO, valid_idx], packed[ROW_FP_HI, valid_idx], packed[ROW_HITS, valid_idx]
                )

        hot_remap = None
        hot_epoch = 0
        if self._hot_tier:
            packed, hot_remap, hot_epoch = self._salt_hot(packed, valid_idx)

        # the owner formula of the replicated arm (_owners)
        owner = ((packed[ROW_FP_LO, valid_idx] ^ packed[ROW_FP_HI, valid_idx]) % np.uint32(n_dev)).astype(np.int64)
        counts = np.bincount(owner, minlength=n_dev)
        route = np.argsort(owner, kind="stable")
        routed_idx = valid_idx[route]  # original positions, shard-grouped
        starts = np.zeros(n_dev + 1, dtype=np.int64)
        starts[1:] = np.cumsum(counts)
        t1 = time.perf_counter_ns()

        if self._routed:
            # each non-empty shard padded to its own rung, floor 128
            buckets = {}
            for d in range(n_dev):
                c = int(counts[d])
                if c:
                    bucket = 128
                    while bucket < max(int(min_bucket), c):
                        bucket <<= 1
                    buckets[d] = bucket
        else:
            # every shard padded to one bucket sized to the fullest
            bucket = 128
            while bucket < max(int(min_bucket), int(counts.max())):
                bucket <<= 1
            buckets = dict.fromkeys(range(n_dev), bucket)
        blocks = {}
        for d, bucket in buckets.items():
            c = int(counts[d])
            blk = np.zeros((7, bucket), dtype=np.uint32)
            blk[:, :c] = packed[:, routed_idx[starts[d] : starts[d] + c]]
            # the per-item copy carried other lanes into the scalar row:
            # restamp `now`, near_ratio and the burst ratio
            blk[ROW_SCALARS, : min(3, b)] = packed[ROW_SCALARS, :3]
            if self._routed:
                # the hot-set epoch rides the free scalar column 3: the
                # device ignores it, a captured operand names the hot set
                blk[ROW_SCALARS, 3] = np.uint32(hot_epoch)
            blocks[d] = blk
        t2 = time.perf_counter_ns()

        multi = self._algos_seen
        afters = {}
        with self._state_lock:
            for d, blk in blocks.items():
                afters[d], health = self._shard_after(d, blk, cap, multi)
                self._note_health(health)
            self._note_routing_locked(
                counts, sum(blk.shape[1] for blk in blocks.values()), t0, t1, t2, time.perf_counter_ns()
            )
        return {
            "mode": "routed" if self._routed else "compact",
            "afters": afters,
            "routed_idx": routed_idx,
            "starts": starts,
            "counts": counts,
            "b": b,
            "hot_remap": hot_remap,
        }

    def collect_after_compact(self, token) -> np.ndarray:
        """The blocking half: read each shard's counters back and unscatter
        them to arrival order with the launch's routing permutation."""
        out = np.zeros(token["b"], dtype=np.uint32)
        afters = token["afters"]
        if afters is None:  # the launch saw no valid lane
            return out
        routed_idx, starts, counts = token["routed_idx"], token["starts"], token["counts"]
        for d, after in afters.items():
            c = int(counts[d])
            out[routed_idx[starts[d] : starts[d] + c]] = after[:c].cpu().numpy().astype(np.uint32)
        self._remap_hot(out, token["hot_remap"])
        return out

    @staticmethod
    def _remap_hot(out: np.ndarray, hot_remap) -> None:
        """Rewrite hot rows' slice counters so the caller's `after > limit`
        compare yields the slice's own verdict: an under-quota slice
        reports its count (<= quota <= limit), an over-quota slice limit +
        its overshoot. In place, arrival order."""
        if hot_remap is None:
            return
        sel, limits, quotas = hot_remap
        vals = out[sel]
        out[sel] = np.where(vals <= quotas, vals, limits + (vals - quotas))

    # -- the replicated hot-key tier ------------------------------------

    def _salt_hot(self, packed: np.ndarray, valid_idx: np.ndarray):
        """Rewrite hot-key rows to their salted slice fingerprints and split
        quotas. Returns (packed', hot_remap, epoch); packed is copied only
        when a hot row is present. A key's rows deal round-robin over the K
        slices, so one batch's duplicates spread over shards. Only
        fixed-window rows salt: a sliding or GCRA row's state has no
        split-quota rule."""
        with self._hot_lock:
            if not self._hot_combined.size:
                return packed, None, self._hot_epoch
            lo = packed[ROW_FP_LO, valid_idx].astype(np.uint64)
            hi = packed[ROW_FP_HI, valid_idx].astype(np.uint64)
            combined = lo | (hi << np.uint64(32))
            mask = np.isin(combined, self._hot_combined)
            mask &= packed[ROW_DIVIDER, valid_idx] < np.uint32(1 << ALGO_SHIFT)
            if not mask.any():
                return packed, None, self._hot_epoch
            packed = packed.copy()
            K = self._salt_ways
            n_dev = len(self._devices)
            sel = valid_idx[mask]
            limits = packed[ROW_LIMIT, sel].copy()
            quotas = np.empty_like(limits)
            for i, (pos, comb) in enumerate(zip(sel.tolist(), combined[mask].tolist())):
                entry = self._hot[comb]
                slot = entry.rr % K
                entry.rr += 1
                lo2, hi2 = hot_slice_fp(packed[ROW_FP_LO, pos], packed[ROW_FP_HI, pos], slot, n_dev)
                packed[ROW_FP_LO, pos] = lo2
                packed[ROW_FP_HI, pos] = hi2
                q = -(-int(packed[ROW_LIMIT, pos]) // K)  # ceil(limit / K)
                packed[ROW_LIMIT, pos] = np.uint32(q)
                quotas[i] = q
            return packed, (sel, limits, quotas), self._hot_epoch

    @property
    def hot_tier_enabled(self) -> bool:
        return self._hot_tier

    def promote_hot(self, fp_lo: int, fp_hi: int) -> bool:
        """Admit a key into the hot tier: membership only, no device
        traffic. Slot 0's salt is the identity, so the home row is slice 0
        and the window's count carries in, enforced from now on against
        ceil(limit / K). Bumps the epoch."""
        if not self._hot_tier:
            return False
        comb = (int(fp_lo) & 0xFFFFFFFF) | ((int(fp_hi) & 0xFFFFFFFF) << 32)
        with self._hot_lock:
            if comb in self._hot:
                return False
            self._hot_epoch += 1
            self._hot[comb] = _HotKey(fp_lo, fp_hi, self._hot_epoch)
            self._hot_combined = np.fromiter(self._hot.keys(), dtype=np.uint64, count=len(self._hot))
            self._hot_promotions += 1
        return True

    def demote_hot(self, fp_lo: int, fp_hi: int, now: int | None = None) -> dict:
        """Remove a key from the hot tier and settle its slices back into
        the home row. Returns the settlement report."""
        comb = (int(fp_lo) & 0xFFFFFFFF) | ((int(fp_hi) & 0xFFFFFFFF) << 32)
        with self._hot_lock:
            entry = self._hot.pop(comb, None)
            if entry is None:
                return {"demoted": False}
            self._hot_epoch += 1
            self._hot_combined = np.fromiter(self._hot.keys(), dtype=np.uint64, count=len(self._hot))
            self._hot_demotions += 1
        return self._settle_slices(int(fp_lo), int(fp_hi), now)

    def _settle_slices(self, fp_lo: int, fp_hi: int, now: int | None) -> dict:
        """Demotion settlement, under the state lock: read each slice's row
        on the host, merge keep-the-newest (the greatest window wins; the
        counts within it sum, each slice having counted a disjoint share),
        zero the slice rows and land the merged row at the home placement
        (a drop, counted, when the home set holds only other live keys).
        The touched shards' tables go back to their devices."""
        if now is None:
            from ..utils.timeutil import process_time_source

            now = process_time_source().unix_now()
        n_dev = len(self._devices)
        K = self._salt_ways
        report = {"demoted": True, "settled": 0, "count": 0, "landed": False}
        with self._state_lock:
            tables: dict[int, np.ndarray] = {}
            found: list[tuple[int, int, int]] = []  # (slot, shard, row)
            for slot in range(K):
                lo2, hi2 = hot_slice_fp(fp_lo, fp_hi, slot, n_dev)
                shard = int((int(lo2) ^ int(hi2)) % n_dev)
                tab = tables.get(shard)
                if tab is None:
                    tab = tables[shard] = slab_export_copy(self._states[shard])
                ridx = find_row_host(tab, int(lo2), int(hi2), self.ways)
                if ridx >= 0:
                    found.append((slot, shard, ridx))
            if not found:
                return report
            rows = [tables[s][r].copy() for (_slot, s, r) in found]
            win = max(int(r[COL_WINDOW]) for r in rows)
            total = sum(int(r[COL_COUNT]) for r in rows if int(r[COL_WINDOW]) == win)
            # slot 0, when live, carries the key's metadata; any slice
            # serves otherwise (divider and expire agree within a window)
            merged = next((tables[s][r].copy() for (slot, s, r) in found if slot == 0), rows[0])
            merged[COL_FP_LO] = np.uint32(fp_lo)
            merged[COL_FP_HI] = np.uint32(fp_hi)
            merged[COL_COUNT] = np.uint32(min(total, 0xFFFFFFFF))
            merged[COL_WINDOW] = np.uint32(win)
            merged[COL_EXPIRE] = np.uint32(max(int(r[COL_EXPIRE]) for r in rows))
            for (_slot, s, r) in found:
                tables[s][r] = 0
            home_shard = int((fp_lo ^ fp_hi) % n_dev)
            htab = tables.get(home_shard)
            if htab is None:
                htab = tables[home_shard] = slab_export_copy(self._states[home_shard])
            place = self._find_landing(htab, fp_lo, int(now))
            if place >= 0:
                htab[place] = merged
                report["landed"] = True
            else:
                # the home set holds only other live keys: the merged
                # counter drops (fail-open at the key's next touch)
                self._hot_settle_drops += 1
            for shard, tab in tables.items():
                self._states[shard] = slab_import_rows(tab, self._devices[shard])
            report["settled"] = len(found)
            report["count"] = total
        return report

    def _find_landing(self, table: np.ndarray, fp_lo: int, now: int) -> int:
        """First free way of the key's home set: never used or reclaimed
        (expire == 0) first, then expired. -1 when every way holds another
        live key (the settle-drop case)."""
        n_sets = table.shape[0] // self.ways
        base = int(set_index(np.uint32(fp_lo), n_sets)) * self.ways
        expire = table[base : base + self.ways, COL_EXPIRE]
        free = np.flatnonzero(expire == 0)
        if free.size:
            return base + int(free[0])
        dead = np.flatnonzero(expire.astype(np.int64) <= int(now))
        if dead.size:
            return base + int(dead[0])
        return -1

    # -- the host top-K (the mesh path's hotkeys surface) --------------
    # SlabDeviceEngine's sketch surface, so HotkeyStats, the journeys'
    # hot flag and the lease sizing work against a mesh engine unchanged

    @property
    def hotkeys_enabled(self) -> bool:
        return self._hostkeys is not None

    @property
    def hot_fps(self) -> frozenset:
        """The last drain's head keys as combined (hi << 32 | lo) ints."""
        return self._hot_fps

    def add_hotkey_listener(self, fn) -> None:
        """fn(top, fps) after every drain."""
        self._hotkey_listeners.append(fn)

    def drain_hotkeys(self) -> list:
        """Read the host top-K's head and decay it; with the hot tier on,
        promote the drained keys at or above hot_min_count and demote hot
        keys that fell below half of it (the band between keeps them)."""
        if self._hostkeys is None:
            return []
        with self._hotkeys_lock:
            top = self._hostkeys.topk(self._hotkey_k)
            self._hostkeys.decay()
            self._last_topk = top
            self._hot_fps = frozenset((hi << 32) | lo for lo, hi, _cnt in top)
            self._hotkey_drains += 1
        if self._hot_tier and self._hot_min_count > 0:
            keep = set()
            for lo, hi, cnt in top:
                comb = (hi << 32) | lo
                if cnt >= self._hot_min_count:
                    keep.add(comb)
                    self.promote_hot(lo, hi)
                elif cnt >= self._hot_min_count // 2:
                    keep.add(comb)
            with self._hot_lock:
                cold = [c for c in self._hot if c not in keep]
            for comb in cold:
                self.demote_hot(comb & 0xFFFFFFFF, comb >> 32)
        for fn in list(self._hotkey_listeners):
            try:
                fn(top, self._hot_fps)
            except Exception:  # noqa: BLE001 - a listener must not break stats
                _log.exception("hotkey listener failed")
        return top

    def hotkeys_snapshot(self) -> dict:
        """The single-device sketch snapshot's shape."""
        with self._hotkeys_lock:
            top = list(self._last_topk)
            drains = self._hotkey_drains
        return {
            "enabled": self._hostkeys is not None,
            "k": self._hotkey_k,
            "lanes": self._hotkey_lanes,
            "drains": drains,
            "top": [{"fp": f"{(hi << 32) | lo:016x}", "count": cnt} for lo, hi, cnt in top],
        }

    # -- routing telemetry ------------------------------------------------

    def _note_routing_locked(self, counts, padded_lanes, t0, t1, t2, t3):
        """Accumulate one launch's routing mix (state lock held): bucket is
        the host owner hash and argsort, pad the block fill, launch the
        shards' step calls (their uploads included)."""
        self._launches += 1
        n_rows = int(counts.sum())
        self._rows_routed += n_rows
        self._padded_lanes += int(padded_lanes)
        for d, c in enumerate(counts):
            self._shard_rows[d] += int(c)
        self._t_bucket_ns.append(t1 - t0)
        self._t_pad_ns.append(t2 - t1)
        self._t_launch_ns.append(t3 - t2)

    def shard_routing_snapshot(self) -> dict:
        """The cumulative routing mix and the stage split's percentiles: the
        ratelimit.shard.* gauges' source (backends/dispatch.py
        ShardRoutingStats) and hotpath_profile --shard-split's.
        padding_waste_pct is dead lanes as a share of launched lanes."""
        with self._state_lock:
            padded = self._padded_lanes
            rows = self._rows_routed
            waste = 100.0 * (padded - rows) / padded if padded else 0.0
            with self._hot_lock:
                hot = {
                    "enabled": self._hot_tier,
                    "salt_ways": self._salt_ways,
                    "keys": len(self._hot),
                    "epoch": self._hot_epoch,
                    "promotions": self._hot_promotions,
                    "demotions": self._hot_demotions,
                    "settle_drops": self._hot_settle_drops,
                }
            return {
                "enabled": True,
                "routed": self._routed,
                "shards": len(self._shard_rows),
                "launches": self._launches,
                "rows": rows,
                "padded_lanes": padded,
                "padding_waste_pct": round(waste, 3),
                "shard_rows": list(self._shard_rows),
                "hot_tier": hot,
                "stage_ns": {
                    "bucket_ns": _pcts(self._t_bucket_ns),
                    "pad_ns": _pcts(self._t_pad_ns),
                    "launch_ns": _pcts(self._t_launch_ns),
                },
            }

    # -- warm restart (persist/): per-shard export and import --

    @property
    def shard_count(self) -> int:
        return self.mesh.size

    @property
    def shard_slots(self) -> int:
        return self.n_slots_global // self.shard_count

    def export_tables(self) -> list[np.ndarray]:
        """One host table a shard, in shard order. Only the device clones
        are enqueued under the state lock; the drains run after it."""
        with self._state_lock:
            copies = [slab_export_device(s) for s in self._states]
        return [slab_export_host(c, ready) for c, ready in copies]

    def import_tables(self, tables: list[np.ndarray]) -> None:
        """Boot-time restore: one host table a shard. Rows with a non-fixed
        algorithm flip the guard."""
        n_dev = self.shard_count
        if len(tables) != n_dev:
            raise ValueError(f"mesh slab restores from {n_dev} shards, got {len(tables)}")
        full = np.concatenate([np.asarray(t, dtype=np.uint32) for t in tables], axis=0)
        if full.shape != (self.n_slots_global, ROW_WIDTH):
            raise ValueError(
                f"snapshot shards assemble to {full.shape}, slab is ({self.n_slots_global}, {ROW_WIDTH})"
            )
        if not self._algos_seen and int(full[:, COL_DIVIDER].max(initial=0)) >= (1 << ALGO_SHIFT):
            self.note_algos_seen()
        n_local = self.shard_slots
        with self._state_lock:
            self._states = [
                slab_import_rows(full[i * n_local : (i + 1) * n_local], self._devices[i])
                for i in range(n_dev)
            ]

    def synchronize(self) -> None:
        """Wait for every shard's enqueued work (no-op on the CPU)."""
        if self._cuda:
            for dev in dict.fromkeys(self._devices):
                torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def quiesced(self):
        """A context in which no shard launch is in flight or enqueued: the
        state lock, under which every arm's launches, settles, exports and
        imports enqueue, held, and every shard's device synchronized
        (backends/cuda.py launches_quiesced on a mesh)."""
        with self._state_lock:
            self.synchronize()
            yield

    def _note_health(self, health) -> None:
        """Park a launch's health vector; the stats cadence drains it."""
        self._pending_health.append(health)
        if len(self._pending_health) > 4096:
            self._drain_health_locked()

    def _drain_health_locked(self) -> None:
        pending, self._pending_health = self._pending_health, []
        for health in pending:
            for i, v in enumerate(health.cpu().tolist()):
                self.health_totals[i] += int(v)

    def health_snapshot(self, now: int | None = None) -> dict:
        """Cumulative mesh-wide lossy-event counters and live-slot occupancy
        (an O(n_slots) reduction a shard: the stats cadence). `now` is the
        caller's clock; the process clock serves direct use."""
        if now is None:
            from ..utils.timeutil import process_time_source

            now = process_time_source().unix_now()
        with self._state_lock:
            self._drain_health_locked()
            live = sum(live_slot_count(s.table, now) for s in self._states)
            return {
                "evictions_expired": self.health_totals[HEALTH_EVICT_EXPIRED],
                "evictions_window": self.health_totals[HEALTH_EVICT_WINDOW],
                "evictions_live": self.health_totals[HEALTH_EVICT_LIVE],
                "drops": self.health_totals[HEALTH_DROPS],
                "algo_resets": self.health_totals[HEALTH_ALGO_RESETS],
                "live_slots": live,
                "occupancy": live / self.n_slots_global,
            }
