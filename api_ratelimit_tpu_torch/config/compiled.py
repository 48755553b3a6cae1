"""Port of api_ratelimit_tpu/config/compiled.py: the compiled rule matcher.

The tree walker (config/loader.py RateLimitConfig.get_limit) resolves a
descriptor by composing "key_value" strings and descending the rule trie
level by level on every request. Rate-limit traffic is Zipfian, so the
matcher memoizes instead:

  * a resolve memo: one dict probe per descriptor, keyed by the
    (domain, entries) tuple the transport already built, mapping to a frozen
    ResolvedLimit record;
  * each record carries what the request path needs, computed once: the
    rule and its stat handles, the window divider, the fixed-window
    cache-key prefix (key = prefix + str(window_start), byte-identical to
    limiter/cache_key.py), the 64-bit slab fingerprint split into uint32
    halves, the wire divider word, and the shadow/sleep/report flags;
  * a memo for request-level override rules, so a repeated override
    resolves its stat handles once.

Memo misses resolve through the native matcher when the host codec is
built (ops/native.py): construction flattens the whole rule trie into the
rl_match_batch table (csrc/host_codec.cpp: an open-addressed hash of
(parent node, child key) edges plus per-node limit-index/has-children
arrays, rebuilt with every matcher, so with every load and hot reload).
Without the codec, misses fall back to the tree walker. Either way
resolution equals the walker's, including the reference's composed-key
aliasing quirk (a bare config key "a_b" matches a request entry ("a", "b")).

A matcher is immutable after construction, and a config reload swaps the
whole RateLimitConfig (and with it the matcher and its memos) in one
reference assignment, so a request resolves every descriptor against one
matcher generation.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ALGORITHM_IDS, RateLimit, RateLimitStats
from ..models.descriptors import Descriptor, Entry
from ..models.units import Unit, unit_to_divider
from ..ops.hashing import fingerprint64, xxh64

# Bounds on the lazily filled memos: descriptor values (and override limits)
# are request-controlled, so clear-on-full keeps a key flood bounded.
_RESOLVE_CACHE_MAX = 1 << 16
_OVERRIDE_CACHE_MAX = 1 << 12

_MISS = object()  # memoized "no rule matches this descriptor"

_ALGO_SHIFT = 28  # ops/slab.py ALGO_SHIFT (the config layer imports no torch)


@dataclass(frozen=True, slots=True)
class ResolvedLimit:
    """One descriptor's resolved request-path record. `fp` is
    fingerprint64(domain, entries, divider), the slab identity;
    `key_prefix` + str(window_start) is the string limiter/cache_key.py
    composes. `algorithm` is the rule's id (models/config.py
    ALGORITHM_IDS) and `wire_divider` the divider word the row block ships:
    window length in bits 0-27, algorithm id in bits 28-30 (== divider for
    fixed_window)."""

    limit: RateLimit
    stats: RateLimitStats
    requests_per_unit: int
    divider: int
    key_prefix: str
    fp: int
    fp_lo: int
    fp_hi: int
    shadow_mode: bool
    sleep_on_throttle: bool
    report_details: bool
    per_second: bool
    algorithm: int
    wire_divider: int


def _key_prefix(domain: str, entries: tuple[Entry, ...]) -> str:
    """The window-independent half of the fixed-window cache key
    (limiter/cache_key.py layout): "<domain>_<k1>_<v1>_..._"."""
    parts = [domain]
    for entry in entries:
        parts.append(entry.key)
        parts.append(entry.value)
    return "_".join(parts) + "_"


def _make_record(
    domain: str, entries: tuple[Entry, ...], limit: RateLimit
) -> ResolvedLimit:
    # window_override_s carries a concurrency rule's idle TTL (those rules
    # have no unit); everything else derives the window from the unit
    divider = limit.window_override_s or unit_to_divider(limit.unit)
    algorithm = ALGORITHM_IDS.get(limit.algorithm, 0)
    fp = fingerprint64(domain, entries, divider)
    return ResolvedLimit(
        limit=limit,
        stats=limit.stats,
        requests_per_unit=limit.requests_per_unit,
        divider=divider,
        key_prefix=_key_prefix(domain, entries),
        fp=fp,
        fp_lo=fp & 0xFFFFFFFF,
        fp_hi=fp >> 32,
        shadow_mode=limit.shadow_mode,
        sleep_on_throttle=limit.sleep_on_throttle,
        report_details=limit.report_details,
        per_second=limit.unit == Unit.SECOND,
        algorithm=algorithm,
        wire_divider=divider | (algorithm << _ALGO_SHIFT),
    )


def descriptor_dotted_key(descriptor: Descriptor) -> str:
    """A descriptor's dotted path ("k1_v1.k2"): the full key of a
    request-level override rule."""
    parts = []
    for entry in descriptor.entries:
        part = entry.key
        if entry.value != "":
            part += f"_{entry.value}"
        parts.append(part)
    return ".".join(parts)


def _flatten_trie(domains):
    """Flatten the loaded rule trie into the native matcher's table
    (ops/native.py MatcherTable) plus the rule list its limit indices point
    into. Node 0 is a virtual root whose children are the domains; every
    (parent node, child map key) edge becomes one hash-table entry keyed by
    xxh64(key bytes, seed=parent id), the hash family the C side probes
    with. Returns (MatcherTable, rules), or None when the native codec is
    not loaded."""
    from ..ops import native as native_mod

    if not native_mod.available():
        return None
    import numpy as np

    rules: list[RateLimit] = []
    n_limit = [-1]  # node 0: the virtual root
    n_children = [1 if domains else 0]
    edges: list[tuple[int, bytes, int]] = []

    def add_node(limit, has_children: bool) -> int:
        idx = len(n_limit)
        if limit is None:
            n_limit.append(-1)
        else:
            n_limit.append(len(rules))
            rules.append(limit)
        n_children.append(1 if has_children else 0)
        return idx

    def flatten(node, parent_idx: int) -> None:
        for key, child in node.children.items():
            idx = add_node(child.limit, bool(child.children))
            edges.append((parent_idx, key.encode(), idx))
            flatten(child, idx)

    for domain, root in domains.items():
        idx = add_node(root.limit, bool(root.children))
        edges.append((0, domain.encode(), idx))
        flatten(root, idx)

    ht_size = 4
    while ht_size < 2 * len(edges) + 2:
        ht_size <<= 1
    ht = np.zeros(ht_size, dtype=np.uint64)
    mask = ht_size - 1
    e_parent = np.empty(len(edges), dtype=np.uint32)
    e_node = np.empty(len(edges), dtype=np.uint32)
    e_key_off = np.empty(len(edges), dtype=np.uint64)
    e_key_len = np.empty(len(edges), dtype=np.uint32)
    blob = bytearray()
    for i, (parent, key, node_idx) in enumerate(edges):
        e_parent[i] = parent
        e_node[i] = node_idx
        e_key_off[i] = len(blob)
        e_key_len[i] = len(key)
        blob += key
        slot = xxh64(key, parent) & mask
        while ht[slot]:
            slot = (slot + 1) & mask
        ht[slot] = i + 1
    table = native_mod.MatcherTable(
        ht,
        e_parent,
        e_node,
        e_key_off,
        e_key_len,
        np.frombuffer(bytes(blob) or b"\0", dtype=np.uint8).copy(),
        np.asarray(n_limit, dtype=np.int32),
        np.asarray(n_children, dtype=np.uint8),
    )
    return table, rules


class CompiledMatcher:
    """Memoized lookup over a loaded rule tree: `resolve` returns a
    descriptor's full record, or None when no rule matches."""

    __slots__ = (
        "_walk",
        "_new_rate_limit",
        "_domains",
        "_resolve_cache",
        "_override_cache",
        "_native_table",
        "_native_rules",
    )

    def __init__(self, tree_walker, new_rate_limit, domains):
        """tree_walker: (domain, descriptor) -> RateLimit | None, the
        loader's trie walk. new_rate_limit: factory for request-level
        override rules (RateLimitConfig._new_rate_limit). domains: the
        loaded domains; an override applies only to a configured domain
        (config_impl.go:273-278)."""
        self._walk = tree_walker
        self._new_rate_limit = new_rate_limit
        self._domains = domains
        self._resolve_cache: dict = {}
        self._override_cache: dict = {}
        # the native memo-miss matcher: the flattened trie for
        # rl_match_batch, rebuilt with every matcher. Optional: a failed
        # build keeps the tree walker and never fails a config load
        self._native_table = None
        self._native_rules: list[RateLimit] = []
        try:
            flat = _flatten_trie(domains)
        except Exception:  # noqa: BLE001 - the native path is best-effort
            flat = None
        if flat is not None:
            self._native_table, self._native_rules = flat

    @property
    def native_active(self) -> bool:
        """True when memo misses resolve through rl_match_batch."""
        return self._native_table is not None

    def match_uncached(self, domain: str, descriptor: Descriptor):
        """The memo-miss matcher, bypassing the resolve cache: the native
        flattened-trie walk when built, else the tree walker."""
        if self._native_table is not None:
            from ..ops import native as native_mod

            strings = [domain]
            for entry in descriptor.entries:
                strings.append(entry.key)
                strings.append(entry.value)
            idx = int(native_mod.match_batch(self._native_table, [strings])[0])
            return None if idx < 0 else self._native_rules[idx]
        return self._walk(domain, descriptor)

    def resolve(self, domain: str, descriptor: Descriptor) -> ResolvedLimit | None:
        if descriptor.limit is not None:
            if domain not in self._domains:
                return None
            return self._resolve_override(domain, descriptor)
        cache = self._resolve_cache
        key = (domain, descriptor.entries)
        record = cache.get(key)
        if record is not None:
            return None if record is _MISS else record
        limit = self.match_uncached(domain, descriptor)
        record = _MISS if limit is None else _make_record(
            domain, descriptor.entries, limit
        )
        if len(cache) >= _RESOLVE_CACHE_MAX:
            cache.clear()
        cache[key] = record
        return None if record is _MISS else record

    def _resolve_override(
        self, domain: str, descriptor: Descriptor
    ) -> ResolvedLimit:
        """Request-level override (config_impl.go:281-290): an ad-hoc rule
        keyed by the descriptor's dotted path, memoized."""
        override = descriptor.limit
        cache = self._override_cache
        key = (
            domain,
            descriptor.entries,
            override.requests_per_unit,
            override.unit,
        )
        record = cache.get(key)
        if record is None:
            limit = self._new_rate_limit(
                override.requests_per_unit,
                Unit(override.unit),
                f"{domain}.{descriptor_dotted_key(descriptor)}",
            )
            record = _make_record(domain, descriptor.entries, limit)
            if len(cache) >= _OVERRIDE_CACHE_MAX:
                cache.clear()
            cache[key] = record
        return record
