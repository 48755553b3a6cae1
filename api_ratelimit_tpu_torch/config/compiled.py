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

Memo misses resolve through the tree walker only: the reference's native
flattened-trie matcher (rl_match_batch in native/host_codec.cpp) comes with
the port of the native codec. Either way resolution equals the walker's,
including the reference's composed-key aliasing quirk (a bare config key
"a_b" matches a request entry ("a", "b")).

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
from ..ops.hashing import fingerprint64

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


class CompiledMatcher:
    """Memoized lookup over a loaded rule tree: `resolve` returns a
    descriptor's full record, or None when no rule matches."""

    __slots__ = (
        "_walk",
        "_new_rate_limit",
        "_domains",
        "_resolve_cache",
        "_override_cache",
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
        limit = self._walk(domain, descriptor)
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
