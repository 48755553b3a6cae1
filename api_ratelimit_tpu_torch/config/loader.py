"""Port of api_ratelimit_tpu/config/loader.py: the rule tree and its loading.

Rate limit rule tree: strict YAML loading + trie lookup.

Semantics match the reference loader (src/config/config_impl.go):

* Strict key whitelist validated on a generic-YAML pass before typed parsing
  (config_impl.go:48-58,169-209): unknown keys, non-string keys, and lists
  containing non-map elements are config errors.
* Per file: domain must be non-empty (config_impl.go:232-234) and globally
  unique across files (config_impl.go:236-239).
* Descriptors nest recursively. The map key at each level is `key` or
  `key_value` when a value is present (config_impl.go:126-131); duplicates at
  one level are errors (config_impl.go:133-136); the composite dotted full key
  accumulates parent levels. Units are validated case-insensitively and
  UNKNOWN is rejected (config_impl.go:140-147).
* GetLimit walks the trie per request descriptor: at each level try
  `key_value` first then bare `key` (default bucket) (config_impl.go:293-303),
  a limit is only returned when config depth matches request depth exactly
  (config_impl.go:305-312), and descent stops at the first level with no
  children (config_impl.go:314-319). A request-level limit override
  short-circuits the walk and builds an ad-hoc rule keyed by the descriptor's
  dotted path (config_impl.go:281-290).

The port splits loading in two: `parse_config_files` turns YAML text into
mappings (PyYAML is imported only there), and `build_config` builds the
RateLimitConfig from parsed mappings, so a caller holding a mapping needs no
YAML parser. `get_limit` is the trie walk (the reference's get_limit_tree);
`compiled` is the memoized matcher built over the finished tree
(config/compiled.py), which the service's host fast path resolves through
and which falls back to the walk on a memo miss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from ..models.config import (
    ALGORITHM_IDS,
    DEFAULT_CONCURRENCY_TTL_S,
    ConfigError,
    RateLimit,
    new_rate_limit_stats,
)
from ..models.descriptors import Descriptor
from ..models.response import RateLimitValue
from ..models.units import Unit, unit_from_string
from .compiled import CompiledMatcher, descriptor_dotted_key

_VALID_KEYS = frozenset(
    {
        "domain",
        "key",
        "value",
        "descriptors",
        "rate_limit",
        "unit",
        "requests_per_unit",
        "algorithm",
        "sleep_on_throttle",
        "report_details",
        "shadow_mode",
    }
)


@dataclass(frozen=True, slots=True)
class ConfigFile:
    """One YAML file to load: name (used in error messages and as the runtime
    snapshot key) + raw contents."""

    name: str
    contents: str


@dataclass(frozen=True, slots=True)
class ConfigDoc:
    """One parsed config document: its name (for error messages) and the
    mapping a YAML file parses to (`domain`, `descriptors`)."""

    name: str
    doc: object


class _Node:
    """One trie level: children keyed by `key` or `key_value`, optional limit."""

    __slots__ = ("children", "limit")

    def __init__(self):
        self.children: dict[str, _Node] = {}
        self.limit: RateLimit | None = None

    def dump(self) -> str:
        out = ""
        if self.limit is not None:
            out += (
                f"{self.limit.full_key}: unit={Unit(self.limit.unit).name} "
                f"requests_per_unit={self.limit.requests_per_unit}\n"
            )
        for child in self.children.values():
            out += child.dump()
        return out


def _error(file: ConfigFile, message: str) -> ConfigError:
    return ConfigError(f"{file.name}: {message}")


# Position-aware key sets (the strict-unmarshal analog of the reference's
# per-struct yaml tags, config_impl.go:169-209): a KNOWN key in the WRONG
# position — shadow_mode inside rate_limit, or unit floated up to the
# descriptor — would silently be ignored by the loader, leaving the operator
# with a rule that doesn't do what the file says. Unknown keys keep the
# reference's "unknown key" error.
_ROOT_KEYS = frozenset({"domain", "descriptors"})
_DESCRIPTOR_KEYS = frozenset(
    {
        "key",
        "value",
        "descriptors",
        "rate_limit",
        "sleep_on_throttle",
        "report_details",
        "shadow_mode",
    }
)
_RATE_LIMIT_KEYS = frozenset({"unit", "requests_per_unit", "algorithm"})


def _validate_keys(file: ConfigFile, node, allowed=_ROOT_KEYS, ctx="the file root") -> None:
    """Generic-pass strict validation (config_impl.go:169-209)."""
    if not isinstance(node, dict):
        return
    for key, value in node.items():
        if not isinstance(key, str):
            raise _error(file, f"config error, key is not of type string: {key}")
        if key not in _VALID_KEYS:
            raise _error(file, f"config error, unknown key '{key}'")
        if key not in allowed:
            raise _error(
                file, f"config error, key '{key}' is not valid in {ctx}"
            )
        if isinstance(value, list):
            for element in value:
                if not isinstance(element, dict):
                    raise _error(
                        file,
                        f"config error, yaml file contains list of type other than map: {element}",
                    )
                _validate_keys(file, element, _DESCRIPTOR_KEYS, "a descriptor")
        elif isinstance(value, dict):
            _validate_keys(file, value, _RATE_LIMIT_KEYS, "rate_limit")
        elif isinstance(value, (str, bool, int, float)) or value is None:
            pass
        else:
            raise _error(file, f"error checking config: {value}")


def validate_concurrency_ttl(ttl) -> int:
    """A concurrency rule's idle TTL in seconds (CONCURRENCY_TTL_S), as the
    reference's settings validate it: in [1, 2^28). It is the rule's window
    in the divider word's 28-bit field, so junk must fail the load, never
    become a leak that lasts forever or spill into the algorithm bits."""
    ttl = int(ttl)
    if ttl <= 0 or ttl >= (1 << 28):
        raise ValueError(f"CONCURRENCY_TTL_S must be in [1, 2^28), got {ttl}")
    return ttl


class RateLimitConfig:
    """An immutable rule tree over one or more parsed config documents, with
    its compiled matcher as `compiled`."""

    def __init__(
        self,
        docs: Iterable[ConfigDoc],
        stats_scope,
        concurrency_ttl_s: int = DEFAULT_CONCURRENCY_TTL_S,
    ):
        self._domains: dict[str, _Node] = {}
        self._stats_scope = stats_scope
        self._concurrency_ttl_s = validate_concurrency_ttl(concurrency_ttl_s)
        for doc in docs:
            self._load_doc(doc)
        self.compiled = CompiledMatcher(
            self.get_limit, self._new_rate_limit, self._domains
        )

    # -- loading --

    def _load_doc(self, file: ConfigDoc) -> None:
        raw = file.doc
        if raw is None:
            raw = {}
        if not isinstance(raw, dict):
            raise _error(file, "error loading config file: root must be a map")
        _validate_keys(file, raw)

        domain = raw.get("domain") or ""
        if not isinstance(domain, str) or domain == "":
            raise _error(file, "config file cannot have empty domain")
        if domain in self._domains:
            raise _error(file, f"duplicate domain '{domain}' in config file")

        root = _Node()
        self._load_descriptors(file, root, f"{domain}.", raw.get("descriptors") or [])
        self._domains[domain] = root

    def _load_descriptors(
        self, file: ConfigFile, node: _Node, parent_key: str, descriptors: list
    ) -> None:
        for desc in descriptors:
            key = desc.get("key") or ""
            if not isinstance(key, str):
                raise _error(file, f"error loading config file: descriptor key must be a string, got {key!r}")
            if key == "":
                raise _error(file, "descriptor has empty key")

            value = desc.get("value") or ""
            if not isinstance(value, str):
                raise _error(file, f"error loading config file: descriptor value must be a string, got {value!r}")
            final_key = key if value == "" else f"{key}_{value}"
            new_parent_key = parent_key + final_key
            if final_key in node.children:
                raise _error(
                    file, f"duplicate descriptor composite key '{new_parent_key}'"
                )

            limit: RateLimit | None = None
            rate_limit = desc.get("rate_limit")
            if rate_limit is not None:
                if not isinstance(rate_limit, dict):
                    raise _error(file, "error loading config file: rate_limit must be a map")
                # decision algorithm: strict whitelist — an unknown value
                # must fail the LOAD (the reload handler keeps the last
                # good config), never silently become fixed_window
                algo_raw = rate_limit.get("algorithm")
                if algo_raw is None:
                    algorithm = "fixed_window"
                elif (
                    not isinstance(algo_raw, str)
                    or algo_raw not in ALGORITHM_IDS
                ):
                    raise _error(
                        file,
                        f"invalid rate limit algorithm {algo_raw!r} "
                        f"(valid: {', '.join(sorted(ALGORITHM_IDS))})",
                    )
                else:
                    algorithm = algo_raw
                unit_name = rate_limit.get("unit")
                if algorithm == "concurrency":
                    # a concurrency cap bounds IN-FLIGHT requests: it has
                    # no time window, so a unit is an illegal combo, not a
                    # value to quietly ignore. Internally the rule carries
                    # Unit.SECOND as a placeholder (response plumbing needs
                    # one) and its idle TTL in window_override_s.
                    if unit_name is not None:
                        raise _error(
                            file,
                            "config error, algorithm 'concurrency' caps "
                            "in-flight requests and takes no 'unit' "
                            f"(got unit '{unit_name}')",
                        )
                    unit = Unit.SECOND
                else:
                    unit = unit_from_string(str(unit_name)) if unit_name is not None else None
                    if unit is None:
                        raise _error(file, f"invalid rate limit unit '{unit_name}'")
                # Strict like the reference's uint32 unmarshal
                # (config_impl.go:25 requests_per_unit uint32): a
                # non-integer, negative, or >u32 value is a config error —
                # NOT a ValueError that would escape the reload handler's
                # except ConfigError (found by tests/test_config_fuzz.py),
                # and not a silent overflow of the device row the limit is
                # packed into (uint32, ops/slab.py).
                rpu_raw = rate_limit.get("requests_per_unit")
                if rpu_raw is None:
                    requests_per_unit = 0
                elif (
                    isinstance(rpu_raw, bool)
                    or not isinstance(rpu_raw, int)
                    or rpu_raw < 0
                    or rpu_raw > 0xFFFFFFFF
                ):
                    raise _error(
                        file,
                        "error loading config file: requests_per_unit must be "
                        f"an integer in [0, 2^32), got {rpu_raw!r}",
                    )
                else:
                    requests_per_unit = rpu_raw
                limit = self._new_rate_limit(
                    requests_per_unit,
                    unit,
                    new_parent_key,
                    sleep_on_throttle=bool(desc.get("sleep_on_throttle") or False),
                    report_details=bool(desc.get("report_details") or False),
                    shadow_mode=bool(desc.get("shadow_mode") or False),
                    algorithm=algorithm,
                    window_override_s=(
                        self._concurrency_ttl_s
                        if algorithm == "concurrency"
                        else 0
                    ),
                )

            child = _Node()
            child.limit = limit
            self._load_descriptors(
                file, child, new_parent_key + ".", desc.get("descriptors") or []
            )
            node.children[final_key] = child

    def _new_rate_limit(
        self,
        requests_per_unit: int,
        unit: Unit,
        full_key: str,
        sleep_on_throttle: bool = False,
        report_details: bool = False,
        shadow_mode: bool = False,
        algorithm: str = "fixed_window",
        window_override_s: int = 0,
    ) -> RateLimit:
        return RateLimit(
            full_key=full_key,
            stats=new_rate_limit_stats(self._stats_scope, full_key),
            limit=RateLimitValue(requests_per_unit=requests_per_unit, unit=unit),
            sleep_on_throttle=sleep_on_throttle,
            report_details=report_details,
            shadow_mode=shadow_mode,
            algorithm=algorithm,
            window_override_s=window_override_s,
        )

    # -- lookup --

    def get_limit(self, domain: str, descriptor: Descriptor) -> RateLimit | None:
        """Resolve the applicable rule, or None when unchecked: the trie walk
        of config_impl.go:293-319."""
        domain_node = self._domains.get(domain)
        if domain_node is None:
            return None

        if descriptor.limit is not None:
            # Request-level override: ad-hoc rule, no fork extras, stats keyed
            # by the request's dotted path (config_impl.go:281-290).
            full_key = f"{domain}.{descriptor_dotted_key(descriptor)}"
            return self._new_rate_limit(
                descriptor.limit.requests_per_unit,
                Unit(descriptor.limit.unit),
                full_key,
            )

        found: RateLimit | None = None
        children = domain_node.children
        last_index = len(descriptor.entries) - 1
        for i, entry in enumerate(descriptor.entries):
            node = children.get(f"{entry.key}_{entry.value}")
            if node is None:
                node = children.get(entry.key)
            if node is not None and node.limit is not None and i == last_index:
                found = node.limit
            if node is not None and node.children:
                children = node.children
            else:
                break
        return found

    def dump(self) -> str:
        return "".join(node.dump() for node in self._domains.values())

    @property
    def domains(self) -> tuple[str, ...]:
        return tuple(self._domains)


def parse_config_files(files: Iterable[ConfigFile]) -> list[ConfigDoc]:
    """Parse YAML rule files into config documents. PyYAML is imported here
    and nowhere else, so building a config from mappings never needs it."""
    import yaml

    docs = []
    for file in files:
        try:
            doc = yaml.safe_load(file.contents)
        except yaml.YAMLError as e:
            raise _error(file, f"error loading config file: {e}")
        docs.append(ConfigDoc(file.name, doc))
    return docs


def build_config(
    docs: Iterable[ConfigDoc],
    stats_scope,
    concurrency_ttl_s: int = DEFAULT_CONCURRENCY_TTL_S,
) -> RateLimitConfig:
    """Build the rule tree from parsed documents (for example mappings a
    caller wrote directly)."""
    return RateLimitConfig(docs, stats_scope, concurrency_ttl_s=concurrency_ttl_s)


def load_config(
    files: list[ConfigFile],
    stats_scope,
    concurrency_ttl_s: int = DEFAULT_CONCURRENCY_TTL_S,
) -> RateLimitConfig:
    """Default loader (config_impl.go:342-346 equivalent): YAML files ->
    rule tree."""
    return build_config(parse_config_files(files), stats_scope, concurrency_ttl_s)
