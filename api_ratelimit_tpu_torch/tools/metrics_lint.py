"""Port of tools/metrics_lint.py: lint stat-name registrations across the
port package.

Walks api_ratelimit_tpu_torch/ for literal stat registrations — a
counter, gauge, timer or histogram call on a scope with a string literal
name — and fails on:

  * names violating the dotted-lowercase convention
    (``segment.segment`` where a segment is ``[a-z0-9_]+``); and
  * the same literal name registered under CONFLICTING stat kinds
    (e.g. a counter somewhere and a gauge elsewhere): the Prometheus
    renderer would emit two # TYPE declarations for one family, which
    scrapers reject.

Names are literals as written at the call site (scope-relative); the
convention check is what keeps the composed dotted paths well-formed.
Dynamically composed names (f-strings, variables) are out of scope.

It also drift-checks the README's port section (``## PyTorch/CUDA
port``, up to the next ``## `` heading): every backticked ``ratelimit.*``
metric name mentioned there (brace alternations like ``{steals,drops}``
expanded; ``<placeholder>`` tokens skipped) must resolve to a literal
registration in the port — a renamed or deleted stat must not leave a
stale name in the operator docs. And the other way: each metric family
the port exports beyond the reference (PORT_FAMILIES, the extras
ROADMAP.md lists under "Deliberate departures") must be named in that
section, so an operator can find what the JAX deployment never had.

Run standalone (``python -m api_ratelimit_tpu_torch.tools.metrics_lint``;
exit 1 on findings) or via tests/test_torch_tools.py. No torch import.
"""

from __future__ import annotations

import os
import re
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
README = os.path.join(REPO, "README.md")
README_SECTION = "## PyTorch/CUDA port"

# the families the port exports and the JAX package does not: the
# replication coordinator's ship costs, the owner's reshard merges, its
# per-kernel launch counts and its shm ring traffic
PORT_FAMILIES = (
    "ratelimit.repl.",
    "ratelimit.owner.merge.",
    "ratelimit.owner.launches.",
    "ratelimit.owner.shm.",
)

_REGISTRATION = re.compile(
    r"\.(?P<kind>counter|gauge|timer|histogram)\(\s*(?P<q>['\"])(?P<name>[^'\"]+)(?P=q)"
)
_NAME_OK = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")

# freecache parity names (limiter/local_cache.py): the reference exports
# the Go library's camelCase counters verbatim so existing dashboards and
# the prom-statsd-exporter mapping carry over (README "Switching from
# kentik/api-ratelimit"); exempt from the convention, not from the
# conflicting-kind check.
NAME_ALLOWLIST = frozenset(
    {
        "hitCount",
        "missCount",
        "lookupCount",
        "entryCount",
        "expiredCount",
        "evacuateCount",
        "overwriteCount",
    }
)


def iter_registrations(package_dir: str = PACKAGE):
    """Yield (name, kind, file, line) for every literal registration."""
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for filename in sorted(filenames):
            if not filename.endswith(".py"):
                continue
            path = os.path.join(dirpath, filename)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            # whole-file scan: \s* spans newlines, so a registration whose
            # string literal sits on a continuation line still counts
            for m in _REGISTRATION.finditer(text):
                yield (
                    m.group("name"),
                    m.group("kind"),
                    os.path.relpath(path, REPO),
                    text.count("\n", 0, m.start()) + 1,
                )


def lint(package_dir: str = PACKAGE) -> list[str]:
    """Returns a list of human-readable findings (empty = clean)."""
    findings: list[str] = []
    kinds_by_name: dict[str, dict[str, list[str]]] = {}
    for name, kind, path, lineno in iter_registrations(package_dir):
        site = f"{path}:{lineno}"
        if name not in NAME_ALLOWLIST and not _NAME_OK.match(name):
            findings.append(
                f"{site}: stat name {name!r} violates the dotted-lowercase "
                f"convention ([a-z0-9_] segments joined by '.')"
            )
        kinds_by_name.setdefault(name, {}).setdefault(kind, []).append(site)
    for name, kinds in sorted(kinds_by_name.items()):
        if len(kinds) > 1:
            detail = "; ".join(
                f"{kind} at {', '.join(sites)}" for kind, sites in sorted(kinds.items())
            )
            findings.append(
                f"stat name {name!r} registered with conflicting types: {detail}"
            )
    return findings


# backticked dotted stat paths in the README, e.g. `ratelimit.slab.loss_ppm`
# or `ratelimit.sidecar.{retry,redial}`; `<domain>`-style placeholders make
# a token unverifiable and are skipped
_README_METRIC = re.compile(r"`(ratelimit\.[A-Za-z0-9_.{},<>]+)`")
_BRACE = re.compile(r"\{([^{}]*)\}")


# any backticked ratelimit.* token, wildcards and placeholders included:
# what the family check reads
_README_FAMILY = re.compile(r"`(ratelimit\.[A-Za-z0-9_.{},<>*]+)`")


def readme_section(readme_path: str = README) -> str:
    """The README's port section ("" when the file or heading is
    missing); a README without the heading is read whole."""
    try:
        with open(readme_path, encoding="utf-8") as f:
            text = f.read()
    except FileNotFoundError:
        return ""
    start = text.find(README_SECTION)
    if start < 0:
        return text
    end = text.find("\n## ", start + len(README_SECTION))
    return text[start:] if end < 0 else text[start:end]


def readme_metric_names(readme_path: str = README) -> list[str]:
    """Concrete dotted stat names mentioned in the README's port section
    (one level of {a,b,c} alternation expanded; placeholder tokens
    skipped)."""
    text = readme_section(readme_path)
    names: set[str] = set()
    for m in _README_METRIC.finditer(text):
        token = m.group(1)
        if "<" in token or ">" in token:
            continue
        expanded = [token]
        while any("{" in t for t in expanded):
            nxt = []
            for t in expanded:
                mm = _BRACE.search(t)
                if mm is None:
                    nxt.append(t)
                    continue
                for alt in mm.group(1).split(","):
                    nxt.append(t[: mm.start()] + alt.strip() + t[mm.end():])
            expanded = nxt
        names.update(expanded)
    return sorted(names)


def lint_readme(
    package_dir: str = PACKAGE, readme_path: str = README
) -> list[str]:
    """README drift check: every documented ratelimit.* metric must end in
    a literal stat name registered somewhere in the package (registrations
    are scope-relative, so the check is a dotted-suffix match)."""
    findings: list[str] = []
    literals = {name for name, _, _, _ in iter_registrations(package_dir)}
    for name in readme_metric_names(readme_path):
        if not any(
            name == lit or name.endswith("." + lit) for lit in literals
        ):
            findings.append(
                f"README.md: metric {name!r} does not match any literal "
                f"stat registration in the package (renamed or deleted?)"
            )
    return findings


def lint_port_families(
    readme_path: str = README, families=PORT_FAMILIES
) -> list[str]:
    """Every port-only metric family must be named in the README's port
    section (a backticked token under the family's prefix, wildcards and
    placeholders allowed)."""
    tokens = _README_FAMILY.findall(readme_section(readme_path))
    return [
        f"README.md: the port's metric family {family + '*'!r} is not "
        f"documented in the {README_SECTION!r} section"
        for family in families
        if not any(t.startswith(family) for t in tokens)
    ]


def lint_exposition(text: str) -> list[str]:
    """Validate a Prometheus text exposition — in particular the merged
    fleet output of stats/fleet.py merge_expositions (the master's
    ``GET /metrics?fleet=1`` body): every sample must belong to a
    ``# TYPE``-declared family, no family may be declared twice, no
    sample name may repeat, and histogram bucket series must be
    cumulative (monotone non-decreasing toward ``+Inf``). A merge bug —
    double-declared families from conflicting member types, non-monotone
    buckets from summing absolutes into cumulatives — fails here before
    a scraper ever sees it."""
    findings: list[str] = []
    declared: dict[str, str] = {}
    seen_samples: set[str] = set()
    current: str | None = None
    bucket_last: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                findings.append(f"line {lineno}: malformed TYPE line {line!r}")
                continue
            name, kind = parts[2], parts[3]
            if name in declared:
                findings.append(
                    f"line {lineno}: family {name!r} declared twice"
                )
            declared[name] = kind
            current = name
            continue
        if line.startswith("#"):
            continue
        try:
            key, raw = line.rsplit(" ", 1)
            value = float(raw)
        except ValueError:
            findings.append(f"line {lineno}: malformed sample {line!r}")
            continue
        base = key.split("{", 1)[0]
        if current is None or not base.startswith(current):
            findings.append(
                f"line {lineno}: sample {key!r} has no owning # TYPE family"
            )
        if key in seen_samples:
            findings.append(f"line {lineno}: duplicate sample {key!r}")
        seen_samples.add(key)
        if base.endswith("_bucket") and "le=" in key:
            prev = bucket_last.get(base)
            if prev is not None and value < prev:
                findings.append(
                    f"line {lineno}: histogram {base!r} buckets are not "
                    f"cumulative ({value} after {prev})"
                )
            bucket_last[base] = value
    return findings


def main() -> int:
    findings = lint() + lint_readme() + lint_port_families()
    if findings:
        for finding in findings:
            print(f"metrics-lint: {finding}", file=sys.stderr)
        print(f"metrics-lint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    count = sum(1 for _ in iter_registrations())
    print(f"metrics-lint: OK ({count} literal registrations checked)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
