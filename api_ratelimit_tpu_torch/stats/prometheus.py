"""Port of api_ratelimit_tpu/stats/prometheus.py (unchanged semantics): the
Prometheus text-exposition renderer over a stats Store.

Makes the prom-statsd-exporter hop from the reference deployment optional:
GET /metrics on the debug port (server/http_server.py) renders the live
store directly in text exposition format 0.0.4 — counters, gauges, timers
(as summaries with p50/p99 quantiles), and the hot-path histograms with
classic `_bucket{le=...}` / `_sum` / `_count` series.

Name mangling follows the exporter's convention: the dotted statsd paths
become underscore-separated Prometheus names (`ratelimit.slab.occupancy`
-> `ratelimit_slab_occupancy`), so dashboards keyed on the exporter
mapping translate mechanically.

Histogram `le` labels are in MILLISECONDS, matching the `_ms`-suffixed
metric names — the store records ms everywhere and rescaling at the edge
would desynchronize /metrics from /stats.

parse_exposition reads such a payload back (the JAX package's
stats/fleet.py parser, the half of that module a single process uses); the
fleet merge and scrape that serve FRONTEND_PROCS>1 are stats/fleet.py.
"""

from __future__ import annotations

import re

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(dotted: str) -> str:
    """statsd dotted path -> Prometheus metric name."""
    name = _NAME_SANITIZE.sub("_", dotted.replace(".", "_"))
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt(value: float) -> str:
    """Prometheus sample value: integers stay integral, floats stay
    fixed-point (exposition format allows scientific notation but plain
    decimals parse everywhere)."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def render(store) -> str:
    """The full /metrics payload for a Store (stats/store.py). One
    metrics_snapshot() call, so one scrape is one consistent snapshot."""
    snap = store.metrics_snapshot()
    lines: list[str] = []

    for name, value in sorted(snap["counters"].items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {_fmt(value)}")

    for name, value in sorted(snap["gauges"].items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {_fmt(value)}")

    for name, summary in sorted(snap["timers"].items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} summary")
        lines.append(f'{p}{{quantile="0.5"}} {_fmt(summary["p50_ms"])}')
        lines.append(f'{p}{{quantile="0.99"}} {_fmt(summary["p99_ms"])}')
        lines.append(f"{p}_sum {_fmt(summary['sum_ms'])}")
        lines.append(f"{p}_count {_fmt(summary['count'])}")
        if summary.get("dropped"):
            d = f"{p}_dropped_samples"
            lines.append(f"# TYPE {d} counter")
            lines.append(f"{d} {_fmt(summary['dropped'])}")

    for name, hist in sorted(snap["histograms"].items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        cumulative = 0
        for boundary, count in zip(hist["boundaries"], hist["counts"]):
            cumulative += count
            lines.append(f'{p}_bucket{{le="{_fmt(boundary)}"}} {cumulative}')
        cumulative += hist["counts"][-1]
        lines.append(f'{p}_bucket{{le="+Inf"}} {cumulative}')
        lines.append(f"{p}_sum {_fmt(hist['sum'])}")
        lines.append(f"{p}_count {_fmt(hist['count'])}")

    return "\n".join(lines) + "\n" if lines else ""


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


_TYPE_LINE = re.compile(r"^# TYPE (\S+) (\S+)\s*$")
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)$")


def _base_name(sample_key: str) -> str:
    """``p_bucket{le="5"}`` -> ``p_bucket`` — the label-less sample name."""
    return sample_key.split("{", 1)[0]


def parse_exposition(text: str, report: dict | None = None):
    """Parse one text exposition into ``(types, families)`` where
    ``types`` maps family name -> type and ``families`` maps family name
    -> ordered ``{sample_key: float}``. Sample lines are attributed to
    the most recent ``# TYPE`` family (the renderer always emits TYPE
    immediately before its samples); strays land in an ``""``-typed
    family of their own and merge as sums.

    Junk lines (truncated samples, non-numeric values) are tolerated —
    a merge endpoint must not 500 — but no longer silently: pass a
    ``report`` dict and ``report["dropped_lines"]`` accumulates the
    count of lines that carried no usable sample."""
    types: dict[str, str] = {}
    families: dict[str, dict[str, float]] = {}
    current = None
    dropped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        m = _TYPE_LINE.match(line)
        if m:
            name, kind = m.group(1), m.group(2)
            types.setdefault(name, kind)
            families.setdefault(name, {})
            current = name
            continue
        if line.startswith("#"):
            continue  # HELP / comments
        m = _SAMPLE.match(line)
        if not m:
            dropped += 1
            continue
        key, raw = m.group(1), m.group(2)
        base = _base_name(key)
        # a sample belongs to `current` only if its name extends the
        # family name (p, p_sum, p_count, p_bucket); otherwise it is a
        # stray from a renderer that skipped the TYPE line
        family = (
            current
            if current is not None and base.startswith(current)
            else base
        )
        if family not in families:
            types.setdefault(family, "")
            families[family] = {}
        try:
            value = float(raw)
        except ValueError:
            dropped += 1
            continue
        families[family][key] = value
    if report is not None:
        report["dropped_lines"] = report.get("dropped_lines", 0) + dropped
    return types, families
