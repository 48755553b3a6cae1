"""Port of api_ratelimit_tpu/stats/fleet.py: the fleet-wide Prometheus
exposition merge (FRONTEND_PROCS>1).

A process fleet (cmd/service_cmd.py) serves N frontend workers plus one
device owner, each with its OWN debug port (SO_REUSEPORT on a shared debug
port would split scrapes randomly across processes), so the master offsets
them (worker i at DEBUG_PORT+1+i, the owner at DEBUG_PORT+1+N) and keeps
DEBUG_PORT for itself. One Prometheus scrape entry still sees ONE service:
the master's ``GET /metrics?fleet=1`` scrapes every member's /metrics and
serves the merge this module computes.

Merge semantics, per family type (stats/prometheus.py renders them):

  counter     sum across members: counts of events are additive.
  gauge       sum across members (queue depths, occupancy, outstanding
              liability all add), EXCEPT names where summing lies —
              high-water marks, epochs, 0/1 capability flags, live
              quantile estimates and the ratelimit_build_* provenance
              family — which take the max (``GAUGE_MAX``). So the owner's
              platform_id (gpu) and device_count win over the frontends'
              cpu/0 rows.
  histogram   per-``le`` bucket sums plus ``_sum``/``_count`` sums:
              cumulative bucket counts merge exactly.
  summary     ``_sum``/``_count`` sum; quantile samples take the max:
              quantiles are not mergeable without the samples, and the
              worst member is the conservative bound.

The parser is stats/prometheus.py parse_exposition. The module is
socket-only (urllib) and imports no torch: the fleet master aggregates
without loading the device stack.
"""

from __future__ import annotations

import re
import urllib.request

from .prometheus import CONTENT_TYPE, _base_name, _fmt, parse_exposition  # noqa: F401 - re-exported

# gauge names where a sum across processes is a lie: high-water marks,
# map epochs, 0/1 capability flags (native codec available, replication
# connected, hotkeys enabled), live quantile estimates — and the whole
# ratelimit_build_* provenance family (utils/provenance.py): every
# member reports the same box, and a summed host_cpus would invent
# cores. Matched against the FULL prometheus sample name.
GAUGE_MAX = re.compile(
    r"^ratelimit_build_"
    r"|(_hwm|_high_watermark|_watermark|_epoch|_available|_enabled"
    r"|_connected|_p99_ms|_p50_ms)$"
)

# synthetic counter family the merge itself emits when a member's
# exposition carried unparseable lines: a truncated or garbled worker
# degrades to a partial merge WITH a visible drop count, never a 500
# and never a silent hole in the fleet view
DROPPED_FAMILY = "ratelimit_fleet_merge_dropped_lines"

def merge_expositions(texts, report: dict | None = None) -> str:
    """Merge member expositions into one fleet-wide exposition (see the
    module docstring for per-type semantics). Preserves each family's
    first-seen sample order — bucket ``le`` ordering survives — and
    emits families sorted by name, matching the renderer.

    A member whose exposition is malformed or truncated degrades to a
    PARTIAL merge: its parseable families still contribute, the
    unusable lines are counted, and when any were dropped the merged
    body carries a synthetic ``ratelimit_fleet_merge_dropped_lines``
    counter so dashboards see the hole. ``report`` (optional dict)
    receives ``dropped_lines`` (total) and ``per_text`` (per input)."""
    types: dict[str, str] = {}
    merged: dict[str, dict[str, float]] = {}
    per_text: list[int] = []
    for text in texts:
        tr: dict = {}
        t, families = parse_exposition(text, tr)
        per_text.append(tr.get("dropped_lines", 0))
        for name, kind in t.items():
            types.setdefault(name, kind)
        for name, samples in families.items():
            out = merged.setdefault(name, {})
            kind = types.get(name, "")
            for key, value in samples.items():
                if key not in out:
                    out[key] = value
                    continue
                if kind == "gauge":
                    if GAUGE_MAX.search(_base_name(key)):
                        out[key] = max(out[key], value)
                    else:
                        out[key] += value
                elif kind == "summary" and "quantile=" in key:
                    out[key] = max(out[key], value)
                else:
                    # counters, histogram buckets/_sum/_count, summary
                    # _sum/_count, untyped strays: additive
                    out[key] += value
    total_dropped = sum(per_text)
    if report is not None:
        report["dropped_lines"] = total_dropped
        report["per_text"] = per_text
    if total_dropped and DROPPED_FAMILY not in merged:
        types[DROPPED_FAMILY] = "counter"
        merged[DROPPED_FAMILY] = {DROPPED_FAMILY: float(total_dropped)}
    lines: list[str] = []
    for name in sorted(merged):
        kind = types.get(name, "")
        if kind:
            lines.append(f"# TYPE {name} {kind}")
        for key, value in merged[name].items():
            lines.append(f"{key} {_fmt(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def scrape(url: str, timeout: float = 2.0) -> str:
    """Fetch one member's /metrics body; raises on transport failure."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return resp.read().decode("utf-8", errors="replace")


def fleet_metrics(ports, host: str = "127.0.0.1", timeout: float = 2.0):
    """Scrape each member debug port and return ``(merged_text,
    errors)`` — errors is ``[(port, reason)]`` for members that did not
    answer (a dead-and-restarting worker must not fail the whole
    scrape; its counters simply sit the round out) AND for members that
    answered with a partially unparseable body (their good families
    still merged; the reason records how many lines were dropped)."""
    texts = []
    text_ports = []
    errors = []
    for port in ports:
        try:
            texts.append(scrape(f"http://{host}:{port}/metrics", timeout))
            text_ports.append(port)
        except Exception as e:  # noqa: BLE001 - partial fleet still merges
            errors.append((port, str(e)))
    report: dict = {}
    merged = merge_expositions(texts, report)
    for port, dropped in zip(text_ports, report.get("per_text", [])):
        if dropped:
            errors.append(
                (port, f"partial parse: {dropped} line(s) dropped")
            )
    return merged, errors
