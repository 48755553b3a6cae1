"""Port of tools/journey_report.py (unchanged): render retained journeys
from /debug/journeys into an offline report.

Input: the JSON body of GET /debug/journeys (or the SIGUSR2 stderr dump) —
a file path, or '-' for stdin. Output: a per-stage percentile breakdown
(how long journeys spent between successive pipeline stages: publish ->
take -> pack -> launch -> redeem -> scatter) and a top-N slowest table
with flags and trace ids, so a captured tail can be diagnosed without the
process that recorded it.

Pure JSON by design: this must run anywhere the JSON lands (a laptop, a
CI artifact browser), never needing the accelerator stack. It reads the
port's and the JAX package's journeys alike (one document shape).

    python -m api_ratelimit_tpu_torch.tools.journey_report journeys.json
    python -m api_ratelimit_tpu_torch.tools.journey_report --top 20 j.json
    curl -s localhost:6070/debug/journeys \\
        | python -m api_ratelimit_tpu_torch.tools.journey_report -
    ... --json journeys.json      # machine-readable
    ... --hot-only journeys.json  # hotkey tail

Hot-key view (ops/sketch.py heavy-hitter telemetry): journeys whose
request touched a descriptor the sketch ranked hot carry the "hotkey"
flag. --hot-only restricts the whole report to those journeys; the
default report additionally splits every per-stage percentile row into
hot vs cold populations, so "the p99 is the hot head contending" and
"the p99 is a cold-path stall" are distinguishable at a glance.
"""

from __future__ import annotations

import argparse
import json
import sys

# canonical stage order (tracing/journeys.py STAGES; duplicated here so the
# report reads no module beyond the standard library). lease_local is
# the frontend-local decide mark (backends/lease.py) — requests answered
# from a leased budget carry it INSTEAD of the device stage set.
STAGE_ORDER = (
    "lease_local",
    "publish",
    "take",
    "pack",
    "launch",
    "redeem",
    "scatter",
)

# tracing/journeys.py FLAG_HOTKEY, duplicated for the same reason
FLAG_HOTKEY = "hotkey"


def is_hot(journey: dict) -> bool:
    return FLAG_HOTKEY in (journey.get("flags") or ())


def _percentile(ordered: list[float], q: float) -> float:
    if not ordered:
        return 0.0
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def stage_deltas(journey: dict) -> dict[str, float]:
    """Per-stage durations in ms: the gap from the previous recorded stage
    (or the journey start) to each stage's timestamp, in canonical order.
    Stages a journey never reached are simply absent."""
    stages = journey.get("stages") or {}
    start_ns = journey.get("start_ns", 0)
    deltas: dict[str, float] = {}
    prev = start_ns
    for name in STAGE_ORDER:
        ns = stages.get(name)
        if ns is None:
            continue
        deltas[name] = max(0.0, (ns - prev) / 1e6)
        prev = ns
    return deltas


def collect_journeys(doc: dict) -> list[dict]:
    """Retained journeys from a /debug/journeys document (accepts a bare
    list too, for hand-assembled inputs)."""
    if isinstance(doc, list):
        return doc
    return list(doc.get("retained") or doc.get("journeys") or [])


def _summarize_stages(journeys: list[dict]) -> dict:
    per_stage: dict[str, list[float]] = {}
    for journey in journeys:
        for stage, ms in stage_deltas(journey).items():
            per_stage.setdefault(stage, []).append(ms)
    stage_summary = {}
    for stage in STAGE_ORDER:
        values = sorted(per_stage.get(stage, []))
        if not values:
            continue
        stage_summary[stage] = {
            "count": len(values),
            "p50_ms": round(_percentile(values, 0.50), 4),
            "p90_ms": round(_percentile(values, 0.90), 4),
            "p99_ms": round(_percentile(values, 0.99), 4),
            "max_ms": round(values[-1], 4),
        }
    return stage_summary


def build_report(doc: dict, top: int = 10, hot_only: bool = False) -> dict:
    journeys = collect_journeys(doc)
    if hot_only:
        journeys = [j for j in journeys if is_hot(j)]
    stage_summary = _summarize_stages(journeys)
    hot = [j for j in journeys if is_hot(j)]
    slowest = sorted(
        journeys, key=lambda j: j.get("duration_ms", 0.0), reverse=True
    )[: max(0, top)]
    report = {
        "journeys": len(journeys),
        "hot_journeys": len(hot),
        "live_p99_ms": doc.get("live_p99_ms") if isinstance(doc, dict) else None,
        "stages": stage_summary,
        "slowest": [
            {
                "duration_ms": j.get("duration_ms", 0.0),
                "flags": j.get("flags", []),
                "kind": j.get("kind", ""),
                "trace_id": j.get("trace_id", ""),
                "thread": j.get("thread", ""),
                "stage_ms": {
                    k: round(v, 4) for k, v in stage_deltas(j).items()
                },
            }
            for j in slowest
        ],
    }
    # the hot/cold per-stage split (omitted under --hot-only, where the
    # whole report IS the hot population): same percentile rows computed
    # over the two sub-populations, so a fat device stage can be
    # attributed to head contention vs cold-path stalls
    if not hot_only and hot and len(hot) < len(journeys):
        cold = [j for j in journeys if not is_hot(j)]
        report["stages_hot"] = _summarize_stages(hot)
        report["stages_cold"] = _summarize_stages(cold)
    return report


def _stage_table(stages: dict, header: str | None = None) -> list[str]:
    lines = []
    if header:
        lines.append(header)
    lines.append(
        f"{'stage':<10} {'count':>6} {'p50_ms':>10} {'p90_ms':>10} "
        f"{'p99_ms':>10} {'max_ms':>10}"
    )
    for stage in STAGE_ORDER:
        s = stages.get(stage)
        if s is None:
            continue
        lines.append(
            f"{stage:<10} {s['count']:>6} {s['p50_ms']:>10.4f} "
            f"{s['p90_ms']:>10.4f} {s['p99_ms']:>10.4f} {s['max_ms']:>10.4f}"
        )
    return lines


def render_text(report: dict) -> str:
    lines = [
        f"[journeys] retained={report['journeys']} "
        f"hot={report.get('hot_journeys', 0)}"
    ]
    if report.get("live_p99_ms") is not None:
        lines[0] += f" live_p99={report['live_p99_ms']:.3f}ms"
    lines.append("")
    lines.extend(_stage_table(report["stages"]))
    if report.get("stages_hot"):
        lines.append("")
        lines.extend(
            _stage_table(report["stages_hot"], "hot (flagged 'hotkey'):")
        )
        lines.append("")
        lines.extend(_stage_table(report["stages_cold"], "cold:"))
    lines.append("")
    lines.append(f"top {len(report['slowest'])} slowest:")
    lines.append(
        f"{'duration_ms':>12}  {'flags':<24} {'kind':<16} "
        f"{'trace_id':<34} stages"
    )
    for j in report["slowest"]:
        stage_txt = " ".join(
            f"{k}={v:.3f}" for k, v in j["stage_ms"].items()
        )
        lines.append(
            f"{j['duration_ms']:>12.3f}  {','.join(j['flags']) or '-':<24} "
            f"{j['kind']:<16} {j['trace_id'] or '-':<34} {stage_txt}"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Render /debug/journeys output offline"
    )
    parser.add_argument(
        "input", help="path to the /debug/journeys JSON, or '-' for stdin"
    )
    parser.add_argument(
        "--top", type=int, default=10, help="slowest journeys to list"
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the report as JSON"
    )
    parser.add_argument(
        "--hot-only",
        action="store_true",
        help="restrict the report to journeys flagged 'hotkey' (requests "
        "that touched a sketch-ranked heavy hitter)",
    )
    args = parser.parse_args(argv)
    try:
        if args.input == "-":
            doc = json.load(sys.stdin)
        else:
            with open(args.input, encoding="utf-8") as f:
                doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"journey_report: cannot read {args.input}: {e}", file=sys.stderr)
        return 1
    report = build_report(doc, top=args.top, hot_only=args.hot_only)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_text(report), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
