"""Port of tools/clock_lint.py: the clock-injection lint, no raw
wall/monotonic reads in the port's time-semantic code.

The chaos engine's determinism contract (chaos/) requires every
time-SEMANTIC read — window math, TTLs, lease expiry, breaker windows,
settlement lag, snapshot staleness — to route through an injectable
TimeSource (utils/timeutil.py), so a campaign can virtualize and skew
one process's clock. This lint walks the module list below and flags:

    time.time(...)        always time-semantic — use ts.unix_now()
    time.monotonic(...)   interval semantics — use ts.monotonic()

Exempt by construction (pure measurement, never decision input):

    time.perf_counter / perf_counter_ns   latency histograms
    time.monotonic_ns                     journey stage stamps
    time.sleep                            pacing, not reading

A line that must read the real clock (the RealTimeSource itself, the
process-bootstrap path) carries a `# clock-ok: <reason>` pragma.

The module list is the reference's, each module under its port name
(backends/tpu.py is backends/cuda.py). parallel/sharded_slab.py is not
ported yet (ROADMAP item 10): it is skipped while it does not exist and
linted from the day it does.

    python -m api_ratelimit_tpu_torch.tools.clock_lint

Exit 0 clean, 1 findings, 2 usage. Wired into the tests via
tests/test_torch_chaos_engine.py so a raw clock read can't land unseen.
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
PKG = "api_ratelimit_tpu_torch"

# The time-SEMANTIC module list: files whose clock reads feed decisions
# (windows, TTLs, expiry, lag, staleness). Measurement-only modules
# (tracing, stats, bench tools) are out of scope by design.
SEMANTIC_MODULES = (
    "backends/cuda.py",
    "backends/lease.py",
    "backends/sidecar.py",
    "backends/fallback.py",
    "backends/victim.py",
    "backends/memory.py",
    "backends/overload.py",
    "limiter/base_limiter.py",
    "limiter/local_cache.py",
    "cluster/federation.py",
    "persist/replication.py",
    "persist/snapshot.py",
    "persist/snapshotter.py",
    "parallel/sharded_slab.py",
    "service/ratelimit.py",
    "utils/timeutil.py",
)

# listed modules the port does not have yet, with their ROADMAP item
AWAITING_PORT = {"parallel/sharded_slab.py": "10"}

_RAW = re.compile(r"\btime\.(time|monotonic)\(")
_EXEMPT = re.compile(r"\btime\.(perf_counter|perf_counter_ns|monotonic_ns|sleep)\b")
_PRAGMA = "# clock-ok"


def lint_file(path: str) -> list:
    findings = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError as exc:
        return [f"{path}: unreadable ({exc})"]
    for lineno, line in enumerate(lines, 1):
        stripped = line.split("#", 1)[0]
        match = _RAW.search(stripped)
        if match is None:
            continue
        if _PRAGMA in line:
            continue
        findings.append(
            f"{os.path.relpath(path, REPO)}:{lineno}: raw time.{match.group(1)}() "
            f"in a time-semantic module — route through the TimeSource "
            f"(utils/timeutil.py process_time_source) or add "
            f"'# clock-ok: <reason>'"
        )
    return findings


def run(repo: str = REPO) -> list:
    findings = []
    for rel in SEMANTIC_MODULES:
        path = os.path.join(repo, PKG, rel)
        if not os.path.exists(path):
            if rel not in AWAITING_PORT:
                findings.append(f"{PKG}/{rel}: listed module missing")
            continue
        findings.extend(lint_file(path))
    return findings


def main(argv=None) -> int:
    findings = run()
    for finding in findings:
        print(finding)
    if findings:
        print(f"clock_lint: {len(findings)} finding(s)")
        return 1
    print(f"clock_lint: clean ({len(SEMANTIC_MODULES)} modules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
