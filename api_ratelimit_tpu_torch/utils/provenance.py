"""Port of api_ratelimit_tpu/utils/provenance.py: the hardware and build
regime a measurement was taken in, as ``ratelimit.build.*`` gauges.

``register_build_gauges()`` exports host_cpus, device_count, platform_id and
git_rev_hash on the scope /metrics serves, so a scraped process says which
card and which build it is measured on. The platform and device facts are
passed in by the component that owns the device: the runner, after the
engine is built, reports platform "gpu" and torch.cuda's device count; a
runner on the CPU (device="cpu", the tests) or on the memory backend reports
platform "cpu" and 0 devices, as a frontend without an accelerator does.

The reference's CRC'd provenance block for benchmark artifacts
(build_provenance, verify, platform_marker) comes with the port's benchmark
(ROADMAP item 11).
"""

from __future__ import annotations

import functools
import os
import subprocess
import zlib

# numeric platform ids for the gauge export (gauges are floats); unknown
# platforms map to -1 so a new accelerator is visible, not invisible
PLATFORM_IDS = {"cpu": 0, "tpu": 1, "gpu": 2}


def host_cpus() -> int:
    """CPUs this process may actually run on (the affinity mask, not the
    box inventory — a container pinned to 1 of 64 cores is a 1-core box
    for scaling purposes). BENCH_HOST_CPUS overrides, as in the
    reference."""
    forced = os.environ.get("BENCH_HOST_CPUS", "").strip()
    if forced:
        return max(1, int(forced))
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


@functools.lru_cache(maxsize=None)
def git_rev(repo_dir: str | None = None) -> str:
    """Short git rev of the working tree, "" when unavailable (a checkout
    copied without its .git)."""
    if repo_dir is None:
        repo_dir = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=repo_dir,
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def rev_hash(rev: str) -> int:
    """Numeric stand-in for the rev string (gauges carry floats)."""
    return zlib.crc32(rev.encode("utf-8"))


def register_build_gauges(
    scope, platform: str = "cpu", device_count: int = 0
) -> None:
    """Export the regime as ``ratelimit.build.*`` gauges (host_cpus,
    device_count, platform_id, git_rev_hash) on whatever scope the
    caller serves /metrics from. Fleet note: the reference's fleet merge
    (ROADMAP item 8 here) takes these by MAX, not sum — every member
    reports the same box, and a summed host_cpus would invent cores."""
    build = scope.scope("build")
    build.gauge("host_cpus").set(host_cpus())
    build.gauge("device_count").set(int(device_count))
    build.gauge("platform_id").set(PLATFORM_IDS.get(platform, -1))
    build.gauge("git_rev_hash").set(rev_hash(git_rev()))
