"""Port of api_ratelimit_tpu/utils/provenance.py: the hardware and build
regime a measurement was taken in, as a CRC'd block and as
``ratelimit.build.*`` gauges.

``register_build_gauges()`` exports host_cpus, device_count, platform_id and
git_rev_hash on the scope /metrics serves, so a scraped process says which
card and which build it is measured on. The platform and device facts are
passed in by the component that owns the device: the runner, after the
engine is built, reports platform "gpu" and torch.cuda's device count; a
runner on the CPU (device="cpu", the tests) or on the memory backend reports
platform "cpu" and 0 devices, as a frontend without an accelerator does.

``build_provenance()`` returns the reference's CRC'd block (version,
platform, device_count, host_cpus, cpu_model, git_rev, python, knobs, crc)
that a chaos artifact (chaos/campaign.py build_artifact) and the fleet
master's plain GET /metrics carry; ``verify()`` checks one and
``platform_marker()`` is the comparability key two artifacts must share
before their numbers are compared. On the card the block's platform is
"gpu" and it also names the card (``device_name``, which the marker
carries): two H100 variants are different regimes. The CRC covers every
field but itself, so either package's verify() accepts the other's block.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import zlib

PROVENANCE_VERSION = 1

# numeric platform ids for the gauge export (gauges are floats); unknown
# platforms map to -1 so a new accelerator is visible, not invisible
PLATFORM_IDS = {"cpu": 0, "tpu": 1, "gpu": 2}

# the knob set stamped into the block: everything that changes what a
# number means without changing the code rev (the reference's list; its
# BENCH_PALLAS has no counterpart, the port always runs its kernels)
KNOB_NAMES = (
    "BENCH_ARM",
    "BENCH_TIERS",
    "BENCH_HOST_CPUS",
    "SLAB_WAYS",
    "HOST_FAST_PATH",
    "DISPATCH_LOOP",
    "SHM_RINGS",
    "LEASE_ENABLED",
    "HOTKEYS_ENABLED",
    "PARTITIONS",
    "FRONTEND_PROCS",
)

# fields a valid block must carry (the reference's list)
REQUIRED_FIELDS = (
    "version",
    "platform",
    "device_count",
    "host_cpus",
    "cpu_model",
    "git_rev",
    "knobs",
    "crc",
)


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


@functools.lru_cache(maxsize=1)
def cpu_model() -> str:
    """The /proc/cpuinfo model string: what tells two "platform: cpu"
    boxes apart."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


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


def knob_set() -> dict:
    """The stamped knob environment: only knobs that are actually set (an
    empty dict means "all defaults")."""
    return {k: os.environ[k] for k in KNOB_NAMES if os.environ.get(k)}


def provenance_crc(block: dict) -> int:
    """CRC32 over the canonical JSON of every field but the crc itself: a
    hand-edited or truncated block fails verification."""
    body = {k: v for k, v in block.items() if k != "crc"}
    return zlib.crc32(json.dumps(body, sort_keys=True, separators=(",", ":")).encode())


def build_provenance(
    platform: str,
    device_count: int,
    knobs: dict | None = None,
    repo_dir: str | None = None,
    device_name: str | None = None,
) -> dict:
    """The CRC'd provenance block for one run. device_name (the card's
    torch.cuda.get_device_name) is stamped when given, so a "gpu" block
    says which card."""
    block = {
        "version": PROVENANCE_VERSION,
        "platform": str(platform),
        "device_count": int(device_count),
        "host_cpus": host_cpus(),
        "cpu_model": cpu_model(),
        "git_rev": git_rev(repo_dir),
        "python": "%d.%d" % sys.version_info[:2],
        "knobs": knobs if knobs is not None else knob_set(),
    }
    if device_name:
        block["device_name"] = str(device_name)
    block["crc"] = provenance_crc(block)
    return block


def verify(block) -> bool:
    """True iff the block has every required field and its CRC matches."""
    if not isinstance(block, dict):
        return False
    if any(f not in block for f in REQUIRED_FIELDS):
        return False
    try:
        return int(block["crc"]) == provenance_crc(block)
    except (TypeError, ValueError):
        return False


def _model_slug(model: str) -> str:
    """Compact, stable token for a cpu or card model inside a marker."""
    slug = "".join(c if c.isalnum() else "-" for c in model.lower())
    while "--" in slug:
        slug = slug.replace("--", "-")
    return slug.strip("-")[:24] or "unknown-cpu"


def platform_marker(block: dict) -> str:
    """The comparability key: two runs are compared only when their
    markers are equal. Platform + device count + cpu count + cpu model (the
    reference's four fields), and the card's slug after them when the
    block names a card."""
    marker = "{}/dev{}/cpus{}/{}".format(
        block.get("platform", "?"),
        block.get("device_count", "?"),
        block.get("host_cpus", "?"),
        _model_slug(str(block.get("cpu_model", ""))),
    )
    if block.get("device_name"):
        marker += "/" + _model_slug(str(block["device_name"]))
    return marker


def register_build_gauges(
    scope, platform: str = "cpu", device_count: int = 0
) -> None:
    """Export the regime as ``ratelimit.build.*`` gauges (host_cpus,
    device_count, platform_id, git_rev_hash) on whatever scope the
    caller serves /metrics from. The fleet merge (stats/fleet.py) takes
    these by MAX, not sum: every member reports the same box, a summed
    host_cpus would invent cores, and the device owner's gpu platform_id
    and device_count win over the frontends' cpu/0."""
    build = scope.scope("build")
    build.gauge("host_cpus").set(host_cpus())
    build.gauge("device_count").set(int(device_count))
    build.gauge("platform_id").set(PLATFORM_IDS.get(platform, -1))
    build.gauge("git_rev_hash").set(rev_hash(git_rev()))
