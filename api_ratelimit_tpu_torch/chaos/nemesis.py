"""Port of chaos/nemesis.py (unchanged): the seeded nemesis scheduler,
which draws the whole fault timeline up front.

The timeline is a list of plain-dict actions, each
``{"step": int, "cls": str, ...class params}``, drawn from
``random.Random(f"{seed}/nemesis")`` — a stream string-seeded exactly
like the per-rule streams in testing/faults.py, and INDEPENDENT of the
workload stream (``f"{seed}/workload"``). That independence is what
makes ddmin sound: removing an action from the timeline never shifts
the traffic the remaining actions run against.

Classes (NEMESIS_CLASSES):

    fault_site        reconfigure a role's FaultInjector at runtime with
                      a spec from _FAULT_MENU (the same grammar as
                      FAULT_INJECT / POST /debug/faults, with times=N so
                      every injected fault self-expires)
    process_kill      SIGKILL-equivalent: drop a role's in-memory state
                      and rebuild it (owner restores from its snapshot)
    clock_skew        step/drift ONE role's SkewableTimeSource — wall
                      offset and ppm drift; offset 0 resets the clock
    partition         cut or heal the east<->west federation WAN
    snapshot_corrupt  flip bytes in the newest on-disk snapshot so the
                      next owner restore CRC-rejects it (cold boot)

Actions serialize through canonical_json (sorted keys, no whitespace)
so a timeline has ONE byte representation; timeline_crc over those
bytes is the replay fingerprint stamped into CHAOS artifacts.
"""

from __future__ import annotations

import json
import random
import zlib

NEMESIS_CLASSES = (
    "fault_site",
    "process_kill",
    "clock_skew",
    "partition",
    "snapshot_corrupt",
)

# Runtime-injectable fault menu: (role, spec). Every spec carries a
# times=N qualifier so a drawn fault is a bounded burst, not a permanent
# outage — the campaign composes many of them per run.
_FAULT_MENU = (
    ("owner", "snapshot.write:error:1.0:times=1"),
    ("owner", "victim.demote:drop:1.0:times=2"),
    ("owner", "victim.promote:drop:1.0:times=2"),
    ("owner", "dispatch.launch:error:1.0:times=1"),
    ("east", "fed.exchange:drop:1.0:times=3"),
    ("west", "fed.exchange:drop:1.0:times=3"),
    ("west", "fed.exchange:delay_ms:2:times=2"),
)

_KILL_ROLES = ("owner", "east", "west")
_SKEW_ROLES = ("owner", "east", "west")
_SKEW_OFFSETS = (-90, -30, 0, 30, 90, 150)
_SKEW_DRIFTS = (0, 0, 200_000, 500_000)


def canonical_json(obj) -> str:
    """The one byte representation determinism is asserted against."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def timeline_crc(timeline: list) -> int:
    return zlib.crc32(canonical_json(timeline).encode("utf-8"))


def _draw_action(rng: random.Random, step: int, cls: str) -> dict:
    if cls == "fault_site":
        role, spec = rng.choice(_FAULT_MENU)
        return {"step": step, "cls": cls, "role": role, "spec": spec}
    if cls == "process_kill":
        return {"step": step, "cls": cls, "role": rng.choice(_KILL_ROLES)}
    if cls == "clock_skew":
        return {
            "step": step,
            "cls": cls,
            "role": rng.choice(_SKEW_ROLES),
            "offset_s": rng.choice(_SKEW_OFFSETS),
            "drift_ppm": rng.choice(_SKEW_DRIFTS),
        }
    if cls == "partition":
        return {"step": step, "cls": cls, "op": rng.choice(("cut", "heal"))}
    if cls == "snapshot_corrupt":
        return {"step": step, "cls": cls}
    raise ValueError(f"unknown nemesis class {cls!r}")


def draw_timeline(
    seed: int,
    steps: int,
    classes=NEMESIS_CLASSES,
    rate: float = 0.2,
) -> list:
    """The full nemesis schedule for one campaign run.

    One Bernoulli(rate) draw per step, then a class draw, then the
    class's own params — ALL from the dedicated nemesis stream, and the
    per-step draw order is fixed, so two timelines from the same seed
    are identical element-for-element. Unknown class names fail loudly
    (a typo'd --classes flag must not silently shrink coverage).
    """
    classes = tuple(classes)
    for cls in classes:
        if cls not in NEMESIS_CLASSES:
            raise ValueError(
                f"unknown nemesis class {cls!r}; known: {NEMESIS_CLASSES}"
            )
    rng = random.Random(f"{seed}/nemesis")
    timeline = []
    for step in range(int(steps)):
        if rng.random() >= rate:
            continue
        cls = classes[rng.randrange(len(classes))]
        timeline.append(_draw_action(rng, step, cls))
    return timeline


def coverage(timeline: list, classes=NEMESIS_CLASSES) -> dict:
    """Per-class action counts — the artifact's coverage block. Classes
    that were in the composed set but drew zero actions still appear
    (count 0) so the artifact lint can demand an explicit skip reason."""
    counts = {cls: 0 for cls in classes}
    for action in timeline:
        counts[action["cls"]] = counts.get(action["cls"], 0) + 1
    return counts
