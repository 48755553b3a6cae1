"""Port of chaos/campaign.py: run_campaign, one seeded chaos run, end to
end, fully deterministic.

The workload is a closed loop drawn from ``random.Random(f"{seed}/
workload")`` — a stream disjoint from the nemesis stream, so the SAME
traffic plays under any subset of the timeline (the shrinker's ground
rule). Per virtual second (one step):

    * any nemesis actions scheduled for this step fire first
    * each tracked lease key gets `lease_offers` service requests
      against the 100/min limit (over-offered: denial pressure is part
      of the workload, the bound is about admits)
    * a rotating window of filler keys pressures the 32-slot slab so
      tracked rows demote into the victim tier and overflow out of it
    * east and west each consume both federated keys (borrow path,
      settlement frames, TTL reclaim under partition)
    * the snapshot / victim-reclaim / fed-pump cadences tick
    * the wall advances one virtual second

After the last step the harness is harvested and the invariant checker
(invariants.py) renders the verdict. The result dict round-trips
through canonical JSON with NO real-world residue (no wall-clock
timestamps, no tmp paths), which is what makes `--seed S --replay`
byte-identical: same seed => same bytes => same verdict.

run_campaign, run_seeds and replay_matches take the owner engine's
`device` ("cuda" by default, "cpu" for the plain versions); the
CampaignConfig does not, so neither to_doc() nor the result names it: one
seed gives the same canonical JSON on the card, on the CPU and in the JAX
package.
"""

from __future__ import annotations

import random
import shutil
import tempfile
from dataclasses import dataclass

import torch

from .harness import ChaosHarness
from .invariants import check_invariants
from .nemesis import (
    NEMESIS_CLASSES,
    canonical_json,
    coverage,
    draw_timeline,
    timeline_crc,
)


@dataclass
class CampaignConfig:
    steps: int = 120
    classes: tuple = NEMESIS_CLASSES
    nemesis_rate: float = 0.2
    tracked_keys: int = 3
    lease_offers: int = 3  # per tracked key per step (over-offer)
    fillers: int = 60  # distinct filler keys cycling through the slab
    fillers_per_step: int = 4
    fed_offers: int = 1  # per fed key per side per step
    snapshot_every: int = 15
    victim_every: int = 5
    lease_limit: int = 100
    fed_limit: int = 50

    def to_doc(self) -> dict:
        return {
            "steps": self.steps,
            "classes": list(self.classes),
            "nemesis_rate": self.nemesis_rate,
            "tracked_keys": self.tracked_keys,
            "lease_offers": self.lease_offers,
            "fillers": self.fillers,
            "fillers_per_step": self.fillers_per_step,
            "fed_offers": self.fed_offers,
            "snapshot_every": self.snapshot_every,
            "victim_every": self.victim_every,
            "lease_limit": self.lease_limit,
            "fed_limit": self.fed_limit,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "CampaignConfig":
        kw = dict(doc)
        if "classes" in kw:
            kw["classes"] = tuple(kw["classes"])
        return cls(**kw)


def run_campaign(
    seed: int,
    config: CampaignConfig | None = None,
    timeline: list | None = None,
    weaken: str | None = None,
    device="cuda",
) -> dict:
    """One seeded run. timeline=None draws the schedule from the seed;
    an explicit timeline (a replay, or a ddmin subset) runs verbatim
    against the SAME seeded workload. weaken zeroes one checker term —
    the self-test hook that proves the checker catches real overshoot.
    """
    config = config or CampaignConfig()
    if timeline is None:
        timeline = draw_timeline(
            seed, config.steps, config.classes, config.nemesis_rate
        )
    by_step: dict = {}
    for action in timeline:
        by_step.setdefault(int(action["step"]), []).append(action)

    rng_w = random.Random(f"{seed}/workload")
    snap_dir = tempfile.mkdtemp(prefix="chaos_snap_")
    harness = ChaosHarness(
        seed,
        snap_dir,
        lease_limit=config.lease_limit,
        fed_limit=config.fed_limit,
        device=device,
    )
    try:
        tracked = [f"k{i}" for i in range(config.tracked_keys)]
        for step in range(config.steps):
            for action in by_step.get(step, ()):
                harness.apply_action(action)
            # workload draws happen in a FIXED order regardless of what
            # the nemesis did — the streams must never entangle
            for value in tracked:
                for _ in range(config.lease_offers):
                    hits = 1 + (rng_w.random() < 0.2)
                    harness.offer_lease(value, hits=hits)
            for _ in range(config.fillers_per_step):
                harness.offer_filler(f"f{rng_w.randrange(config.fillers)}")
            for key in sorted(harness.fed_fps):
                for role in ("east", "west"):
                    for _ in range(config.fed_offers):
                        harness.offer_fed(role, key)
            harness.fed_tick()
            if config.victim_every and step % config.victim_every == 0:
                harness.victim_tick()
            if (
                config.snapshot_every
                and step
                and step % config.snapshot_every == 0
            ):
                harness.snapshot_tick()
            harness.advance(1)
        final = harness.finalize()
    finally:
        harness.close()
        shutil.rmtree(snap_dir, ignore_errors=True)

    violations = check_invariants(
        final["ledger"],
        final["key_limits"],
        final["key_kinds"],
        config.classes,
        lease_outstanding=final["lease_outstanding"],
        fed_reclaimed=final["fed_reclaimed"],
        weaken=weaken,
    )
    return {
        "seed": int(seed),
        "config": config.to_doc(),
        "weakened": weaken,
        "timeline": timeline,
        "timeline_crc": timeline_crc(timeline),
        "coverage": coverage(timeline, config.classes),
        "ledger": final["ledger"],
        "lease_outstanding": final["lease_outstanding"],
        "fed_reclaimed": final["fed_reclaimed"],
        "violations": violations,
        "verdict": "violation" if violations else "ok",
    }


def run_seeds(
    seeds,
    config: CampaignConfig | None = None,
    weaken: str | None = None,
    progress=None,
    device="cuda",
) -> list:
    results = []
    for seed in seeds:
        result = run_campaign(seed, config=config, weaken=weaken, device=device)
        if progress is not None:
            progress(result)
        results.append(result)
    return results


def build_artifact(
    results, config: CampaignConfig, round_no: int, device="cuda"
) -> dict:
    """The CHAOS_rNN.json document (the reference's tools/bench_lint.py
    `chaos` rules): provenance-stamped, per-class coverage summed across
    seeds, every seed's timeline_crc + verdict pinned for replay,
    violations NEVER summarized away — the full reports ride the artifact.
    `device` is where the seeds ran: on the card the block's platform is
    "gpu" with the card's name and count, on the CPU "cpu" and 0."""
    from ..utils import provenance

    total_cov: dict = {cls: 0 for cls in config.classes}
    seeds_block = []
    violations = []
    for result in results:
        for cls, count in result["coverage"].items():
            total_cov[cls] = total_cov.get(cls, 0) + count
        seeds_block.append(
            {
                "seed": result["seed"],
                "timeline_crc": result["timeline_crc"],
                "actions": len(result["timeline"]),
                "verdict": result["verdict"],
                "admits": sum(result["ledger"]["admits"].values()),
                "denies": result["ledger"]["denies"],
            }
        )
        violations.extend(
            dict(v, seed=result["seed"]) for v in result["violations"]
        )
    cov_block = {}
    for cls, count in total_cov.items():
        if count > 0:
            cov_block[cls] = count
        else:
            cov_block[cls] = {
                "skipped": "composed but zero draws across all seeds; "
                "raise --steps or --rate"
            }
    if torch.device(device).type == "cuda":
        block = provenance.build_provenance(
            platform="gpu",
            device_count=torch.cuda.device_count(),
            device_name=torch.cuda.get_device_name(torch.device(device)),
        )
    else:
        block = provenance.build_provenance(platform="cpu", device_count=0)
    return {
        "kind": "chaos",
        "metric": "admission_bound_violations",
        "round": int(round_no),
        "configs": [config.to_doc()],
        "platform": block["platform"],
        "git_rev": block["git_rev"],
        "seeds": seeds_block,
        "coverage": cov_block,
        "violations": violations,
        "verdict": "violation" if violations else "ok",
        "provenance": block,
    }


def replay_matches(
    seed: int, config: CampaignConfig | None = None, device="cuda"
) -> bool:
    """Determinism oracle: two runs of the same seed must produce
    byte-identical canonical JSON (timeline, ledger, verdict — all)."""
    first = canonical_json(run_campaign(seed, config=config, device=device))
    second = canonical_json(run_campaign(seed, config=config, device=device))
    return first == second
