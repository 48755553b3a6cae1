"""Port of chaos/shrink.py: ddmin a violating nemesis timeline down to a
minimal repro.

Zeller's delta debugging over the action list: a subset reproduces iff
run_campaign(seed, timeline=subset) still renders a violation verdict.
Soundness rests on two campaign properties:

    * the workload stream is independent of the nemesis stream, so any
      subset replays against byte-identical traffic, and
    * actions carry absolute step numbers, so removing one never shifts
      when the survivors fire.

The shrunk timeline then becomes a standalone pytest file (emit_repro)
that pins the seed, the config, and the minimal action list — a bug
report a human can run with plain `pytest` and read in one screen. The
repro imports this package's chaos and runs on the CPU (plain pytest
needs no card).
"""

from __future__ import annotations

from .campaign import CampaignConfig, run_campaign
from .nemesis import canonical_json


def ddmin(items: list, failing) -> list:
    """Minimize `items` while failing(subset) stays True. failing(items)
    must hold on entry. Returns a 1-minimal subset: removing any single
    surviving element makes the failure disappear."""
    if not failing(items):
        raise ValueError("ddmin: the full input does not fail")
    n = 2
    while len(items) >= 2:
        chunk = max(1, len(items) // n)
        subsets = [
            items[i : i + chunk] for i in range(0, len(items), chunk)
        ]
        reduced = False
        for i, subset in enumerate(subsets):
            if failing(subset):
                items, n, reduced = subset, 2, True
                break
            complement = [
                x for j, s in enumerate(subsets) if j != i for x in s
            ]
            if complement and failing(complement):
                items, reduced = complement, True
                n = max(2, n - 1)
                break
        if not reduced:
            if n >= len(items):
                break
            n = min(len(items), n * 2)
    if len(items) == 1 and failing([]):
        return []
    return items


def shrink_timeline(
    seed: int,
    timeline: list,
    config: CampaignConfig | None = None,
    weaken: str | None = None,
    device="cuda",
) -> list:
    """The minimal sub-timeline that still violates the (possibly
    weakened) admission bound under this seed's workload."""

    def failing(subset: list) -> bool:
        result = run_campaign(
            seed, config=config, timeline=subset, weaken=weaken, device=device
        )
        return result["verdict"] == "violation"

    return ddmin(list(timeline), failing)


_REPRO_TEMPLATE = '''\
"""Auto-generated chaos repro (api_ratelimit_tpu_torch/chaos/shrink.py
emit_repro).

Seed {seed}, {n_actions} nemesis action(s) after ddmin. The admission
bound{weaken_note} is violated when this timeline runs against the
seed's deterministic workload. Replay is exact: same seed, same
timeline, same verdict, every run.
"""

from api_ratelimit_tpu_torch.chaos.campaign import CampaignConfig, run_campaign

SEED = {seed}
WEAKEN = {weaken!r}
CONFIG = {config_doc}
TIMELINE = {timeline}


def test_chaos_repro():
    result = run_campaign(
        SEED,
        config=CampaignConfig.from_doc(CONFIG),
        timeline=TIMELINE,
        weaken=WEAKEN,
        device="cpu",
    )
    assert result["verdict"] == "violation", (
        "repro no longer violates — the bound (or the bug) moved: "
        + repr(result["ledger"])
    )
    for violation in result["violations"]:
        print(violation)
'''


def emit_repro(
    path: str,
    seed: int,
    timeline: list,
    config: CampaignConfig | None = None,
    weaken: str | None = None,
) -> str:
    config = config or CampaignConfig()
    body = _REPRO_TEMPLATE.format(
        seed=int(seed),
        n_actions=len(timeline),
        weaken=weaken,
        weaken_note=(
            f" (term {weaken!r} weakened to zero)" if weaken else ""
        ),
        config_doc=canonical_json(config.to_doc()),
        timeline=canonical_json(timeline),
    )
    with open(path, "w", encoding="utf-8") as f:
        f.write(body)
    return path
