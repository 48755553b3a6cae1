"""Port of tools/chaos_campaign.py: the chaos campaign driver
(api_ratelimit_tpu_torch/chaos/): seeded nemesis sweeps, replay, shrink.

Sweep (the default; --out writes a provenance-stamped artifact):

    python -m api_ratelimit_tpu_torch.tools.chaos_campaign --seeds 10 \\
        --steps 120 --out chaos.json

Replay one seed and prove byte-identical determinism:

    python -m api_ratelimit_tpu_torch.tools.chaos_campaign --seed 4 --replay

Self-test the checker: weaken one bound term, catch the violation the
full bound excuses, ddmin it to a minimal repro, emit a pytest file:

    python -m api_ratelimit_tpu_torch.tools.chaos_campaign --seed 3 \\
        --weaken crash --shrink --repro chaos_repro.py

--device picks where the owner engine runs: cuda (the default; the
kernels on the card, exit 1 with the engine's error without one) or cpu
(the plain versions). A seed's canonical JSON is the same on either.

Exit status: 0 clean, 1 violations found (or replay mismatch), 2 usage.
The artifact carries verified provenance (utils/provenance.py),
per-class coverage (or an explicit skip reason), and the full violation
reports inline.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..chaos.campaign import (
    CampaignConfig,
    build_artifact,
    run_campaign,
    run_seeds,
)
from ..chaos.nemesis import (
    NEMESIS_CLASSES,
    canonical_json,
    draw_timeline,
)
from ..chaos.shrink import emit_repro, shrink_timeline


def _config(args) -> CampaignConfig:
    kw = {}
    if args.steps is not None:
        kw["steps"] = args.steps
    if args.classes:
        kw["classes"] = tuple(args.classes.split(","))
    if args.rate is not None:
        kw["nemesis_rate"] = args.rate
    if args.weaken:
        # the weaken self-test isolates the named term: kills only, one
        # over-offered key, no eviction/federation slack masking it
        kw.setdefault("classes", ("process_kill",))
        kw.setdefault("tracked_keys", 1)
        kw.setdefault("lease_offers", 8)
        kw["fillers"] = kw["fillers_per_step"] = 0
        kw["fed_offers"] = 0
        kw["snapshot_every"] = kw["victim_every"] = 0
        kw.setdefault("steps", 40)
    return CampaignConfig(**kw)


def _cmd_replay(args, config: CampaignConfig) -> int:
    first = run_campaign(args.seed, config=config, device=args.device)
    second = run_campaign(args.seed, config=config, device=args.device)
    same = canonical_json(first) == canonical_json(second)
    print(
        f"seed {args.seed}: timeline_crc={first['timeline_crc']} "
        f"verdict={first['verdict']} "
        f"replay={'byte-identical' if same else 'MISMATCH'}"
    )
    return 0 if same and first["verdict"] == "ok" else 1


def _cmd_shrink(args, config: CampaignConfig) -> int:
    timeline = draw_timeline(
        args.seed, config.steps, config.classes, config.nemesis_rate
    )
    result = run_campaign(
        args.seed,
        config=config,
        timeline=timeline,
        weaken=args.weaken,
        device=args.device,
    )
    if result["verdict"] != "violation":
        print(
            f"seed {args.seed}: no violation even with {args.weaken!r} "
            f"weakened ({len(timeline)} actions) — try another seed"
        )
        return 1
    print(
        f"seed {args.seed}: weakened {args.weaken!r} violated "
        f"({len(timeline)} actions); shrinking..."
    )
    minimal = shrink_timeline(
        args.seed, timeline, config=config, weaken=args.weaken,
        device=args.device,
    )
    print(f"minimal repro: {len(minimal)} action(s)")
    for action in minimal:
        print(f"  {canonical_json(action)}")
    if args.repro:
        emit_repro(
            args.repro, args.seed, minimal, config=config, weaken=args.weaken
        )
        print(f"pytest repro written: {args.repro}")
    return 0


def _cmd_sweep(args, config: CampaignConfig) -> int:
    seeds = list(range(args.seeds))

    def progress(result):
        cov = {k: v for k, v in result["coverage"].items() if v}
        print(
            f"seed {result['seed']}: {result['verdict']} "
            f"crc={result['timeline_crc']} "
            f"admits={sum(result['ledger']['admits'].values())} "
            f"denies={result['ledger']['denies']} cov={cov}"
        )

    results = run_seeds(
        seeds,
        config=config,
        weaken=args.weaken or None,
        progress=progress,
        device=args.device,
    )
    artifact = build_artifact(results, config, args.round, device=args.device)
    if args.out:
        # one JSON line, sorted keys: the same canonical shape every
        # BENCH artifact uses (tools/bench_lint.py parses the last line)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(artifact, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        print(f"artifact written: {args.out}")
    n_viol = len(artifact["violations"])
    print(f"verdict: {artifact['verdict']} ({n_viol} violation(s))")
    for violation in artifact["violations"]:
        print(f"  {canonical_json(violation)}")
    return 1 if n_viol else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument(
        "--classes",
        default="",
        help=f"comma list; default all of {','.join(NEMESIS_CLASSES)}",
    )
    parser.add_argument("--rate", type=float, default=None)
    parser.add_argument("--out", default="")
    parser.add_argument("--round", type=int, default=19)
    parser.add_argument("--replay", action="store_true")
    parser.add_argument("--weaken", default="")
    parser.add_argument("--shrink", action="store_true")
    parser.add_argument("--repro", default="")
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the owner engine runs: cuda (default) or cpu",
    )
    args = parser.parse_args(argv)

    import logging

    logging.disable(logging.CRITICAL)  # nemesis noise is the point
    config = _config(args)
    if args.replay:
        if args.seed is None:
            parser.error("--replay needs --seed")
        return _cmd_replay(args, config)
    if args.shrink:
        if args.seed is None or not args.weaken:
            parser.error("--shrink needs --seed and --weaken")
        return _cmd_shrink(args, config)
    return _cmd_sweep(args, config)


if __name__ == "__main__":
    sys.exit(main())
