"""The control: the reference, put in the program's place with its in-launch
serialization switched off, served the cell's traffic at the cell's own
size, and judged by the same comparison. It has to come out not correct.

    python3 -m rlbench.control --workload <name> --seeds 11,12,13 --seconds 5

prints one JSON line a seed with the numbers compared. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)

    from . import manifest as mf
    from .owner import ControlOwner
    from .run import run_cell

    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    config = mf.config(manifest, cell["config"])
    traffic = mf.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        result, numbers = run_cell(
            manifest, cell, config, traffic, seed, args.seconds, False, device="cpu",
            make_owner=lambda c, clock, log, _store, _dev: ControlOwner(c, clock, log),
        )
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": result["correct"],
            "compared": result["compared"], "served_blocks": numbers["served_blocks"],
        }))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
