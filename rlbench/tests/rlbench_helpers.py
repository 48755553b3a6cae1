"""Small inputs for the benchmark's CPU tests."""

import copy
import json
import os

ALGOS_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "algos_config.json")


def tiny(config: dict, traffic: dict, keys: int = 20000, slots: int = 4096, ways: int = 4):
    """A configuration and mix small enough for the CPU: the same rules and
    key draw, a small slab, 4 frontends of 256-row blocks."""
    config = copy.deepcopy(config)
    config["keys"] = keys
    config["settings"].update({
        "TPU_SLAB_SLOTS": str(slots), "SLAB_WAYS": str(ways),
        "TPU_BATCH_LIMIT": "2048", "TPU_BUCKETS": "256,2048",
    })
    traffic = dict(traffic, block_rows=256, frontends=4, warmup_blocks_per_frontend=2,
                   sketch_topk=min(4, int(traffic.get("sketch_topk", 0))))
    return config, traffic


TINY_POOL_ROWS = 256 * 4 * 16


def cell_inputs(manifest, name):
    """(cell, configuration, mix) of a cell of BENCHMARK.json at a tiny size.
    Two stand in for no cell: "algos.test", the four-algorithm fixture under
    the zipf mix, and "uniform.test", the fixed-window configuration under
    the uniform mix."""
    from rlbench import manifest as mf

    if name == "algos.test":
        with open(ALGOS_CONFIG) as f:
            config = json.load(f)
        cell = {"name": name, "config": config["name"], "traffic": "zipf", "chips": 1}
    elif name == "uniform.test":
        cell = {"name": name, "config": "owner_fixed", "traffic": "uniform", "chips": 1}
        config = mf.config(manifest, "owner_fixed")
    else:
        cell = mf.cell(manifest, name)
        config = mf.config(manifest, cell["config"])
    config, traffic = tiny(config, mf.traffic(cell["traffic"]))
    return cell, config, traffic
