"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (rlbench/configs/<config>.json, the `file` of
its entry), a traffic mix (rlbench/traffic/<traffic>.json, read by the one
generator in pool.py) and, through the per-layer metrics that list it, the
readers rlbench/metrics/<metric>.py, each with read(run) -> float | None.
A later cell, mix or metric is a new file and new entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    entry = _by_name(manifest["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as f:
        return json.load(f)


def cell_metrics(manifest: dict, cell_entry: dict, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries the cell reports: those that
    list it under `workloads`, or that list none and move a metric it
    reports."""
    e2e = {m["name"] for m in metrics_of(manifest, cell_entry, "end_to_end")}
    if kind == "end_to_end":
        return metrics_of(manifest, cell_entry, kind)
    out = []
    for m in manifest[kind]:
        listed = m.get("workloads")
        if (listed is None and m["moves"] in e2e) or (listed and cell_entry["name"] in listed):
            out.append(m)
    return out


def metrics_of(manifest: dict, cell_entry: dict, kind: str) -> list:
    return [
        m for m in manifest[kind]
        if m.get("workloads") is None or cell_entry["name"] in m["workloads"]
    ]


def reader(name: str, bench_dir: str = BENCH_DIR):
    """read(run) of rlbench/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rlbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
