"""BENCHMARK.json: its shape, the files it names, and that a new cell, mix
and metric come in as new files and new entries alone."""

import json
import os
import re
import shutil

import pytest

from rlbench import manifest as mf
from rlbench_helpers import TINY_POOL_ROWS, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture
def manifest():
    return mf.load()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["rlbench"]
    assert manifest["command"][:3] == ["python3", "-m", "rlbench.run"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_every_cell_names_existing_files(manifest):
    for cell in manifest["workloads"]:
        entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
        assert os.path.isfile(os.path.join(mf.ROOT, entry["file"]))
        assert mf.config(manifest, cell["config"])["name"] == cell["config"]
        assert mf.traffic(cell["traffic"])["block_rows"] > 0
        assert cell["chips"] in (1, 4)
        for m in mf.cell_metrics(manifest, cell, "per_layer"):
            assert callable(mf.reader(m["name"]))
        e2e = {m["name"] for m in mf.cell_metrics(manifest, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.cell_metrics(manifest, cell, "per_layer")


def test_names_units_and_moves(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [c["name"] for c in manifest["workloads"] + manifest["configs"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    pairs = [(c["config"], c["traffic"]) for c in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_keep_their_source(manifest):
    for entry in manifest["configs"]:
        cfg = mf.config(manifest, entry["name"])
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path, manifest):
    """On a throwaway copy: a new configuration, traffic mix and per-layer
    metric, added as files and entries, run without editing any file."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(mf.ROOT, "rlbench"), root / "rlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(mf.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = root / "rlbench"
    cfg = json.loads((bench / "configs" / "owner_fixed.json").read_text())
    cfg["name"] = "owner_small"
    cfg["rules"]["limits"] = [10]
    (bench / "configs" / "owner_small.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "zipf.json").read_text())
    mix["zipf_constant"] = 0.8
    (bench / "traffic" / "zipf08.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dispatch.launches.py").write_text(
        "def read(run):\n    count, _ = run.histogram('dispatch.batch_size')\n    return count or None\n"
    )
    new = json.loads((root / "BENCHMARK.json").read_text())
    new["configs"].append({"name": "owner_small", "source": "https://example.org/x",
                           "file": "rlbench/configs/owner_small.json", "reduced": [], "why": "test"})
    new["workloads"].append({"name": "small.zipf08", "config": "owner_small", "traffic": "zipf08",
                             "chips": 1, "why": "test"})
    new["per_layer"].append({"name": "dispatch.launches", "unit": "launches", "better": "higher",
                             "source": "program_counter", "layer": "dispatch loop",
                             "moves": "decisions_per_s", "workloads": ["small.zipf08"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data

    from rlbench.run import run_cell

    manifest2 = mf.load(str(root))
    cell = mf.cell(manifest2, "small.zipf08")
    config, traffic = tiny(mf.config(manifest2, "owner_small", str(root)), mf.traffic("zipf08", str(bench)))
    assert traffic["zipf_constant"] == 0.8
    result, _ = run_cell(manifest2, cell, config, traffic, 5, 0.5, True, device="cpu",
                         pool_rows=TINY_POOL_ROWS, bench_dir=str(bench), trace_slice=False)
    assert result["correct"]
    assert result["metrics"]["dispatch.launches"]["value"] > 0
    assert result["metrics"]["dispatch.launches"]["unit"] == "launches"
