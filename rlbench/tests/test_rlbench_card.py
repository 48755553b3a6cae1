"""The command on a card: one short run of each cell, untraced and traced,
whose last line is the result line and reads correct. Skips without a card:
    python3 -m pytest rlbench/tests -q -m card
"""

import json
import subprocess
import sys

import pytest

from rlbench import manifest as mf


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["fixed.zipf"])
def test_a_short_run_on_the_card(card, name, trace):
    done = subprocess.run(
        [sys.executable, "-m", "rlbench.run", "--workload", name, "--seed", str(2**31 + 5),
         "--seconds", "3", "--trace", str(trace)],
        cwd=mf.ROOT, capture_output=True, text=True, timeout=360,
    )
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["kind"] == card
    manifest = mf.load()
    cell = mf.cell(manifest, name)
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in mf.cell_metrics(manifest, cell, kind)}
    assert set(line["metrics"]) == wanted
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
