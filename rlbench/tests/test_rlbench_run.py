"""A run's path on the CPU: the window driven on a tiny SlabDeviceEngine
(device="cpu", the kernels' plain versions), called directly, and the
command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from rlbench import manifest as mf
from rlbench.run import run_cell
from rlbench_helpers import TINY_POOL_ROWS, cell_inputs

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", ["fixed.zipf", "uniform.test", "algos.test"])
def test_the_window_runs_on_a_cpu_engine(name):
    manifest = mf.load()
    cell, config, traffic = cell_inputs(manifest, name)
    result, numbers = run_cell(manifest, cell, config, traffic, 2**31 + 99, 0.8, False,
                               device="cpu", pool_rows=TINY_POOL_ROWS)
    line = json.loads(json.dumps(result))
    assert REQUIRED <= set(line) <= REQUIRED | {"breakdown", "compared"}
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, numbers
    assert numbers["mismatched_rows"] == 0 and numbers["checked_rows"] > 0
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"decisions_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_per_layer_metrics_read_the_programs_histograms():
    manifest = mf.load()
    cell, config, traffic = cell_inputs(manifest, "fixed.zipf")
    result, _ = run_cell(manifest, cell, config, traffic, 5, 0.8, True, device="cpu",
                         pool_rows=TINY_POOL_ROWS, trace_slice=False)
    got = result["metrics"]
    # no traced slice on the CPU: the device metrics stay silent
    host = {"dispatch.rows_per_launch", "dispatch.ring_wait_ms", "engine.launch_host_ms"}
    assert host <= set(got) <= host | {"dispatch.block_p99_ms"}
    assert 256 <= got["dispatch.rows_per_launch"]["value"] <= 4 * 256


def test_readers_of_a_traced_slice():
    from types import SimpleNamespace

    import numpy as np

    from rlbench.trace import Slice, _label_gaps, _union_us

    dev = [("void way_scan_kernel<false>(int)", 0.0, 10.0), ("void slab_apply_kernel<false, false>()", 20.0, 25.0),
           ("sketch_update_kernel", 25.0, 30.0), ("Memcpy HtoD", 40.0, 50.0)]
    busy, merged = _union_us([(s, e) for _, s, e in dev])
    assert busy == 30.0 and len(merged) == 3
    gaps = _label_gaps(merged, [(9.0, 21.0, "cudaLaunchKernel"), (30.0, 31.0, "cudaMemcpyAsync")])
    assert gaps == pytest.approx({"cudaLaunchKernel": 10e-6, "cudaMemcpyAsync": 10e-6})
    s = Slice(100e-6, 2, (0, 0), busy * 1e-6, dev, gaps)
    run = SimpleNamespace(slice=s, n_slots=1024, ways=128, lanes=128,
                          slice_launches=lambda: iter([np.arange(64, dtype=np.uint32)]))
    assert mf.reader("device.idle_pct")(run) == pytest.approx(70.0)
    assert mf.reader("step.device_ms")(run) == pytest.approx(0.015)
    assert mf.reader("step.device_ops")(run) == 2.0
    assert 0 < mf.reader("way_scan_roofline")(run) < 100
    assert mf.reader("slab_apply_roofline")(run) == pytest.approx(64 * 57 / 3.35e12 / 5e-6 * 100)
    run.slice = Slice(1.0, 4, (0, 0), 0.0)  # a slice with no device activity: nothing to read
    for name in ("device.idle_pct", "step.device_ms", "step.device_ops", "way_scan_roofline",
                 "slab_apply_roofline", "sketch_update_roofline"):
        assert mf.reader(name)(run) is None, name


def test_a_trace_that_records_no_device_activity_fails_the_run():
    """On the CPU the profiler records no device activity: after its
    attempts the tracer raises, and no other clock stands in."""
    import contextlib
    from types import SimpleNamespace

    from rlbench.owner import LaunchLog
    from rlbench.trace import TraceEmpty, Tracer

    import numpy as np

    engine = SimpleNamespace(launches_quiesced=contextlib.nullcontext,
                             dispatch_loop=SimpleNamespace(launches=0))
    tracer = Tracer(engine, LaunchLog(np.zeros((1, 6, 4), dtype=np.uint32)))
    with pytest.raises(TraceEmpty):
        tracer.capture(0.01, attempts=2)


def _command(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "rlbench.run", "--workload", "fixed.zipf", "--seed", "7",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_without_a_card_it_fails_and_prints_no_result():
    done = _command(mf.ROOT)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_with_only_the_benchmark_it_fails_and_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(mf.ROOT, "rlbench"), tmp_path / "rlbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(mf.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    done = _command(str(tmp_path))
    assert done.returncode != 0
    assert done.stdout.strip() == ""
