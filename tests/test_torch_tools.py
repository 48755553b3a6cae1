"""The port's operator tools (api_ratelimit_tpu_torch/tools/) on the CPU,
against the JAX package's.

* journey_report: the JAX package's TestJourneyReport on the port's tool.
* hotpath_profile: the JAX package's TestHotpathProfile on the port's tool
  with --device cpu (the default, --legacy, --slab-split, --dispatch and
  --frontend arms, each to the reference's output contract); --shard-split
  needs the multi-GPU engine (ROADMAP item 10) and exits 2 naming it.
* snapshot_inspect: the reference's inspector cases (test_persist.py
  TestSnapshotInspectCli, test_lease.py's lease section, test_algorithms.py's
  algorithm mix) on the port's tool, and the two tools' JSON reports equal
  on a slab.snap from each package.
* The lints: the JAX package's tests/test_metrics_lint.py on the port's
  metrics lint (the README's port section), the port-only families
  required there, and each lint failing on a violation planted in a tmp
  copy of the port package or its tests.
* Every module this slice adds imports with jax and the JAX package
  blocked, and the fleet master's plain GET /metrics carries a verified
  provenance block.
* /debug/profile's capture (server/http_server.py): the answer's bytes and
  status codes are the reference's, and a debug server built with
  TPU_PROFILE_DIR warms the profiler on its capture thread at boot.
"""

import json
import os
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.persist import snapshot as jax_snapshot  # noqa: E402
from api_ratelimit_tpu_torch.tools import clock_lint, fault_lint, metrics_lint  # noqa: E402
from api_ratelimit_tpu_torch.tools import snapshot_inspect as port_inspect  # noqa: E402
from api_ratelimit_tpu_torch.utils import provenance  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "api_ratelimit_tpu_torch")

_PLATFORM = reference_tests_on_the_port(
    "test_tools_platform",
    (
        ('"tools.journey_report"', '"api_ratelimit_tpu_torch.tools.journey_report"'),
        ('"tools.hotpath_profile"', '"api_ratelimit_tpu_torch.tools.hotpath_profile"'),
        # every arm on the CPU: the port's tools run on the card by default
        (
            "[sys.executable, \"-m\", mod, *extra]",
            '[sys.executable, "-m", mod, *extra, *(("--device", "cpu") if mod.endswith("hotpath_profile") else ())]',
        ),
    ),
)

TestJourneyReport = _PLATFORM.TestJourneyReport


class TestHotpathProfile(_PLATFORM.TestHotpathProfile):
    def test_shard_split_stage_table(self):
        """--shard-split profiles the multi-GPU engine's routed owner, which
        is not ported yet: it exits 2 naming ROADMAP item 10 and runs no
        other arm."""
        proc = _PLATFORM._run_tool("api_ratelimit_tpu_torch.tools.hotpath_profile", ("--shard-split", "--shards", "2"))
        assert proc.returncode == 2
        assert "ROADMAP item 10" in proc.stderr
        assert "[hotpath]" not in proc.stdout and "[slab_split]" not in proc.stdout

    def test_slab_split_metrics_agree(self):
        """--slab-split prints the split histograms' exposition beside the
        rows: 30 samples a stage, and each row's p50 inside the bucket
        the exposition's cumulative counts put half the samples in."""
        proc = _PLATFORM._run_tool("api_ratelimit_tpu_torch.tools.hotpath_profile", ("--slab-split",))
        assert proc.returncode == 0, proc.stderr[-500:]
        lines = proc.stdout.splitlines()
        head = [ln for ln in lines if ln.startswith("[slab_split] ways=")][0]
        assert "ways=4" in head and "rows=262144" in head and "device=cpu" in head
        for stage in ("gather", "scan", "scatter"):
            row = [ln for ln in lines if ln.strip().startswith(f"{stage}_ns")][0]
            p50_ms = int(row.split("p50=")[1].split()[0]) / 1e6
            count = [ln for ln in lines if ln.startswith(f"ratelimit_slab_split_{stage}_ms_count")]
            assert count and float(count[0].split()[-1]) == 30
            buckets = [
                (float(ln.split('le="')[1].split('"')[0]), float(ln.split()[-1]))
                for ln in lines
                if ln.startswith(f"ratelimit_slab_split_{stage}_ms_bucket") and "+Inf" not in ln
            ]
            above = [n for le, n in buckets if le >= p50_ms]
            below = [n for le, n in buckets if le < p50_ms]
            assert not above or above[0] >= 15
            assert not below or below[-1] <= 15


# -- snapshot_inspect ------------------------------------------------------------

_PERSIST = reference_tests_on_the_port(
    "test_persist",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("use_pallas=False", 'device="cpu"'),
        (
            '    spec = importlib.util.spec_from_file_location(\n'
            '        "snapshot_inspect", os.path.join(REPO, "tools", "snapshot_inspect.py")\n'
            '    )\n'
            '    mod = importlib.util.module_from_spec(spec)\n'
            '    spec.loader.exec_module(mod)\n'
            '    return mod\n',
            "    import api_ratelimit_tpu_torch.tools.snapshot_inspect as mod\n\n    return mod\n",
        ),
        ("import tools.snapshot_inspect; ", "import api_ratelimit_tpu_torch.tools.snapshot_inspect; "),
    ),
)

TestSnapshotInspectCli = _PERSIST.TestSnapshotInspectCli


def test_inspector_renders_lease_section(tmp_path):
    """test_lease.py TestRegistrySnapshot's inspector case on the port's
    tool and a port engine's leases.snap."""
    ref = reference_tests_on_the_port(
        "test_lease",
        (
            ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
            ("TpuRateLimitCache", "CudaRateLimitCache"),
            ("use_pallas=False", 'device="cpu"'),
            (
                '        spec = importlib.util.spec_from_file_location(\n'
                '            "snapshot_inspect",\n'
                '            os.path.join(\n'
                '                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),\n'
                '                "tools",\n'
                '                "snapshot_inspect.py",\n'
                '            ),\n'
                '        )\n'
                '        snapshot_inspect = importlib.util.module_from_spec(spec)\n'
                '        spec.loader.exec_module(snapshot_inspect)\n',
                "        import api_ratelimit_tpu_torch.tools.snapshot_inspect as snapshot_inspect\n",
            ),
        ),
    )
    ref.TestRegistrySnapshot().test_inspect_tool_renders_lease_section(tmp_path)


def test_inspector_renders_algorithms(tmp_path):
    """test_algorithms.py TestSnapshotRoundTrip's inspector case on the
    port's tool."""
    ref = reference_tests_on_the_port(
        "test_algorithms",
        (
            ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
            ("TpuRateLimitCache", "CudaRateLimitCache"),
            ("import tools.snapshot_inspect as si", "import api_ratelimit_tpu_torch.tools.snapshot_inspect as si"),
        ),
    )
    ref.TestSnapshotRoundTrip().test_snapshot_inspect_renders_algorithms(tmp_path)


def _slab_rows(seed: int, n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 8), dtype=np.uint32)
    live = rng.random(n) < 0.6
    now = 1_000_000
    rows[live, 0] = rng.integers(1, 1 << 32, live.sum(), dtype=np.uint64)
    rows[live, 1] = rng.integers(1, 1 << 32, live.sum(), dtype=np.uint64)
    rows[live, 2] = rng.integers(1, 500, live.sum())
    rows[live, 3] = now - rng.integers(0, 120, live.sum())
    rows[live, 4] = now + rng.integers(-30, 90, live.sum())
    rows[live, 5] = 60 | (rng.integers(0, 4, live.sum()) << 28)
    return rows


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_inspector_reports_equal_across_packages(tmp_path, writer, capsys):
    """One slab.snap from each package's writer: the two inspectors' JSON
    reports are equal (the path aside, which names the file)."""
    from api_ratelimit_tpu_torch.persist import snapshot as port_snapshot

    mod = jax_snapshot if writer == "jax" else port_snapshot
    path = str(tmp_path / "slab.snap")
    mod.write_snapshot(path, _slab_rows(7), created_at=1_000_000, ways=4, shard_index=0, shard_count=1)
    sys.path.insert(0, REPO)
    try:
        import tools.snapshot_inspect as jax_inspect
    finally:
        sys.path.remove(REPO)
    assert jax_inspect.main(["--json", "--now", "1000010", path]) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_inspect.main(["--json", "--now", "1000010", path]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want and got[0]["valid"] and got[0]["rows"]["occupied"] > 0


# -- the lints ------------------------------------------------------------------

_METRICS = reference_tests_on_the_port(
    "test_metrics_lint",
    (
        (
            '    spec = importlib.util.spec_from_file_location(\n'
            '        "metrics_lint", os.path.join(REPO, "tools", "metrics_lint.py")\n'
            '    )\n'
            '    mod = importlib.util.module_from_spec(spec)\n'
            '    spec.loader.exec_module(mod)\n'
            '    return mod\n',
            "    from api_ratelimit_tpu_torch.tools import metrics_lint as mod\n\n    return mod\n",
        ),
    ),
)

test_package_stat_names_are_clean = _METRICS.test_package_stat_names_are_clean
test_linter_flags_violations = _METRICS.test_linter_flags_violations
test_multiline_registrations_are_seen = _METRICS.test_multiline_registrations_are_seen
test_readme_metric_names_exist_in_source = _METRICS.test_readme_metric_names_exist_in_source
test_readme_drift_is_flagged = _METRICS.test_readme_drift_is_flagged


class TestPortLints:
    def test_all_three_clean_on_the_port(self):
        assert clock_lint.run() == []
        assert fault_lint.run() == []
        assert metrics_lint.lint() + metrics_lint.lint_readme() + metrics_lint.lint_port_families() == []

    def test_port_families_are_documented(self, tmp_path):
        readme = tmp_path / "README.md"
        readme.write_text(
            "## PyTorch/CUDA port (`x`)\n"
            "`ratelimit.repl.bytes_shipped` and `ratelimit.owner.launches.<kernel>`\n"
            "## Next\n`ratelimit.owner.merge.count` outside the section\n"
        )
        findings = metrics_lint.lint_port_families(str(readme))
        assert len(findings) == 2
        assert any("ratelimit.owner.merge." in f for f in findings)
        assert any("ratelimit.owner.shm." in f for f in findings)

    def test_clock_lint_flags_a_raw_read(self, tmp_path):
        copy = tmp_path / "repo"
        shutil.copytree(PORT, copy / "api_ratelimit_tpu_torch", ignore=shutil.ignore_patterns("__pycache__", "_native", "build"))
        target = copy / "api_ratelimit_tpu_torch" / "backends" / "lease.py"
        target.write_text(target.read_text() + "\n\ndef _planted():\n    return time.time()\n")
        findings = clock_lint.run(str(copy))
        assert len(findings) == 1 and "backends/lease.py" in findings[0] and "raw time.time()" in findings[0]
        # the pragma, with its reason, clears it
        target.write_text(target.read_text().replace("return time.time()", "return time.time()  # clock-ok: planted"))
        assert clock_lint.run(str(copy)) == []

    def test_clock_lint_flags_a_missing_module(self, tmp_path):
        copy = tmp_path / "repo"
        shutil.copytree(PORT, copy / "api_ratelimit_tpu_torch", ignore=shutil.ignore_patterns("__pycache__", "_native", "build"))
        os.remove(copy / "api_ratelimit_tpu_torch" / "backends" / "victim.py")
        assert clock_lint.run(str(copy)) == ["api_ratelimit_tpu_torch/backends/victim.py: listed module missing"]

    def test_fault_lint_flags_an_undocumented_site_and_an_untested_one(self, tmp_path):
        pkg = tmp_path / "pkg"
        shutil.copytree(PORT, pkg, ignore=shutil.ignore_patterns("__pycache__", "_native", "build"))
        site = "planted" + ".site"  # not a literal here: this file is copied too
        (pkg / "planted.py").write_text(f'def f(faults):\n    return faults.fire("{site}")\n')
        tests = tmp_path / "tests"
        tests.mkdir()
        for name in os.listdir(os.path.join(REPO, "tests")):
            if name.startswith("test_torch_") and name.endswith(".py"):
                shutil.copy(os.path.join(REPO, "tests", name), tests / name)
        findings = fault_lint.run(str(pkg), str(tests))
        assert any(f.startswith(f"{site}: fire()d in the package but missing") for f in findings)
        assert any(f.startswith(f"{site}: no tests/test_torch_") for f in findings)
        # a documented site whose only port test is removed
        apply_site = "repl" + ".apply"
        os.remove(tests / "test_torch_chaos_engine.py")
        assert any(f.startswith(f"{apply_site}: no tests/test_torch_") for f in fault_lint.run(str(pkg), str(tests)))


# -- imports and provenance -------------------------------------------------------

NEW_MODULES = (
    "api_ratelimit_tpu_torch.chaos",
    "api_ratelimit_tpu_torch.chaos.campaign",
    "api_ratelimit_tpu_torch.chaos.harness",
    "api_ratelimit_tpu_torch.chaos.invariants",
    "api_ratelimit_tpu_torch.chaos.ledger",
    "api_ratelimit_tpu_torch.chaos.nemesis",
    "api_ratelimit_tpu_torch.chaos.shrink",
    "api_ratelimit_tpu_torch.tools.chaos_campaign",
    "api_ratelimit_tpu_torch.tools.clock_lint",
    "api_ratelimit_tpu_torch.tools.fault_lint",
    "api_ratelimit_tpu_torch.tools.metrics_lint",
    "api_ratelimit_tpu_torch.tools.snapshot_inspect",
    "api_ratelimit_tpu_torch.tools.journey_report",
    "api_ratelimit_tpu_torch.tools.hotpath_profile",
    "api_ratelimit_tpu_torch.tools.service_stack",
    "api_ratelimit_tpu_torch.tools.profile_probe",
)


def test_new_modules_import_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['api_ratelimit_tpu'] = None\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'api_ratelimit_tpu.')) for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert proc.stdout.strip() == "ok"


def test_fleet_master_metrics_carry_a_verified_build_block():
    from api_ratelimit_tpu.utils import provenance as jax_provenance
    from api_ratelimit_tpu_torch.cmd import service_cmd
    from api_ratelimit_tpu_torch.settings import Settings

    server = service_cmd._serve_fleet_aggregator(Settings(debug_port=0), [1, 2])
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            doc = json.loads(r.read())
    finally:
        server.shutdown()
    assert doc["member_debug_ports"] == [1, 2]
    assert provenance.verify(doc["build"]) and jax_provenance.verify(doc["build"])
    assert (doc["build"]["platform"], doc["build"]["device_count"]) == ("cpu", 0)


# -- /debug/profile (C10) ----------------------------------------------------------


class TestDeviceProfileQuiesce:
    def _server(self, profile_dir):
        from api_ratelimit_tpu_torch.server.http_server import new_debug_server
        from api_ratelimit_tpu_torch.stats import Store

        server = new_debug_server(Store(), profile_dir=profile_dir)
        server.serve_background()
        return server

    def test_sessions_start_and_stop_quiesced(self, tmp_path):
        """The profiler session starts inside profile_quiesce() and stops
        inside it again; the answer is the reference's {profile_dir, ms}
        and one trace file lands."""
        import contextlib

        profile_dir = str(tmp_path / "profiles")
        server = self._server(profile_dir)
        entered = []

        @contextlib.contextmanager
        def quiesce():
            # the session is off when the first hold begins and on when the
            # second does; each hold ends with the switch made inside it
            before = torch.autograd._profiler_enabled()
            yield
            entered.append((before, torch.autograd._profiler_enabled()))

        server.profile_quiesce = quiesce
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/debug/profile?ms=5", timeout=60) as r:
                assert r.status == 200
                assert json.loads(r.read()) == {"profile_dir": profile_dir, "ms": 5.0}
        finally:
            server.shutdown()
        assert entered == [(False, True), (True, False)]
        assert len(os.listdir(profile_dir)) == 1

    def test_warm_up_writes_nothing_and_holds_the_capture_lock(self, tmp_path):
        from api_ratelimit_tpu_torch.server import http_server

        profile_dir = str(tmp_path / "profiles")
        server = self._server(profile_dir)
        seen = []
        real = http_server.capture_device_trace

        def spy(path, ms, quiesce=None):
            seen.append((path, ms, server.profile_lock.locked()))
            return real(path, ms, quiesce)

        try:
            http_server.capture_device_trace = spy
            http_server.warm_device_profiler(server)
        finally:
            http_server.capture_device_trace = real
            server.shutdown()
        assert seen == [(None, 1.0, True)]
        assert not os.path.exists(profile_dir)

    def test_engine_quiesce_holds_the_state_lock(self):
        from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
        from api_ratelimit_tpu_torch.utils import FakeTimeSource

        engine = SlabDeviceEngine(FakeTimeSource(1000), n_slots=64, ways=4, buckets=(16,), device="cpu")
        try:
            with engine.launches_quiesced():
                assert engine._state_lock.locked()
            assert not engine._state_lock.locked()
        finally:
            engine.close()

    def test_runner_wires_the_quiesce_and_warms_at_boot(self, tmp_path):
        """A Runner with TPU_PROFILE_DIR: its debug server's quiesce is the
        engine's, and the boot took the warm-up session (no file)."""
        from api_ratelimit_tpu_torch.runner import Runner
        from api_ratelimit_tpu_torch.server import http_server
        from api_ratelimit_tpu_torch.settings import new_settings

        root = tmp_path / "runtime"
        (root / "rl" / "config").mkdir(parents=True)
        (root / "rl" / "config" / "c.yaml").write_text(
            "domain: d\ndescriptors:\n  - key: k\n    rate_limit: {unit: minute, requests_per_unit: 5}\n"
        )
        profile_dir = str(tmp_path / "profiles")
        env = {
            "RUNTIME_ROOT": str(root), "RUNTIME_SUBDIRECTORY": "rl", "USE_STATSD": "false", "PORT": "0",
            "GRPC_PORT": "0", "DEBUG_PORT": "0", "TPU_SLAB_SLOTS": "1024", "SLAB_WAYS": "4",
            "TPU_BUCKETS": "16", "TPU_PROFILE_DIR": profile_dir,
        }
        warmed = []
        real = http_server.warm_device_profiler
        import api_ratelimit_tpu_torch.runner as runner_mod

        runner_mod.warm_device_profiler = lambda server: (warmed.append(server.profile_quiesce), real(server))
        try:
            runner = Runner(new_settings(env), device="cpu")
            runner.run_background()
            try:
                assert runner.wait_ready(30.0)
                engine = runner.cache.engine
                assert runner.server.debug.profile_quiesce == engine.launches_quiesced
                assert warmed == [engine.launches_quiesced]
                assert not os.path.exists(profile_dir)
            finally:
                runner.stop()
        finally:
            runner_mod.warm_device_profiler = real
