"""The port's chaos campaign engine (api_ratelimit_tpu_torch/chaos/) and its
registry lints on the CPU, against the JAX package's chaos/.

* Every class of the JAX package's tests/test_chaos_engine.py runs on the
  port (reference_tests_on_the_port): the timeline, the campaign's
  determinism and a composed smoke, the weakened crash term caught,
  blamed, shrunk and emitted as a repro that still fails, clock skew,
  /debug/faults and /debug/clock, OP_FAULTS_SET/OP_CLOCK_SET, the fault
  qualifiers, the ledger and the checker, and TestRegistryLints with the
  port's clock and fault lints clean on the port. Campaigns and the
  shrinker run with device="cpu".
* One seed, one canonical JSON across the packages: for seeds 1-3 the
  port's run_campaign(seed, device="cpu") equals the JAX package's
  byte for byte (timeline_crc too). The JAX coordinator runs with C7's
  repair for this (ROADMAP queue C: the reference's pump forgets a home's
  window count); seed 2 is one where that repair alone moves the bytes.
* The harvest reads the tier's overflow loss by name: a seed whose tier
  overflows charges a loss above 0, and an engine without the tier
  raises instead of reading 0.
* Provenance blocks verify across the packages, and a campaign artifact
  carries a verified block.
* The two fault sites the port's lint found no port test for:
  dispatch.ring_publish and repl.apply, each fired on the port.
"""

import importlib.util
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu.cluster import federation as jax_fed  # noqa: E402
from api_ratelimit_tpu.utils import provenance as jax_prov  # noqa: E402
from api_ratelimit_tpu_torch.chaos import campaign as port_campaign  # noqa: E402
from api_ratelimit_tpu_torch.chaos.harness import ChaosHarness  # noqa: E402
from api_ratelimit_tpu_torch.chaos.nemesis import canonical_json  # noqa: E402
from api_ratelimit_tpu_torch.cluster import federation as port_fed  # noqa: E402
from api_ratelimit_tpu_torch.utils import provenance as port_prov  # noqa: E402
from chaos import campaign as jax_campaign  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_chaos_engine",
    (
        (
            "from chaos.campaign import CampaignConfig, run_campaign\n",
            "import functools\n"
            "from api_ratelimit_tpu_torch.chaos import campaign as _campaign\n"
            "from api_ratelimit_tpu_torch.chaos import shrink as _shrink\n"
            "from api_ratelimit_tpu_torch.chaos.campaign import CampaignConfig\n"
            'run_campaign = functools.partial(_campaign.run_campaign, device="cpu")\n',
        ),
        ("from chaos.invariants import", "from api_ratelimit_tpu_torch.chaos.invariants import"),
        ("from chaos.ledger import", "from api_ratelimit_tpu_torch.chaos.ledger import"),
        ("from chaos.nemesis import (", "from api_ratelimit_tpu_torch.chaos.nemesis import ("),
        (
            "from chaos.shrink import ddmin, emit_repro, shrink_timeline\n",
            "from api_ratelimit_tpu_torch.chaos.shrink import ddmin, emit_repro\n"
            'shrink_timeline = functools.partial(_shrink.shrink_timeline, device="cpu")\n',
        ),
        ("from chaos.harness import ChaosHarness", "from api_ratelimit_tpu_torch.chaos.harness import ChaosHarness"),
        ("ChaosHarness(77, tempfile.mkdtemp())", 'ChaosHarness(77, tempfile.mkdtemp(), device="cpu")'),
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("use_pallas=False", 'device="cpu"'),
        # the port's debug server takes the store first (its other callers')
        ('new_debug_server("127.0.0.1", 0, Store(TestSink()))', 'new_debug_server(Store(TestSink()), "127.0.0.1", 0)'),
        ("from tools import clock_lint", "from api_ratelimit_tpu_torch.tools import clock_lint"),
        ("from tools import fault_lint", "from api_ratelimit_tpu_torch.tools import fault_lint"),
    ),
)

TestTimeline = _REF.TestTimeline
TestCampaignDeterminism = _REF.TestCampaignDeterminism
TestWeakenedBoundAndShrink = _REF.TestWeakenedBoundAndShrink
TestClockSkew = _REF.TestClockSkew
TestRuntimeReconfig = _REF.TestRuntimeReconfig
TestFaultQualifiers = _REF.TestFaultQualifiers
TestLedgerAndInvariants = _REF.TestLedgerAndInvariants
TestRegistryLints = _REF.TestRegistryLints


def _jax_json(seed: int, monkeypatch, repaired: bool = True) -> str:
    """The JAX package's canonical campaign JSON for `seed`; repaired: its
    coordinator's _gc is the port's (C7)."""
    if repaired:
        monkeypatch.setattr(jax_fed.FederationCoordinator, "_gc", port_fed.FederationCoordinator._gc)
    return canonical_json(jax_campaign.run_campaign(seed))


class TestAcrossPackages:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_one_seed_one_canonical_json(self, seed, monkeypatch):
        port = port_campaign.run_campaign(seed, device="cpu")
        ref = jax_campaign.run_campaign(seed) if seed != 2 else None
        want = _jax_json(seed, monkeypatch)
        assert port["verdict"] == "ok", port["violations"]
        assert canonical_json(port) == want
        if ref is not None:  # seeds 1 and 3 never reach C7's path
            assert canonical_json(ref) == want
        assert port["timeline_crc"] == jax_campaign.run_campaign(seed)["timeline_crc"]

    def test_c7_is_the_only_difference_on_seed_2(self, monkeypatch):
        """Seed 2's campaign reaches the home's _gc with a granted window
        (C7): the reference's pump raises there and its home forgets the
        window's count, so fed/b admits one more. With the reference's _gc
        on the port the bytes are the JAX package's again."""
        port = canonical_json(port_campaign.run_campaign(2, device="cpu"))
        ref = _jax_json(2, monkeypatch, repaired=False)
        assert port != ref
        monkeypatch.setattr(port_fed.FederationCoordinator, "_gc", jax_fed.FederationCoordinator._gc)
        assert canonical_json(port_campaign.run_campaign(2, device="cpu")) == ref

    def test_replay_matches_on_the_cpu(self):
        cfg = port_campaign.CampaignConfig(steps=40)
        assert port_campaign.replay_matches(4, config=cfg, device="cpu")

    def test_config_doc_names_no_device(self):
        doc = port_campaign.run_campaign(5, config=port_campaign.CampaignConfig(steps=10), device="cpu")
        assert "device" not in canonical_json(doc["config"]) and "cpu" not in canonical_json(doc)


class TestHarvest:
    def test_overflowing_tier_charges_its_loss(self):
        """Seed 1 at the default config overflows the 24-row tier: the
        harvested loss (overflow_lost_count_sum, read by name) is above 0
        and the bound still holds."""
        result = port_campaign.run_campaign(1, device="cpu")
        assert result["ledger"]["evict_lost"] > 0
        assert result["verdict"] == "ok"

    def test_a_missing_tier_raises_instead_of_reading_zero(self):
        harness = ChaosHarness(3, tempfile.mkdtemp(), victim_max_rows=0, device="cpu")
        try:
            with pytest.raises(AttributeError):
                harness.finalize()
        finally:
            harness.close()


class TestProvenance:
    def test_blocks_verify_across_packages(self):
        port = port_prov.build_provenance("gpu", 1, device_name="NVIDIA H100 80GB HBM3")
        ref = jax_prov.build_provenance("cpu", 0)
        assert jax_prov.verify(port) and port_prov.verify(port)
        assert port_prov.verify(ref) and jax_prov.verify(ref)
        assert port_prov.platform_marker(port).startswith("gpu/dev1/")
        assert port_prov.platform_marker(port).endswith("/nvidia-h100-80gb-hbm3")
        assert port_prov.platform_marker(ref) == jax_prov.platform_marker(ref)
        tampered = dict(port, device_count=2)
        assert not jax_prov.verify(tampered) and not port_prov.verify(tampered)

    def test_artifact_block_verifies(self):
        cfg = port_campaign.CampaignConfig(steps=20)
        results = port_campaign.run_seeds([1, 2], config=cfg, device="cpu")
        doc = port_campaign.build_artifact(results, cfg, 19, device="cpu")
        assert doc["platform"] == "cpu" and doc["verdict"] == "ok"
        assert jax_prov.verify(doc["provenance"]) and port_prov.verify(doc["provenance"])
        assert [s["seed"] for s in doc["seeds"]] == [1, 2]


class TestPortFaultSites:
    def test_dispatch_ring_publish_error_abandons_the_frame(self):
        """dispatch.ring_publish:error — the torn-frame window: the
        frontend abandons its frame before the seqno store, so the owner
        never launches it and the caller gets a CacheError."""
        from api_ratelimit_tpu_torch.backends.dispatch import DispatchLoop
        from api_ratelimit_tpu_torch.backends.shm_ring import ShmControlServer, ShmRingClient
        from api_ratelimit_tpu_torch.limiter.cache import CacheError
        from api_ratelimit_tpu_torch.testing.faults import FaultInjector

        launched = []

        def launch(blocks):
            launched.extend(int(v) for b in blocks for v in b[2])
            return [np.array(b[2]) for b in blocks]

        loop = DispatchLoop(launch, lambda token: np.concatenate(token))
        path = os.path.join(tempfile.mkdtemp(), "ctl.sock")
        server = ShmControlServer(loop, path)
        faults = FaultInjector.from_spec("dispatch.ring_publish:error:1.0:times=1")
        client = ShmRingClient(path, arena_rows=64, fault_injector=faults)
        block = np.zeros((6, 1), dtype=np.uint32)
        block[2] = 7
        try:
            with pytest.raises(CacheError, match="dispatch.ring_publish"):
                client.submit(block)
            assert launched == []
            assert client.submit(block).tolist() == [7]
            assert launched == [7]
        finally:
            client.close()
            server.close()
            loop.close()

    def test_repl_apply_torn_write_forces_a_resync(self, tmp_path):
        """repl.apply:torn_write at the standby: the frame is refused
        before it is applied, the stream resyncs, and the standby ends
        equal to the primary (the reference's TestResync case)."""
        repl = reference_tests_on_the_port(
            "test_replication",
            (
                ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
                ("use_pallas=False", 'device="cpu"'),
            ),
        )
        repl.TestResync().test_apply_corruption_forces_resync(tmp_path)


def test_emitted_repro_imports_the_port_on_the_cpu(tmp_path):
    from api_ratelimit_tpu_torch.chaos.shrink import emit_repro

    cfg = port_campaign.CampaignConfig(**_REF.KILL_ONLY)
    path = emit_repro(str(tmp_path / "repro.py"), 3, [{"step": 6, "cls": "process_kill", "role": "owner"}], config=cfg, weaken="crash")
    text = open(path).read()
    assert "from api_ratelimit_tpu_torch.chaos.campaign import" in text and 'device="cpu"' in text
    spec = importlib.util.spec_from_file_location("port_chaos_repro", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.test_chaos_repro()
