"""The JAX package's tests/test_chaos.py classes that need the port's whole
stack, run on the port (reference_tests_on_the_port): TestCircuitBreakerUnit,
TestSidecarRestart, TestClosedBatcherIsCacheError, TestFullStackAcceptance,
TestReplicationChaos, TestSigkillFailoverAcceptance,
TestSigkillDeviceOwnerWithLeases, TestVictimTierChaos and
TestSigkillVictimTier. tests/test_torch_faults.py runs the file's other five
classes.

The rewrite is test_torch_faults.py's (the reference's imports pointed at
the port, `use_pallas=False` -> `device="cpu"`, so the subprocess owners'
engines run on the CPU as well), plus BACKEND_TYPE tpu-sidecar ->
cuda-sidecar. The reference's degraded rung decides on the CPU and the
port refuses it, so test_degraded_local_full_stack checks the refusal at
the Runner's boot.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_victim import reference_tests_on_the_port  # noqa: E402

from api_ratelimit_tpu_torch.stats import Store, TestSink  # noqa: E402

_REF = reference_tests_on_the_port(
    "test_chaos",
    (
        ("api_ratelimit_tpu_torch.backends.tpu", "api_ratelimit_tpu_torch.backends.cuda"),
        ("TpuRateLimitCache", "CudaRateLimitCache"),
        ("use_pallas=False", 'device="cpu"'),
        ('backend_type="tpu-sidecar"', 'backend_type="cuda-sidecar"'),
        # the reference's degraded rung, which the port refuses, by name
        ("    FAILURE_MODE_DEGRADED,\n", ""),
        (
            "    CircuitBreaker,\n    FallbackLimiter,\n)\n",
            '    CircuitBreaker,\n    FallbackLimiter,\n)\n\nFAILURE_MODE_DEGRADED = "degraded"\n',
        ),
        ("        base_limiter=BaseRateLimiter(ts, near_limit_ratio=0.8),\n", ""),
        ("            base_limiter=base,\n", ""),
    ),
)

TestCircuitBreakerUnit = _REF.TestCircuitBreakerUnit
TestSidecarRestart = _REF.TestSidecarRestart
TestClosedBatcherIsCacheError = _REF.TestClosedBatcherIsCacheError
TestReplicationChaos = _REF.TestReplicationChaos
TestSigkillFailoverAcceptance = _REF.TestSigkillFailoverAcceptance
TestSigkillDeviceOwnerWithLeases = _REF.TestSigkillDeviceOwnerWithLeases
TestVictimTierChaos = _REF.TestVictimTierChaos
TestSigkillVictimTier = _REF.TestSigkillVictimTier


class TestFullStackAcceptance(_REF.TestFullStackAcceptance):
    def test_degraded_local_full_stack(self, tmp_path):
        """The reference's degraded rung answers from a process-local
        limiter on the CPU; the port's Runner refuses the knob at boot
        (ROADMAP "Deliberate departures"), before it binds a port."""
        with pytest.raises(ValueError, match="FAILURE_MODE_DENY=degraded"):
            self._boot(
                tmp_path,
                str(tmp_path / "slab.sock"),
                failure_mode_deny="degraded",
                fault_inject="sidecar.submit:error:1.0",
            )


@pytest.fixture
def test_store():
    """The port's store (the reference classes read its debug_snapshot)."""
    sink = TestSink()
    return Store(sink), sink
