"""The compare/select micro-benchmark's two kernels (ops/select_kernels.py)
and the port's tool, on the CPU, against the JAX tool's own Pallas kernels.

tools/microbench_compare_paths.py is run unchanged with jax.jit made the
identity and pallas_call wrapped to pass interpret=True and record every
call's input and output; sel_plain and chain_plain must equal each recorded
output bit for bit (tolerance 0: integers). The recorded Pallas calls are
then replayed on full-range and edge inputs, and both plain versions are
held against the tool's jnp semantics (xla_sel_out's where and xla_chain)
rebuilt here."""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from api_ratelimit_tpu_torch.ops import select_kernels as SEL  # noqa: E402
from api_ratelimit_tpu_torch.ops import slab_kernels as K  # noqa: E402
from api_ratelimit_tpu_torch.tools import microbench_compare_paths as port_tool  # noqa: E402

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
EDGES = [
    INT_MIN, INT_MIN + 1, INT_MAX, INT_MAX - 1, 0, 1, -1, 3, -3, 7, -5,
    1 << 30, (1 << 30) + 1, (1 << 30) - 1, (1 << 30) + 3, (1 << 30) - 5,
    1 << 29, (1 << 29) + 1, (1 << 29) - 1, (1 << 29) + 3, (1 << 29) - 5,
    -(1 << 30), -(1 << 29), INT_MAX - 4, INT_MIN + 3,
]


def _edge_input(rows: int = 64) -> np.ndarray:
    """int32[rows, 128]: every edge value (and its neighbours mod 8), then
    full-range random int32."""
    rng = np.random.default_rng(41)
    n = rows * 128
    edges = np.array([e + d for e in EDGES for d in range(-2, 3)], np.int64)
    edges = ((edges + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    rand = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
    rand[: edges.size] = edges
    return rand.reshape(rows, 128)


def _jnp_sel(x):
    now = jnp.int32(1 << 30)
    return jnp.where(x > now, x, -x)


def _jnp_chain(x):
    """The JAX tool's xla_chain body."""
    now = jnp.int32(1 << 30)
    m1 = x > now
    m2 = (x & 7) == 3
    m3 = x < (now >> 1)
    r = jnp.where(m1, x, -x)
    r = jnp.where(m2, r + 1, r)
    return jnp.where(m3 & m1, r ^ 21, r)


@pytest.fixture(scope="module")
def jax_tool_calls():
    """Run the JAX tool at --batch 8192 --repeats 2 with interpret-mode
    Pallas; returns [(kernel name, replayable call, input, output)]."""
    mp = pytest.MonkeyPatch()
    calls = []
    real = pl.pallas_call

    def interpreted(kernel, *args, **kwargs):
        call = real(kernel, *args, interpret=True, **kwargs)

        def run(x):
            out = call(x)
            calls.append((kernel.__name__, call, np.asarray(x), np.asarray(out)))
            return out

        return run

    tool = importlib.import_module("tools.microbench_compare_paths")
    mp.setattr(pl, "pallas_call", interpreted)
    mp.setattr(jax, "jit", lambda f: f)
    mp.setattr("sys.argv", ["microbench_compare_paths", "--batch", "8192", "--repeats", "2"])
    try:
        tool.main()
    finally:
        mp.undo()
    return calls


def test_jax_tool_ran_both_kernels_in_interpret_mode(jax_tool_calls):
    names = [name for name, *_ in jax_tool_calls]
    # timeit: one warm call, then one per repeat
    assert names.count("sel_kernel") == 3 and names.count("chain_kernel") == 3
    for _name, _call, x, out in jax_tool_calls:
        assert x.shape == out.shape == (64, 128)
        assert x.dtype == out.dtype == np.int32


@pytest.mark.parametrize("name,plain", [("sel_kernel", SEL.sel_plain), ("chain_kernel", SEL.chain_plain)])
def test_plain_versions_equal_the_tools_pallas_kernels(jax_tool_calls, name, plain):
    seen = 0
    for kname, _call, x, out in jax_tool_calls:
        if kname != name:
            continue
        got = plain(torch.from_numpy(x.reshape(-1).copy())).numpy()
        assert np.array_equal(got, out.reshape(-1))
        seen += 1
    assert seen == 3


@pytest.mark.parametrize("name,plain,ref", [
    ("sel_kernel", SEL.sel_plain, _jnp_sel),
    ("chain_kernel", SEL.chain_plain, _jnp_chain),
])
def test_edge_inputs_match_pallas_and_jnp(jax_tool_calls, name, plain, ref):
    """Full-range int32 with INT_MIN, INT_MAX, 2^30 +- 1, 2^29 +- 1: the
    recorded Pallas call replayed on them, the tool's jnp semantics and the
    plain version agree bit for bit (negation and +1 wrap)."""
    x = _edge_input()
    call = next(c for k, c, *_ in jax_tool_calls if k == name)
    want = np.asarray(call(jnp.asarray(x))).reshape(-1)
    assert np.array_equal(np.asarray(ref(jnp.asarray(x))).reshape(-1), want)
    got = plain(torch.from_numpy(x.reshape(-1).copy())).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the wraps are exercised: -INT_MIN stays INT_MIN
    i = int(np.flatnonzero(x.reshape(-1) == INT_MIN)[0])
    assert got[i] == INT_MIN


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    x = torch.from_numpy(_edge_input(3).reshape(-1)[:301].copy())  # not a multiple of 128
    K.reset_launch_counts()
    assert torch.equal(SEL.sel(x), SEL.sel_plain(x))
    assert torch.equal(SEL.chain(x), SEL.chain_plain(x))
    assert SEL.sel(x[:0]).shape == (0,)
    assert K.LAUNCHES["sel"] == 0 and K.LAUNCHES["chain"] == 0
    for fn in (SEL.sel, SEL.chain):
        with pytest.raises(ValueError):
            fn(x.long())  # int32 only
        with pytest.raises(ValueError):
            fn(x[:300].view(3, 100))  # flat only
        with pytest.raises(ValueError):
            fn(x[::2])  # contiguous only
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.empty(4, dtype=torch.int32, device="meta"))


def test_port_tool_cpu_run_prints_one_json_line(capsys):
    out = port_tool.main(["--device", "cpu", "--batch", "1048576", "--repeats", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc == out
    assert doc["platform"] == "cpu" and doc["device"] == "cpu"
    assert doc["batch"] == 8192  # shrunk off the card, as the JAX tool does
    labels = [label for label, _ in port_tool.OPS]
    assert len(labels) == 10 and "cuda_sel_out" in labels and "cuda_chain_out" in labels
    for label in labels:
        assert isinstance(doc[label], float) and doc[label] >= 0


def test_port_tool_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_tool.main(["--batch", "256", "--repeats", "1"])
