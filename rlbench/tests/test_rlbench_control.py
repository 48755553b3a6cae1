"""The comparison fails what it must: the control (the reference in the
program's place without serialization) and the faults a served step can
have, each planted under the program at a tiny size on the CPU."""

import pytest

from rlbench import manifest as mf
from rlbench.owner import ControlOwner
from rlbench.run import run_cell
from rlbench_helpers import TINY_POOL_ROWS, cell_inputs

CELLS = ["fixed.zipf", "uniform.test", "algos.test"]


def _run(name, seed=11, **kw):
    manifest = mf.load()
    cell, config, traffic = cell_inputs(manifest, name)
    if name == "uniform.test":
        config["keys"] = 2000  # keys repeat within a tiny window
    return run_cell(manifest, cell, config, traffic, seed, 0.8, False, device="cpu",
                    pool_rows=TINY_POOL_ROWS, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    result, numbers = _run(name, make_owner=lambda c, clock, log, _s, _d: ControlOwner(c, clock, log))
    assert result["correct"] is False
    assert numbers["mismatched_rows"] > 0


def _unchanged(step):
    def run(state, packed, **kw):
        from api_ratelimit_tpu_torch.ops.slab import SlabState

        copy = SlabState.__new__(SlabState)
        copy.rows = state.rows.clone()
        copy.table = copy.rows[: state.table.shape[0]]
        return step(copy, packed, **kw)
    return run


def _half(step):
    def run(state, packed, **kw):
        packed = packed.clone()
        packed[2, packed.shape[1] // 2 :] = 0  # the second half's hits: never served
        return step(state, packed, **kw)
    return run


def _altered(step):
    def run(state, packed, **kw):
        out, *rest = step(state, packed, **kw)
        out = out.clone()
        out[0] = out[0].to(int) ^ 1
        return (out, *rest)
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_program_is_not_correct(name, fault, monkeypatch):
    import api_ratelimit_tpu_torch.backends.cuda as engine_module

    monkeypatch.setattr(engine_module, "slab_step_after", fault(engine_module.slab_step_after))
    result, numbers = _run(name)
    assert result["correct"] is False
    assert numbers["mismatched_rows"] > 0


def test_a_skipped_sketch_update_is_not_correct(monkeypatch):
    """The slab's counters are untouched by the sketch: only the sketch
    comparison sees an update that never runs."""
    import api_ratelimit_tpu_torch.ops.slab as slab_module

    monkeypatch.setattr(slab_module, "sketch_update", lambda planes, *a, **k: planes.clone())
    result, numbers = _run("fixed.zipf")
    assert result["correct"] is False
    assert numbers["mismatched_rows"] == 0 and numbers["sketch_missing_keys"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    result, numbers = _run(name)
    assert result["correct"] is True, numbers
