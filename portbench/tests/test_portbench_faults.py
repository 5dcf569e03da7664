"""A run whose timed path is broken underneath comes out not correct: once
for each fault the cell can have. Tiny CPU runs; the look for a card is
skipped, the rest of the run is the harness's."""

import time

import pytest

from conftest import tiny
from harness import train_mix, view_mix


def _train(cpu, cell="seesaw.train"):
    cfg, mix, lim = tiny(cell)
    return train_mix.run(cfg, mix, lim, 2**31 + 17, 0.1, False, cpu, time.perf_counter())


def test_sound_training_run_is_correct(cpu_run):
    res = _train(cpu_run)
    assert res["correct"], res["checks"]


def test_a_step_that_leaves_its_state_unchanged(cpu_run, monkeypatch):
    from mobgs_tpu_torch.train import step as STEP
    monkeypatch.setattr(STEP, "adam_update",
                        lambda params, grads, state, lrs, **k: state._replace(step=state.step + 1))
    assert not _train(cpu_run)["correct"]


def test_a_fault_that_starts_after_set_up(cpu_run, monkeypatch):
    """Only the step after the window can see it: set-up's three steps are
    sound, every later step leaves its state unchanged."""
    from mobgs_tpu_torch.train import step as STEP
    update, calls = STEP.adam_update, [0]

    def late_fault(params, grads, state, lrs, **k):
        calls[0] += 1
        if calls[0] <= 3 * 4:  # set-up's three steps, four optimiser groups each
            return update(params, grads, state, lrs, **k)
        return state._replace(step=state.step + 1)
    monkeypatch.setattr(STEP, "adam_update", late_fault)
    res = _train(cpu_run)
    assert not res["correct"], res["checks"]
    assert res["checks"]["loss_gap"]["value"] <= res["checks"]["loss_gap"]["limit"]


def test_budgets_the_reference_would_not_choose(cpu_run, monkeypatch):
    from mobgs_tpu_torch.ops import rasterize as RZ
    monkeypatch.setattr(RZ, "validate_max_per_tile", lambda *a, **k: 2048 + 128)
    res = _train(cpu_run)
    assert res["checks"]["budgets_differ"]["value"] == 1.0 and not res["correct"]


def test_a_step_that_leaves_half_of_its_batch_out(cpu_run, monkeypatch):
    from mobgs_tpu_torch.train import loop as L
    call = L.DeviceBatcher.__call__
    monkeypatch.setattr(L.DeviceBatcher, "__call__", lambda self, ids: call(self, ids[:1]))
    assert not _train(cpu_run)["correct"]


def test_an_exposure_update_that_returns_the_old_scales(cpu_run, monkeypatch):
    from mobgs_tpu_torch.train import loop as L
    monkeypatch.setattr(L, "make_exposure_update", lambda *a, **k: lambda ts, *b: ts)
    assert not _train(cpu_run, "seesaw.train_late")["correct"]


@pytest.mark.parametrize("broken", [False, True])
def test_viewer_answers(cpu_run, monkeypatch, broken):
    import mobgs_tpu_torch.viewer as V
    if broken:
        make = V.make_viewer_render
        monkeypatch.setattr(V, "make_viewer_render",
                            lambda *a, **k: (lambda msg, f=make(*a, **k): f(msg) * 0.98))
    cfg, mix, lim = tiny("seesaw.view")
    res = view_mix.run(cfg, mix, lim, 31, 0.2, False, cpu_run, time.perf_counter())
    assert res["correct"] is (not broken), res["checks"]
