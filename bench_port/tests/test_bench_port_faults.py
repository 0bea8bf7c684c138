"""``correct`` comes out false with the timed path broken underneath, and
for the control: the reference in fp8 put in the program's place."""

import time

import pytest
import torch

from bench_port.calibrate import readings
from bench_port.core import checks, manifest
from bench_port.core.runner import run_cell
from bench_port.tests._small import SMALL, fp32_tower

CELLS = ["deepfm-criteo.steady", "widedeep-criteo.steady"]


def _limits(cell):
    """The cell's limits of the numbers a calibration reads."""
    lim = checks.load_limits(manifest.BENCH_DIR, cell)
    return {n: v for n, v in lim.items() if n in checks.NUMBERS}


def _run(cell):
    return run_cell(cell, 77, 0.2, False, device="cpu", overrides=SMALL, t_origin=time.perf_counter())


def _unchanged_state(monkeypatch):
    """Every step returns the state it was given (its metrics are real)."""
    from paddlebox_tpu_torch.train import resident_step

    real_make = resident_step.make_train_step

    def make(model_apply, cfg, dense_opt=None, eval_mode=False):
        real = real_make(model_apply, cfg, dense_opt, eval_mode)

        def step(state, batch):
            _, m = real(state._replace(table=state.table.clone()), batch)
            return state._replace(step=state.step + 1), m

        return step

    monkeypatch.setattr(resident_step, "make_train_step", make)


def _half_batch(monkeypatch):
    """The loss is the mean over the batch's first half, the rest left out."""
    from paddlebox_tpu_torch.train import train_step

    real = train_step.local_forward_backward

    def lfb(model_apply, cfg, params, flat, segments, labels, dense, ins_weight=None, loss_denom=None,
            rank_offset=None):
        B = labels.shape[0]
        w = torch.zeros(B, dtype=torch.float32, device=labels.device)
        w[: B // 2] = 1.0
        return real(model_apply, cfg, params, flat, segments, labels, dense, ins_weight=w,
                    loss_denom=torch.full((), float(B // 2), device=labels.device), rank_offset=rank_offset)

    monkeypatch.setattr(train_step, "local_forward_backward", lfb)


def _auc_labels_swapped(monkeypatch):
    """The AUC state counts a click as a non-click and the other way round."""
    from paddlebox_tpu_torch.train import train_step

    real = train_step.auc_update
    monkeypatch.setattr(train_step, "auc_update", lambda state, preds, labels, mask=None:
                        real(state, preds, 1.0 - labels, mask))


def _auc_one_bucket(monkeypatch):
    """The AUC state puts every prediction in one bucket (the batch's mean's)."""
    from paddlebox_tpu_torch.train import train_step

    real = train_step.auc_update
    monkeypatch.setattr(train_step, "auc_update", lambda state, preds, labels, mask=None:
                        real(state, preds.mean().expand_as(preds), labels, mask))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    fp32_tower(monkeypatch)
    assert _run(cell)["correct"]


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _auc_labels_swapped, _auc_one_bucket])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fp32_tower(monkeypatch)
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]


CONTROL_SIZE = {
    "config": {"records_per_pass": 12288, "key_space": 200_000},
    "traffic": {"batch": 4096, "files": 2, "hot_keys": 256},
}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The fp8 control fails one of the cell's numbers at the configuration's
    widths, on the CPU at a batch of 4,096."""
    lines = list(readings(cell, [3], {3}, device="cpu", overrides=CONTROL_SIZE))
    ok, shown = checks.judge(lines[0]["control"], _limits(cell))
    assert not ok, shown


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell, card):
    limits = _limits(cell)
    line = next(iter(readings(cell, [2**31 + 3], {2**31 + 3})))
    assert checks.judge(line["program"], limits)[0]
    assert not checks.judge(line["control"], limits)[0]
