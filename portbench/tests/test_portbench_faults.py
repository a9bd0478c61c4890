"""`correct` comes out false when the timed path is broken underneath or
when the reference runs in the precision below the configuration's:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a small size, against each cell's own limits.  The same control at
the cells' sizes runs on the card (`cuda`)."""

import itertools

import pytest
import torch

from portbench import check, inputs
from portbench.kinds import common, rollout, train
from portbench.run import run_cell
from portbench.tests._tiny import tiny

TRAIN = ["swin.train.b32", "pangu.train.b32"]
ROLLOUT = ["swin.rollout.b32x16", "pangu.rollout.b32x16"]
SEED = 2**31 + 2024


def _run(cell):
    return run_cell(cell, SEED, 0.0, False, torch.device("cpu"))


@pytest.mark.parametrize("name", TRAIN + ROLLOUT)
def test_a_sound_run_is_correct(name):
    assert _run(tiny(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(name, monkeypatch):
    from dlwpbench_tpu_torch.training.trainer import Trainer

    original = Trainer.train_step

    def unchanged(self, state, batch, lr, *a, **k):
        saved = [p.detach().clone() for p in state.model.parameters()]
        loss = original(self, state, batch, lr, *a, **k)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return loss

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    res = _run(tiny(name))
    assert not res["correct"] and res["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    from dlwpbench_tpu_torch.training.trainer import Trainer

    original = Trainer.train_step

    def half(self, state, batch, lr, *a, **k):
        n = batch[2].shape[0] // 2
        return original(self, state, tuple(None if x is None else x[:n] for x in batch), lr,
                        *a, **k)

    monkeypatch.setattr(Trainer, "train_step", half)
    assert not _run(tiny(name))["correct"]


@pytest.mark.parametrize("name", ROLLOUT)
def test_an_answer_altered_where_it_is_produced_is_caught(name, monkeypatch):
    from dlwpbench_tpu_torch.models.base import RolloutModel

    original = RolloutModel.forward

    def altered(self, *args):
        out = original(self, *args)
        out[:, -1] *= 1.01
        return out

    monkeypatch.setattr(RolloutModel, "forward", altered)
    res = _run(tiny(name))
    assert not res["correct"] and res["checks"]["forecast"]["value"] > 0


def _control_numbers(cell, device, seed=SEED):
    """The control's numbers: the reference in TF32 in the program's place,
    against the float32 reference."""
    tr = cell.traffic
    ctx = common.Context(config=cell.config, traffic=tr, limits=cell.limits, seed=seed,
                         seconds=0.0, trace=False, device=device)
    B, seq = tr["batch_size"], tr["sequence_length"]
    if tr["kind"] == "train":
        ds = inputs.windowed(cell.config["data"], seq, B * tr["batches_per_epoch"], seed,
                             device, 1)
        kept = list(itertools.islice(ds.batches(B, shuffle=True), tr["check_steps"]))
        ref = train.reference_readings(ctx, kept, "float32")
        ctl = train.reference_readings(ctx, kept, "tf32")
        return check.train_numbers(ctl[0], ref[0], ctl[1], ref[1], ctl[2], ref[2])
    split = inputs.windowed(cell.config["data"], seq, B * tr["batches_per_split"], seed, device, 1)
    host = list(split.batches(B))[:tr["check_batches"]]
    ref = rollout.reference_forecasts(ctx, host, "float32")
    ctl = rollout.reference_forecasts(ctx, host, "tf32")
    return {"forecast": max(rollout.forecast_gap(ctx, b, c, r) for b, c, r in zip(host, ctl, ref))}


@pytest.mark.parametrize("name", TRAIN + ROLLOUT)
def test_the_control_comes_out_not_correct(name):
    cell = tiny(name)
    ok, table = check.verdict(_control_numbers(cell, torch.device("cpu")), cell.limits)
    assert not ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + ROLLOUT)
def test_the_control_comes_out_not_correct_at_the_cells_size(name, card):
    from portbench import cells

    cell = cells.load_cell(name)
    ok, table = check.verdict(_control_numbers(cell, card), cell.limits)
    assert not ok, table
