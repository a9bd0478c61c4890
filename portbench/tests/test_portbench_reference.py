"""The benchmark's plain references against the program, on the CPU at a
small size, from the same drawn weights: each family's rollout and its
gradients, and three training steps (loss, clip, AdamW) against the
program's `Trainer`."""

import itertools

import numpy as np
import pytest
import torch

from portbench import inputs, weights
from portbench.kinds import common
from portbench.reference import reference_class
from portbench.reference import train as rt
from portbench.tests._tiny import tiny

CELLS = ["swin.train.b32", "pangu.train.b32"]


def _models(cell):
    from dlwpbench_tpu_torch.models import registry

    cfg = cell.config
    grid = (cfg["data"]["height"], cfg["data"]["width"])
    prog = registry.build_model(dict(cfg["model"]), seed=0, grid_shape=grid)
    ref = reference_class(cfg["family"])(**cfg["model"])
    return prog, ref


@pytest.mark.parametrize("name", CELLS)
def test_reference_names_and_shapes_match_the_program(name):
    prog, ref = _models(tiny(name))
    assert {n: p.shape for n, p in prog.named_parameters()} == \
        {n: p.shape for n, p in ref.named_parameters()}


@pytest.mark.parametrize("name", CELLS)
def test_reference_rollout_and_gradients_match_the_program(name):
    cell = tiny(name)
    prog, ref = _models(cell)
    w = weights.draw({n: p.shape for n, p in ref.named_parameters()},
                     inputs.generator(5, "weights", "cpu"), "cpu")
    weights.load(prog, w)
    weights.load(ref, w)
    ds = inputs.windowed(cell.config["data"], 5, 4, 5, "cpu", 1)
    const, pres, prog_in, target = inputs.host_batch_to(next(ds.batches(4)), "cpu")
    a, b = prog(const, pres, prog_in), ref(const, pres, prog_in)
    scale = (b - prog_in[:, :1]).abs().max()
    assert (a - b).abs().max() <= 1e-5 * scale
    ((a - target) ** 2).mean().backward()
    ((b - target) ** 2).mean().backward()
    grads = dict(prog.named_parameters())
    for n, p in ref.named_parameters():
        g = grads[n].grad
        assert (g - p.grad).abs().max() <= 1e-4 * p.grad.abs().max() + 1e-12, n


@pytest.mark.parametrize("name", CELLS)
def test_reference_training_steps_match_the_program_trainer(name):
    from dlwpbench_tpu_torch import train as port_train

    cell = tiny(name)
    cfg = cell.config
    trainer = port_train.build_trainer(common.port_config(cfg, 3), torch.device("cpu"))
    ref = reference_class(cfg["family"])(**cfg["model"])
    w = weights.draw({n: p.shape for n, p in ref.named_parameters()},
                     inputs.generator(9, "weights", "cpu"), "cpu")
    weights.load(trainer.model, w)
    weights.load(ref, w)
    ds = inputs.windowed(cfg["data"], 3, 8, 9, "cpu", 1)
    host = list(itertools.islice(ds.batches(4, shuffle=True), 3))
    state = trainer.init()
    p_losses = [float(trainer.train_step(state, inputs.host_batch_to(b, "cpu"), 1e-3))
                for b in host]
    tc = cfg["training"]
    r_losses, _ = rt.train_steps(ref, [inputs.host_batch_to(b, "cpu") for b in host],
                                 tc["learning_rate"], tc["optimizer_weight_decay"],
                                 tc["clip_gradients"], rows=2)
    np.testing.assert_allclose(p_losses, [float(x) for x in r_losses], rtol=1e-5)
    moved = dict(trainer.model.named_parameters())
    for n, p in ref.named_parameters():
        change = (p.detach() - w[n]).abs().max()
        assert (moved[n].detach() - p.detach()).abs().max() <= 1e-3 * change + 1e-9, n
