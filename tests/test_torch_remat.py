"""The remat policies "dots" and "dots_no_batch" (`models/base.py`,
`REMAT_SAVED_OPS`) against the JAX package's `wrap_remat`
(`dlwpbench_tpu/models/base.py:59-78`, JAX 0.9's `dots_saveable` and
`dots_with_no_batch_dims_saveable`).

For a `RolloutModel` (the Swin on its einsum route: Linear, batched
products and the patch convolutions) and a `RecurrentModel` (ConvLSTM:
convolutions):
- the gradients under each policy equal those under "full" and without
  remat within 1e-6 of each tensor's max (the same ops, recomputed or
  kept), and JAX's under the same policy within 1e-4 (fp32, two
  frameworks' summation orders);
- a dispatch-mode count of the backward pass: "full" recomputes the
  step's mm, addmm, bmm and convolution calls; "dots" recomputes none of
  them; "dots_no_batch" recomputes the batched products (bmm) and the
  convolutions, as JAX recomputes dot_generals with batch dimensions and
  conv_general_dilated under `dots_with_no_batch_dims_saveable`, and no
  mm or addmm.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _jax_ref as jax_ref
from dlwpbench_tpu.models import convlstm as jconv
from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import convlstm as tconv
from dlwpbench_tpu_torch.models import swin as tswin

MODEL_TOL = 1e-4
POLICIES = ("dots", "dots_no_batch")
MODELS = {
    "swin": (jswin.SwinTransformer, tswin.SwinTransformer,
             dict(img_height=8, img_width=16, constant_channels=2, prescribed_channels=1,
                  prognostic_channels=3, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                  use_flash_attention=False), (2, 1, 3)),
    "convlstm": (jconv.ConvLSTM, tconv.ConvLSTM,
                 dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
                      hidden_sizes=(4, 6)), (2, 1, 2)),
}
COUNTED = ("aten.mm.default", "aten.addmm.default", "aten.bmm.default",
           "aten.convolution.default")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _inputs(channels, seed=0, B=2, T=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cc, cp, cq = channels
    return f(B, 1, cc, 8, 16), f(B, T, cp, 8, 16), f(B, T, cq, 8, 16), f(B, T - 1, cq, 8, 16)


def _port_grads(name, params, policy, arrays):
    """(flat flax-layout gradients, the backward pass's counted calls)."""
    _, tcls, kw, _ = MODELS[name]
    remat = policy is not None
    model = tcls(**kw, remat=remat, remat_policy=policy or "full")
    weights.load_flax_params(model, params)
    const, pres, prog, target = (torch.from_numpy(a) for a in arrays)
    loss = torch.mean((model(const, pres, prog) - target) ** 2)
    with _Count() as count:
        loss.backward()
    grads = weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))
    return grads, {k: count.calls[k] for k in COUNTED}


def _close(got, want, tol):
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        scale = max(float(np.abs(w).max()), 1e-6)
        assert np.abs(g - w).max() <= tol * scale, (path, float(np.abs(g - w).max()), scale)


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for name, (jcls, _, kw, channels) in MODELS.items():
        const, pres, prog, _ = _inputs(channels)
        out[name] = jax.tree_util.tree_map(
            np.asarray, jax_ref.init(jcls(**kw), jax.random.PRNGKey(3), const, pres, prog))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_full_no_remat_and_jax(name, policy, jax_params):
    jcls, _, kw, channels = MODELS[name]
    arrays = _inputs(channels)
    params = jax_params[name]
    grads, _ = _port_grads(name, params, policy, arrays)
    full, _ = _port_grads(name, params, "full", arrays)
    plain, _ = _port_grads(name, params, None, arrays)
    _close(grads, full, 1e-6)
    _close(grads, plain, 1e-6)

    jmodel = jcls(**kw, remat=True, remat_policy=policy)
    const, pres, prog, target = arrays

    def loss_fn(p):
        return jnp.mean((jmodel.apply(p, const, pres, prog) - target) ** 2)

    want = weights.flatten_tree(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(params)["params"]))
    _close(grads, want, MODEL_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_backward_recomputes_by_jax_rule(name, jax_params):
    arrays = _inputs(MODELS[name][3])
    counts = {p: _port_grads(name, jax_params[name], p, arrays)[1]
              for p in (None, "full", "dots", "dots_no_batch")}
    # the forward's calls that each policy recomputes in the backward pass
    # (the backward's own products are mm calls, counted without remat too)
    recomputed = {p: {k: c[k] - counts[None][k] for k in COUNTED} for p, c in counts.items()}
    full, dots, no_batch = recomputed["full"], recomputed["dots"], recomputed["dots_no_batch"]
    assert full["aten.convolution.default"] > 0
    assert all(v == 0 for v in dots.values()), dots
    assert no_batch["aten.mm.default"] == no_batch["aten.addmm.default"] == 0, no_batch
    assert no_batch["aten.convolution.default"] == full["aten.convolution.default"]
    assert no_batch["aten.bmm.default"] == full["aten.bmm.default"]
    assert sum(dots.values()) < sum(no_batch.values()) <= sum(full.values())
    if name == "swin":  # Linear layers and the einsum route's batched products
        assert full["aten.addmm.default"] > 0 and full["aten.bmm.default"] > 0
        assert sum(no_batch.values()) < sum(full.values())
