"""The port's HEALPix Swin (`SwinTransformerHPX`) against the JAX
package's, on JAX weights, on the CPU.

Inputs come from numpy seeds and go to both sides; JAX parameters reach
the port through `weights.load_flax_params`.  On the flash route the JAX
side's Pallas kernel runs in interpret mode and the port's wrapper takes
its plain version; on the token-major route JAX takes its einsum route
(its CPU default) and the port the token-major kernel's plain version.

Tolerance: the rollout and every parameter gradient within 1e-4 of that
tensor's max|value| (fp32, three closed-loop steps of two blocks; online
against two-pass softmax, flax's one-pass LayerNorm variance against
torch's two-pass).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models import swin as tswin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
SMALL = dict(img_height=4, img_width=4, constant_channels=2, prescribed_channels=1,
             prognostic_channels=2, embed_dim=16, depths=(2,), num_heads=(2,),
             exact_gelu=True)
ROUTES = {  # id: (JAX kwargs, port kwargs)
    "flash": (dict(use_flash_attention=True), dict(use_flash_attention=True)),
    "token-major": (dict(use_flash_attention=None, window_size=(4, 4)),
                    dict(use_flash_attention="packed", window_size=(4, 4))),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, B=2, T=4, n=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, 1, 2, 12, n, n), f(B, T, 1, 12, n, n), f(B, T, 2, 12, n, n),
            f(B, T - 1, 2, 12, n, n))


def _assert_close_per_tensor(got: dict, want: dict):
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= TOL * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_swin_hpx_rollout_and_grads_match_jax(route):
    """nside 4: the 12 x 16 rectangle of faces, one global window of N 192
    (flash) or 12 windows of 4 x 4 (token-major), shifted on the second
    block; three closed-loop steps, batch 2."""
    jkw, tkw = ROUTES[route]
    const, pres, prog, target = _batch(11)
    jmodel = jswin.SwinTransformerHPX(**SMALL, **jkw)
    params = jmodel.init(jax.random.PRNGKey(4), const, pres, prog)

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, j_out), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    tmodel = tswin.SwinTransformerHPX(**SMALL, **tkw)
    assert tmodel.mesh == "healpix"
    wins = [(st["H"], st["W"], st["wh"], st["ww"]) for st in tmodel.plan]
    assert wins == ([(12, 16, 12, 16)] if route == "flash" else [(12, 16, 4, 4)])
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    assert out.shape == j_out.shape == (2, 3, 2, 12, 4, 4)
    _assert_close_per_tensor({"out": out.detach().numpy()}, {"out": j_out})
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = weights.flatten_tree(weights.to_flax_tree(
        tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))
    _assert_close_per_tensor(got, weights.flatten_tree(_np_tree(j_grads["params"])))


def test_swin_hpx_zero_pads_where_lat_lon_wraps():
    """A stage whose rectangle is no window multiple: JAX's SwinBlock pads
    with zeros on the right off the lat-lon grid (circularly on it).  nside
    3 gives a 9 x 12 rectangle, padded to 10 x 15 by (5, 5) windows."""
    kw = dict(SMALL, img_height=3, img_width=3, window_size=(5, 5), use_flash_attention=False)
    const, pres, prog, _ = _batch(12, T=2, n=3)
    jmodel = jswin.SwinTransformerHPX(**kw)
    params = jmodel.init(jax.random.PRNGKey(5), const, pres, prog)
    want = np.asarray(jmodel.apply(params, const, pres, prog))
    tmodel = tswin.SwinTransformerHPX(**kw)
    assert [(st["Hp"], st["Wp"]) for st in tmodel.plan] == [(10, 15)]
    weights.load_flax_params(tmodel, _np_tree(params))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (const, pres, prog))).numpy()
    _assert_close_per_tensor({"out": got}, {"out": want})


def test_swin_hpx_builds_from_the_shipped_config():
    """`swintransformer.yaml` with `model.type=SwinTransformerHPX
    model.mesh=healpix data=synthetic_hpx8`: the 24 x 32 rectangle, global
    windows N 768 and 192 on the flash route, the JAX model's parameter
    paths and shapes."""
    from dlwpbench_tpu.models import build_model as jbuild
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(os.path.join(REPO, "configs"), overrides=[
        "model=swintransformer", "model.type=SwinTransformerHPX", "model.mesh=healpix",
        "data=synthetic_hpx8"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert isinstance(tmodel, tswin.SwinTransformerHPX) and tmodel.mesh == "healpix"
    assert [(st["wh"] * st["ww"], tmodel.embed_dim * 2**i // tmodel.num_heads[i])
            for i, st in enumerate(tmodel.plan)] == [(768, 24), (192, 48)]
    rng = np.random.default_rng(13)
    const, pres, prog = (rng.standard_normal((1, t, c, 12, 8, 8)).astype(np.float32)
                         for t, c in ((1, 4), (2, 1), (2, 3)))
    # traced, not run, on the einsum route (the parameters are the flash
    # route's): shapes only
    jparams = jax.eval_shape(jbuild({**cfg.model, "use_flash_attention": False}).init,
                             jax.random.PRNGKey(0), const, pres, prog)
    jshapes = {k: v.shape for k, v in weights.flatten_tree(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, a.dtype), jparams["params"])).items()}
    tshapes = {k: v.shape for k, v in weights.flatten_tree(weights.to_flax_tree(tmodel)).items()}
    assert tshapes == jshapes


def test_other_meshes_still_raise():
    with pytest.raises(NotImplementedError, match="'icosahedral'"):
        tswin.SwinTransformer(**SMALL, mesh="icosahedral")
