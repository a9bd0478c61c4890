"""The port's ring attention over 4 gloo ranks against the JAX package's
(`tests/test_parallel.py::TestRingAttention`), on the CPU.

One module-scoped spawn of 4 ranks (`tests/_torch_dist_child.py`, suite
"ring") runs every check; the cases below read its results, each rank's.
The JAX references run in this process on its 8 virtual devices: its
`ring_attention_sharded` on a 4-device mesh and `reference_attention`.
The port's ring runs `flash_window_attention_lse`'s plain version on CPU
tensors (the kernels' own tests hold those against the card).

Tolerances, fp32: the outputs within 2e-4 (rtol and atol, as JAX holds
its ring against its reference); the gradients of q, k, v and the bias
within 2e-4; the Swin and Pangu rollouts and every parameter gradient
within 1e-4 of each tensor's max (`_graph_parity.MODEL_TOL`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _graph_parity import MODEL_TOL, assert_grads_close, np_tree, perturbed
from _torch_dist_child import start_ranks
from dlwpbench_tpu.models import pangu as jpangu
from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu.ops.pallas_attention import reference_attention
from dlwpbench_tpu.parallel.mesh import make_mesh
from dlwpbench_tpu.parallel.ring_attention import ring_attention_sharded
from dlwpbench_tpu_torch import weights

RANKS = 4
TOL = dict(rtol=2e-4, atol=2e-4)
SWIN_KW = dict(img_height=16, img_width=32, patch_size=1, constant_channels=0,
               prescribed_channels=0, prognostic_channels=2, embed_dim=16, depths=(2,),
               num_heads=(2,), context_size=1)
PANGU_KW = dict(constant_channels=0, prescribed_channels=0, prognostic_channels=2,
                embed_dim=32, num_heads=(2, 4, 4, 2), window_size=(2, 6, 12),
                patch_size=(1, 1), n_lat=12, n_lon=24, context_size=1)


def _operands(B=2, H=2, N=256, D=16, G=1, seed=5):
    """`tests/test_parallel.py:798-806`."""
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3))
    return q, k, v, (0.1 * r.standard_normal((G, H, N, N))).astype(np.float32)


def _weights(jmodel, prog, seed):
    """Perturbed JAX weights (all gradients nonzero)."""
    return perturbed(np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), None, None, prog)), seed)


def _model_ref(jmodel, params, prog):
    """The rollout and the flax-path gradients of mean(out^2)."""
    def loss(p):
        out = jmodel.apply(p, None, None, prog)
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), weights.flatten_tree(np_tree(grads["params"]))


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """(inputs, JAX references, each rank's results): the ranks run while
    this process computes the references."""
    grouped = _operands(B=4, G=2, seed=7)
    grouped[3][:, :, :100, 150:] -= 100.0
    inp = {"plain": _operands(), "grouped": grouped, "2d": _operands(H=4),
           "grads": _operands(N=128, seed=9), "swin_kw": SWIN_KW, "pangu_kw": PANGU_KW,
           "swin_prog": np.random.default_rng(3).standard_normal(
               (1, 3, 2, 16, 32)).astype(np.float32),
           "pangu_prog": np.random.default_rng(4).standard_normal(
               (1, 2, 2, 12, 24)).astype(np.float32)}
    jswin_model = jswin.SwinTransformer(**SWIN_KW)
    # the single-device Pangu on its einsum route: one parameter tree for
    # every route
    jpangu_model = jpangu.PanguWeather(**PANGU_KW, use_flash_attention=False)
    swin_w = _weights(jswin_model, inp["swin_prog"], 1)
    pangu_w = _weights(jpangu_model, inp["pangu_prog"], 2)
    inp["swin_params"] = weights.flatten_tree(swin_w["params"])
    inp["pangu_params"] = weights.flatten_tree(pangu_w["params"])
    results = start_ranks("ring", RANKS, str(tmp_path_factory.mktemp("ring")), inp)

    ref = {}
    mesh = make_mesh(RANKS, data=1, x=RANKS)
    for name in ("plain", "grouped"):
        j = tuple(map(jnp.asarray, inp[name]))
        ref[name] = (np.asarray(ring_attention_sharded(*j, mesh, axis="x")),
                     np.asarray(reference_attention(*j, j[0].shape[-1] ** -0.5)))
    mesh2d = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "h"))
    j = tuple(map(jnp.asarray, inp["2d"]))
    ref["2d"] = (np.asarray(ring_attention_sharded(*j, mesh2d, axis="x", head_axis="h")),
                 np.asarray(reference_attention(*j, j[0].shape[-1] ** -0.5)))
    w = jnp.cos(jnp.arange(16, dtype=jnp.float32))
    ref["grads"] = [np.asarray(g) for g in jax.grad(
        lambda q, k, v, b: (reference_attention(q, k, v, b, 16 ** -0.5) * w).sum(),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, inp["grads"]))]
    ref["swin"] = _model_ref(jswin_model, swin_w, inp["swin_prog"])
    ref["pangu"] = _model_ref(jpangu_model, pangu_w, inp["pangu_prog"])
    return inp, ref, results()


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("case", ["plain", "grouped", "2d"])
def test_ring_matches_jax_ring_and_reference(ring, case, rank):
    """The plain bias, the grouped bias with -100 mask regions straddling
    the chunks, and the 2D sequence x head split (a 2 x 2 mesh; JAX's 4 x
    2): the whole output on every rank."""
    _, ref, results = ring
    got = results[rank][case]
    jring, jref = ref[case]
    np.testing.assert_allclose(got, jref, **TOL)
    np.testing.assert_allclose(got, jring, **TOL)


@pytest.mark.parametrize("rank", range(RANKS))
def test_local_ring_on_sharded_operands(ring, rank):
    """`shard_ring_operands` + `ring_window_attention` on this rank's
    chunks: its rows of the single-device output."""
    _, ref, results = ring
    m = 256 // RANKS
    np.testing.assert_allclose(results[rank]["local"], ref["plain"][1][:, :, rank * m:(rank + 1) * m],
                               **TOL)


@pytest.mark.parametrize("rank", range(RANKS))
def test_ring_gradients_match_jax(ring, rank):
    """d(q, k, v, bias) through the rotation's reverse exchange, the lse
    cotangent of the flash backward and the scatter/gather regions, on
    every rank, against JAX's single-device gradients."""
    _, ref, results = ring
    for name, got, want in zip("qkvb", results[rank]["grads"], ref["grads"]):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("model", ["swin", "pangu"])
def test_models_with_ring_match_jax_single_device(ring, model, rank):
    """`spmd_mesh` on the Swin (global windows, N 512 over 4 ranks) and on
    Pangu's flash route (N 144, the grouped bias with the shift mask):
    rollout and every parameter gradient on every rank equal JAX's
    single-device model."""
    _, ref, results = ring
    out, grads = results[rank][model]
    j_out, j_grads = ref[model]
    assert out.shape == j_out.shape
    assert_grads_close({"out": out}, {"out": j_out}, MODEL_TOL)
    assert_grads_close(grads, j_grads, MODEL_TOL)
