"""The port's distributed spectral transforms and layers
(`dlwpbench_tpu_torch/parallel/{fft,sht_dist,spectral_dist}.py`, the
`spmd_mesh` branches of `AFNO2DFilter`, `SphericalConv`, `SFNO2DModule`
and `FourCastNet`) against the JAX package's on the CPU.

One module-scoped spawn of 4 gloo ranks (suite "spectral" of
`tests/_torch_dist_child.py`) runs every case; the JAX references are
computed in this process meanwhile, on 4 of the 8 virtual CPU devices
("x"), and on a (2, 2) ("x", "c") mesh for the 2D schedule.  Each case
mirrors one of `tests/test_parallel.py`: `TestDistFFT` (`:55`),
`TestDistSHT` (`:91`), `TestDistSHTPipelined` (`:117`),
`TestDistributedGradients::test_dist_sht_gradient_matches_single_device`
(`:293`) and `TestDistributedSpectralLayers` (`:375-706`).  Each holds the
port's result against JAX's distributed function, and against the port's
single-device layer where JAX's test holds JAX's against its own.

The same ranks run the analysis entries' audits: the port's byte tally
of the distributed spherical conv's forward and backward
(`collective_microbench.byte_audit`) equals, as an integer, the
all-to-all bytes of JAX's per-device HLO of the same program
(`scripts/collective_microbench.py::hlo_collective_bytes`), and the
schedule audit's ring (`schedule_audit.audit`) shows P - 1 exchanges,
each with a compute launch in its window.

Tolerances: fp32 within 1e-4 of each tensor's max (ROADMAP's parity
harness), outputs and gradients, the weight gradients summed over the
ranks (each rank holds its rows' share); bf16 exchanges within 1e-2 of
max against JAX's bf16-exchange result (a coefficient whose fp32 value
lies at a bf16 rounding boundary rounds one ulp apart, 2^-8 of it) and
within 3e-2 against fp32 (JAX's bound).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _graph_parity import MODEL_TOL, assert_grads_close, np_tree, perturbed
from _torch_dist_child import start_ranks
from dlwpbench_tpu.models.fourcastnet import FourCastNet as JFourCastNet
from dlwpbench_tpu.models.sfno import SFNO2DModule as JSFNO
from dlwpbench_tpu.ops.sht import isht as jisht
from dlwpbench_tpu.ops.sht import sht as jsht
from dlwpbench_tpu.ops.sht import sht_tables as jsht_tables
from dlwpbench_tpu.ops.spectral import AFNO2DFilter as JAFNO
from dlwpbench_tpu.parallel.fft import make_dist_rfft2
from dlwpbench_tpu.parallel.mesh import make_mesh
from dlwpbench_tpu.parallel.sht_dist import dist_sht, make_dist_sht
from dlwpbench_tpu.parallel.spectral_dist import (
    make_dist_afno_filter,
    make_dist_sfno_blocks,
    make_dist_sfno_blocks_2d,
    make_dist_spherical_conv,
)
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import fourcastnet as tfcn
from dlwpbench_tpu_torch.models import sfno as tsfno

RANKS = 4
TOL = MODEL_TOL
BF16_TOL, BF16_VS_FP32_TOL = 1e-2, 3e-2
LR = 1e-3
SFNO_KW = dict(constant_channels=0, prescribed_channels=0, prognostic_channels=2,
               num_layers=1, embed_dim=8, context_size=1, height=16, width=32)
FUSED_KW = dict(SFNO_KW, num_layers=2, dist_schedule="fused")
FCN_KW = dict(img_height=16, img_width=24, constant_channels=0, prescribed_channels=0,
              prognostic_channels=2, embed_dim=8, depth=1, num_blocks=4, context_size=1)
FCN2_KW = dict(FCN_KW, img_width=32, filter="SFNO")
# the byte audit's (channels, nlat, nlon): a small field and the
# microbench's default
BYTE_SHAPES = [(16, 16, 32), (256, 32, 64)]


def close(got, want, tol=TOL):
    """max|got - want| within tol x max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, (err, scale, tol)


def _mesh():
    return make_mesh(RANKS, data=1, x=RANKS)


def _mesh_xc():
    return Mesh(np.array(jax.devices()[:RANKS]).reshape(2, 2), ("x", "c"))


def _put(x, spec, mesh=None):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh or _mesh(), spec))


def _inputs():
    rng = lambda s: np.random.default_rng(s)  # noqa: E731
    f32 = lambda s, *shape: rng(s).standard_normal(shape).astype(np.float32)  # noqa: E731
    lmax = jsht_tables(16, 32).lmax
    inp = {"fft_x": f32(1, 16, 24), "fft_xb": f32(2, 3, 8, 16), "sht_x": f32(3, 16, 32),
           "sht_xc": f32(7, 2, 5, 16, 32), "sht_xg": f32(5, 16, 32)}
    r = rng(11)
    inp["conv"] = dict(x=r.standard_normal((2, 3, 16, 32)).astype(np.float32),
                       w=r.standard_normal((3, 5, lmax, 2)).astype(np.float32), chunks=1)
    r = rng(13)
    inp["conv_piped"] = dict(x=r.standard_normal((2, 6, 16, 32)).astype(np.float32),
                             w=r.standard_normal((6, 4, lmax, 2)).astype(np.float32), chunks=3)
    x = f32(12, 2, 16, 24, 8)
    p = np_tree(jax.jit(JAFNO(hidden_size=8, num_blocks=4, hard_thresholding_fraction=0.7).init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    inp["afno"] = dict(x=x, params=p, **p)
    r = rng(21)
    C, HD = 6, 12
    layers = [{k: (0.3 * r.standard_normal(s)).astype(np.float32) for k, s in (
        ("spec", (C, C, lmax, 2)), ("skip_k", (C, C)), ("skip_b", (C,)), ("mlp1_k", (C, HD)),
        ("mlp1_b", (HD,)), ("mlp2_k", (HD, C)), ("mlp2_b", (C,)))} for _ in range(2)]
    inp["fused"] = dict(x=r.standard_normal((2, 16, 32, C)).astype(np.float32), layers=layers)
    for key, cls, kw, seed, grid in (
            ("sfno", JSFNO, SFNO_KW, 9, (16, 32)),
            ("sfno_fused_4", JSFNO, dict(FUSED_KW, dist_pipeline_chunks=4), 5, (16, 32)),
            ("fourcastnet", JFourCastNet, FCN_KW, 10, (16, 24)),
            ("fourcastnetv2", JFourCastNet, FCN2_KW, 14, (16, 32))):
        prog = f32(seed, 2, 3, 2, *grid)
        jkw = dict(kw, spmd_mesh=_mesh()) if key == "sfno_fused_4" else kw
        params = perturbed(np_tree(jax.jit(cls(**jkw).init)(jax.random.PRNGKey(0), None, None,
                                                            prog)), 3)
        inp[key] = dict(kw=kw, params=weights.flatten_tree(params["params"]), prog=prog,
                        jparams=params)
    inp["byte_shapes"] = BYTE_SHAPES
    r = rng(23)  # the schedule audit's ring geometry: B 2, H 4, N 512, D 32, one bias group
    inp["ring_audit"] = [r.standard_normal(s).astype(np.float32)
                         for s in ((2, 4, 512, 32),) * 3 + ((1, 4, 512, 512),)]
    inp["sfno_fused_1"] = dict(inp["sfno_fused_4"],
                               kw=dict(FUSED_KW, dist_pipeline_chunks=1))
    inp["sfno"].update(target=f32(15, 2, 2, 2, 16, 32), lr=LR)
    return inp


def _sht_refs(inp):
    ref, mesh = {}, _mesh()
    for grid in ("legendre-gauss", "equiangular"):
        t = jsht_tables(16, 32, grid=grid)
        fwd, inv = make_dist_sht(mesh, t, ndim=2)
        a = jax.jit(fwd)(_put(inp["sht_x"], P("x", None)))
        ref[f"sht_{grid}"] = (np.asarray(a), np.asarray(jax.jit(inv)(_put(a, P(None, "x")))),
                              np.asarray(jsht(jnp.asarray(inp["sht_x"]), t)))
    t = jsht_tables(16, 32)
    for k, cd in ((1, None), (2, None), (3, None), (8, None), (2, jnp.bfloat16)):
        fwd, inv = make_dist_sht(mesh, t, ndim=4, pipeline_chunks=k, comm_dtype=cd)
        a = jax.jit(fwd)(_put(inp["sht_xc"], P(None, None, "x", None)))
        f = jax.jit(inv)(_put(a, P(None, None, None, "x")))
        ref[f"sht_chunks_{k}_{'bf16' if cd else 'fp32'}"] = (np.asarray(a), np.asarray(f))
    a_ref = jsht(jnp.asarray(inp["sht_xc"]), t)
    ref["sht_single"] = (np.asarray(a_ref), np.asarray(jisht(a_ref, t)))

    def grad(x, spec, k):
        def local(al):
            c = dist_sht(al, t, "x", pipeline_chunks=k)
            return jax.lax.psum(jnp.sum(jnp.abs(c) ** 2), "x")

        g = jax.grad(shard_map(local, mesh=mesh, in_specs=spec, out_specs=P()))
        return np.asarray(jax.jit(g)(_put(x, spec)))

    ref["sht_grad"] = grad(inp["sht_xg"], P("x", None), 1)
    ref["sht_grad_single"] = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.abs(jsht(a, t)) ** 2))(jnp.asarray(inp["sht_xg"])))
    for k in (1, 3):
        ref[f"sht_grad_c{k}"] = grad(inp["sht_xc"], P(None, None, "x", None), k)
    return ref


def _layer_refs(inp):
    ref, mesh, t = {}, _mesh(), jsht_tables(16, 32)
    for key in ("conv", "conv_piped"):
        c = inp[key]
        conv = make_dist_spherical_conv(mesh, t, ndim=4, pipeline_chunks=c["chunks"])
        xs = _put(c["x"], P(None, None, "x", None))

        def loss(w, conv=conv, xs=xs):
            return jnp.sum(conv(xs, w[..., 0] + 1j * w[..., 1]) ** 2)

        w = jnp.asarray(c["w"])
        ref[key] = (np.asarray(jax.jit(lambda w, conv=conv, xs=xs: conv(
            xs, w[..., 0] + 1j * w[..., 1]))(w)), np.asarray(jax.jit(jax.grad(loss))(w)))
        wc = w[..., 0] + 1j * w[..., 1]
        x = jnp.asarray(c["x"])
        ref[f"{key}_single"] = np.asarray(
            jisht(jnp.einsum("bilm,iol->bolm", jsht(x, t), wc), t))

    a = inp["afno"]
    xs = _put(a["x"], P(None, "x", None, None))
    f = make_dist_afno_filter(mesh, ndim=4, hard_thresholding_fraction=0.7)
    w = [jnp.asarray(a[n]) for n in ("w1", "b1", "w2", "b2")]
    ref["afno_fn"] = np.asarray(jax.jit(f)(xs, *w))
    single = JAFNO(hidden_size=8, num_blocks=4, hard_thresholding_fraction=0.7)
    ref["afno_single"] = np.asarray(single.apply({"params": a["params"]}, jnp.asarray(a["x"])))
    layer = JAFNO(hidden_size=8, num_blocks=4, hard_thresholding_fraction=0.7, spmd_mesh=mesh)
    fn = jax.jit(jax.value_and_grad(lambda p: jnp.sum(layer.apply({"params": p}, xs) ** 2)))
    ref["afno_layer"] = (np.asarray(jax.jit(lambda p: layer.apply({"params": p}, xs))(
        a["params"])), np_tree(fn(a["params"])[1]))

    fz = inp["fused"]
    layers = jax.tree_util.tree_map(jnp.asarray, fz["layers"])
    xs = _put(fz["x"], P(None, "x", None, None))
    for k in (1, 3, 6):
        ref[f"fused_{k}"] = np.asarray(jax.jit(make_dist_sfno_blocks(
            mesh, t, pipeline_chunks=k))(xs, layers))
    ref["fused_bf16"] = np.asarray(jax.jit(make_dist_sfno_blocks(
        mesh, t, pipeline_chunks=3, comm_dtype=jnp.bfloat16))(xs, layers))
    m2 = _mesh_xc()
    xs2 = _put(fz["x"], P(None, "x", None, "c"), m2)
    for k in (1, 3):
        ref[f"fused2d_{k}"] = np.asarray(jax.jit(make_dist_sfno_blocks_2d(
            m2, t, pipeline_chunks=k))(xs2, layers))
    for key, fn, x in (("fused_grad", make_dist_sfno_blocks(mesh, t, pipeline_chunks=3), xs),
                       ("fused2d_grad", make_dist_sfno_blocks_2d(m2, t, pipeline_chunks=3),
                        xs2)):
        g = jax.jit(jax.grad(lambda a, ls, fn=fn: jnp.sum(fn(a, ls) ** 2), (0, 1)))(
            x, layers[:1])
        ref[key] = (np.asarray(g[0]), np_tree(g[1][0]))
    return ref


def _model_refs(inp):
    ref, mesh = {}, _mesh()
    for key, cls in (("sfno", JSFNO), ("sfno_fused_4", JSFNO), ("sfno_fused_1", JSFNO),
                     ("fourcastnet", JFourCastNet), ("fourcastnetv2", JFourCastNet)):
        m = inp[key]
        model = cls(**m["kw"], spmd_mesh=mesh)
        ps = _put(m["prog"], P(None, None, None, "x", None))

        def loss(p, model=model, ps=ps):
            out = model.apply(p, None, None, ps)
            return jnp.mean(out ** 2), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(m["jparams"])
        ref[key] = (np.asarray(out), weights.flatten_tree(np_tree(grads["params"])))
    return ref


def _byte_refs():
    """JAX's per-device HLO collective bytes of the distributed spherical
    conv's forward and backward (the gradient of sum(conv(x, w)^2) with
    respect to x, as the microbench compiles it) at each byte shape."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    from collective_microbench import hlo_collective_bytes

    ref, mesh = {}, _mesh()
    for C, nlat, nlon in BYTE_SHAPES:
        t = jsht_tables(nlat, nlon, grid="equiangular")
        x = jax.ShapeDtypeStruct((1, C, nlat, nlon), jnp.float32,
                                 sharding=NamedSharding(mesh, P(None, None, "x", None)))
        w = jax.ShapeDtypeStruct((C, C, t.lmax), jnp.complex64)
        conv = make_dist_spherical_conv(mesh, t, ndim=4)
        hlo = jax.jit(jax.grad(lambda a, wc, conv=conv: jnp.sum(conv(a, wc) ** 2))).lower(
            x, w).compile().as_text()
        ref[(C, nlat, nlon)] = hlo_collective_bytes(hlo)
    return {"bytes": ref}


@pytest.fixture(scope="module")
def spectral_suite(tmp_path_factory):
    """(inputs, JAX references, each rank's results) of the "spectral"
    suite."""
    inp = _inputs()
    sent = {k: ({kk: vv for kk, vv in v.items() if kk != "jparams"} if isinstance(v, dict)
                else v) for k, v in inp.items()}
    results = start_ranks("spectral", RANKS, str(tmp_path_factory.mktemp("spectral")), sent)
    ref = {**_sht_refs(inp), **_layer_refs(inp), **_model_refs(inp), **_byte_refs()}
    return inp, ref, results()


# ---------------------------------------------------------------------------
# TestDistFFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(RANKS))
def test_rfft2_matches_jax_and_round_trips(spectral_suite, rank):
    """The padded spectrum (Wf 13 -> 16 on 4 ranks) against JAX's and
    numpy's rfft2, and the round trip."""
    inp, _, results = spectral_suite
    X, back = results[rank]["fft"]
    x = inp["fft_x"]
    want = np.fft.fft(np.fft.rfft(x, axis=-1), axis=-2)
    fwd, inv = make_dist_rfft2(_mesh(), ndim=2)
    jX = jax.jit(fwd)(_put(x, P("x", None)))
    assert X.shape == (16, 16)
    close(X, np.asarray(jX))
    close(X[:, :13], want)
    assert np.abs(X[:, 13:]).max() == 0.0
    close(back, x, 1e-5)
    close(back, np.asarray(jax.jit(lambda a: inv(a, 24))(jX)))


def test_rfft2_batched_round_trip(spectral_suite):
    inp, _, results = spectral_suite
    close(results[0]["fft_batched"], inp["fft_xb"], 1e-5)


# ---------------------------------------------------------------------------
# TestDistSHT, TestDistSHTPipelined, the SHT's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular"])
def test_dist_sht_matches_jax(spectral_suite, grid):
    """The m-sharded coefficients (mmax 16, padded to 16) and the inverse
    against JAX's distributed SHT and its single-device one."""
    _, ref, results = spectral_suite
    a, f = results[0][f"sht_{grid}"]
    ja, jf, single = ref[f"sht_{grid}"]
    close(a, ja)
    close(a[:, : single.shape[-1]], single)
    close(f, jf)


@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_pipelined_sht_matches_jax_and_plain(spectral_suite, chunks):
    """Uneven chunk splits (C=5) included: the chunked transforms equal
    JAX's chunked ones and the plain schedule."""
    _, ref, results = spectral_suite
    a, f = results[0][f"sht_chunks_{chunks}_fp32"]
    close(a, ref[f"sht_chunks_{chunks}_fp32"][0])
    close(f, ref[f"sht_chunks_{chunks}_fp32"][1])
    plain = results[0]["sht_chunks_1_fp32"]
    close(a, plain[0], 1e-6)
    close(f, plain[1], 1e-6)
    close(a[..., :16], ref["sht_single"][0])
    close(f, ref["sht_single"][1])


def test_bf16_comm_sht_within_tolerance(spectral_suite):
    """bf16 exchange payloads: within 1e-2 of max of JAX's bf16 exchanges,
    within 3e-2 of the fp32 transform (both ways)."""
    _, ref, results = spectral_suite
    a, f = results[0]["sht_chunks_2_bf16"]
    ja, jf = ref["sht_chunks_2_bf16"]
    close(a, ja, BF16_TOL)
    close(f, jf, BF16_TOL)
    close(a, ref["sht_chunks_1_fp32"][0], BF16_VS_FP32_TOL)
    close(f, ref["sht_chunks_1_fp32"][1], BF16_VS_FP32_TOL)


@pytest.mark.parametrize("rank", range(RANKS))
def test_dist_sht_gradient_matches_jax(spectral_suite, rank):
    """d sum|SHT(x)|^2 / dx through the exchanges, on every rank, against
    JAX's distributed and single-device gradients."""
    _, ref, results = spectral_suite
    g = results[rank]["sht_grad"]
    close(g, ref["sht_grad"])
    close(g, ref["sht_grad_single"])


@pytest.mark.parametrize("chunks", [1, 3])
def test_pipelined_sht_gradient_matches_jax(spectral_suite, chunks):
    _, ref, results = spectral_suite
    close(results[0][f"sht_grad_c{chunks}"], ref[f"sht_grad_c{chunks}"])
    close(results[0]["sht_grad_c3"], results[0]["sht_grad_c1"], 1e-5)


# ---------------------------------------------------------------------------
# TestDistributedSpectralLayers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["conv", "conv_piped"])
def test_dist_spherical_conv_matches_jax(spectral_suite, key):
    """The mixing layer, plain (Cin 3, Cout 5) and pipelined (3 chunks of
    6): output against JAX's distributed and single-device layers, the
    weight's gradient (summed over the ranks) against JAX's."""
    _, ref, results = spectral_suite
    y, gw = results[0][key]
    close(y, ref[key][0])
    close(y, ref[f"{key}_single"])
    close(gw, ref[key][1])


@pytest.mark.parametrize("rank", range(RANKS))
def test_dist_afno_filter_matches_jax(spectral_suite, rank):
    """The function against JAX's and against the single-device filter
    minus its residual (kept band 0.7, softshrink at its scale)."""
    inp, ref, results = spectral_suite
    close(results[rank]["afno_fn"], ref["afno_fn"])
    close(results[rank]["afno_fn"], ref["afno_single"] - inp["afno"]["x"])


def test_afno_layer_with_mesh_matches_jax(spectral_suite):
    """`AFNO2DFilter(spmd_mesh=...)`: the output with its residual and the
    summed weight gradients against JAX's layer on the mesh."""
    _, ref, results = spectral_suite
    y, grads = results[0]["afno_layer"]
    close(y, ref["afno_layer"][0])
    assert_grads_close(grads, ref["afno_layer"][1])


@pytest.mark.parametrize("K", [1, 3, 6])
def test_fused_sfno_blocks_match_jax(spectral_suite, K):
    """The fused stack for any chunk count (C=6: K=3 even, K=6 one channel
    each, K=1 no chunks) against JAX's, and K against K=1."""
    _, ref, results = spectral_suite
    close(results[0][f"fused_{K}"], ref[f"fused_{K}"])
    close(results[0][f"fused_{K}"], ref["fused_1"])


def test_fused_sfno_blocks_gradients_match_jax(spectral_suite):
    """Input and parameter gradients of the fused stack (1 block, K=3)."""
    _, ref, results = spectral_suite
    gx, gp = results[0]["fused_grad"]
    close(gx, ref["fused_grad"][0])
    assert_grads_close(gp, ref["fused_grad"][1])


def test_fused_sfno_blocks_bf16_comm(spectral_suite):
    _, ref, results = spectral_suite
    close(results[0]["fused_bf16"], ref["fused_bf16"], BF16_TOL)
    close(results[0]["fused_bf16"], ref["fused_3"], BF16_VS_FP32_TOL)


@pytest.mark.parametrize("K", [1, 3])
def test_fused_2d_matches_jax(spectral_suite, K):
    """The (latitude x channel) schedule on a 2 x 2 mesh: JAX's on its 2 x 2
    mesh, and the 1D schedule."""
    _, ref, results = spectral_suite
    close(results[0][f"fused2d_{K}"], ref[f"fused2d_{K}"])
    close(results[0][f"fused2d_{K}"], ref["fused_1"])


@pytest.mark.parametrize("rank", range(RANKS))
def test_fused_2d_gradients_match_jax(spectral_suite, rank):
    """Through the reduce-scatters: input and parameter gradients, the
    parameters' summed over the whole 2 x 2 mesh."""
    _, ref, results = spectral_suite
    gx, gp = results[rank]["fused2d_grad"]
    close(gx, ref["fused2d_grad"][0])
    assert_grads_close(gp, ref["fused2d_grad"][1])


def _check_model(got, want, tol=TOL):
    close(got[0], want[0], tol)
    assert_grads_close(got[1], want[1], tol)


@pytest.mark.parametrize("rank", range(RANKS))
def test_sfno_per_conv_with_mesh_matches_jax(spectral_suite, rank):
    """SFNO with `spmd_mesh` (per-conv schedule): rollout and every
    parameter gradient against JAX's on the mesh and the port's
    single-device model on the same weights."""
    inp, ref, results = spectral_suite
    _check_model(results[rank]["sfno"], ref["sfno"])
    m = inp["sfno"]
    single = tsfno.SFNO2DModule(**m["kw"])
    weights.load_flax_params(single, weights.unflatten_tree(m["params"]))
    out = single(None, None, torch.from_numpy(m["prog"]))
    (out ** 2).mean().backward()
    grads = weights.flatten_tree(weights.to_flax_tree(
        single, {n: p.grad for n, p in single.named_parameters()}))
    _check_model(results[rank]["sfno"], (out.detach().numpy(), grads))


@pytest.mark.parametrize("chunks", [4, 1])
def test_sfno_fused_with_mesh_matches_jax(spectral_suite, chunks):
    """The fused schedule's model on JAX's fused tree (`blocks_{i}_*` on
    the root, loaded by `load_flax_params`): rollout and gradients against
    JAX's, 4 chunks against 1."""
    _, ref, results = spectral_suite
    _check_model(results[0][f"sfno_fused_{chunks}"], ref[f"sfno_fused_{chunks}"])
    close(results[0]["sfno_fused_4"][0], results[0]["sfno_fused_1"][0])


def test_sfno_fused_tree_round_trips(spectral_suite):
    """`to_flax_tree` gives JAX's fused tree back, leaf for leaf."""
    inp, _, results = spectral_suite
    got, want = results[0]["fused_tree"], inp["sfno_fused_4"]["params"]
    assert got.keys() == want.keys()
    assert "blocks_0_spec" in got and "Dense_3/kernel" in got
    assert not any(k.startswith("SphericalConv") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("key", ["fourcastnet", "fourcastnetv2"])
def test_fourcastnet_with_mesh_matches_jax(spectral_suite, key):
    """FourCastNet (AFNO2D) and FourCastNetv2 (SFNO) with `spmd_mesh`: rollout
    and gradients against JAX's on the mesh and the port's single-device
    model."""
    inp, ref, results = spectral_suite
    _check_model(results[0][key], ref[key])
    m = inp[key]
    single = tfcn.FourCastNet(**m["kw"])
    weights.load_flax_params(single, weights.unflatten_tree(m["params"]))
    out = single(None, None, torch.from_numpy(m["prog"])).detach().numpy()
    close(results[0][key][0], out)


@pytest.mark.parametrize("rank", range(RANKS))
def test_trainer_step_of_meshed_sfno_matches_single(spectral_suite, rank):
    """A trainer step of the SFNO with `spmd_mesh`, whose gradients the
    trainer sums over `partition_group` in one flat all-reduce, against
    the single-device step on the same batch: the loss within 1e-5, every
    gradient within 1e-4 of its max, every parameter within lr / 100 (each
    moves by about lr)."""
    res = spectral_suite[2][rank]
    loss, grads, params = res["sfno_step_part"]
    loss1, grads1, params1 = res["sfno_step_single"]
    assert loss == pytest.approx(loss1, rel=1e-5)
    assert_grads_close(grads, grads1)
    for k, v in params1.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=LR / 100, err_msg=k)


@pytest.mark.parametrize("name", ["sht_rows", "fourcastnet_rows", "sfno_rows"])
def test_rows_that_do_not_split_raise(spectral_suite, name):
    """6 latitude (or token) rows on 4 ranks: ValueError."""
    msg = spectral_suite[2][0]["raises"][name]
    assert msg is not None and "split" in msg


# ---------------------------------------------------------------------------
# the analysis entries' audits on these ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", BYTE_SHAPES, ids=lambda s: "C{}-{}x{}".format(*s))
def test_conv_all_to_all_bytes_equal_jax_hlo(spectral_suite, shape):
    """The port's tallied all-to-all bytes of the conv's forward and
    backward equal JAX's HLO bytes on every rank, exactly, and the
    model's claim 4 C nlat m_pad 8 / P (four transposes of the complex
    spectrum, no other all-to-all)."""
    _, ref, results = spectral_suite
    want = ref["bytes"][shape]
    assert set(want) == {"all-to-all"}
    for r in range(RANKS):
        got = results[r]["bytes"][shape]
        assert got["all_to_all_bytes_per_device"] == want["all-to-all"], (r, got, want)
        assert got["all_to_all_bytes_per_device"] == got["model_claim_bytes_per_device"]
        assert got["collective_calls_per_device"]["all-to-all"] == 4
        assert got["ratio_vs_model"] == 1.0


@pytest.mark.parametrize("rank", range(RANKS))
def test_ring_audit_windows(spectral_suite, rank):
    """The schedule audit's ring on 4 ranks: P - 1 exchanges, each posted
    before its round's attention launch (one independent launch in every
    window, the next round's launch its descendant; the last round's has
    none), no other collective, and no device time on the CPU."""
    audit = spectral_suite[2][rank]["ring_audit"]
    assert audit["n_collectives"] == RANKS - 1
    assert audit["n_collectives_with_zero_overlap_window"] == 0
    assert audit["n_compute_ops"] == RANKS
    assert [c["name"] for c in audit["collectives"]] == ["collective-permute"] * (RANKS - 1)
    assert all(c["independent_compute_ops"] >= 1 for c in audit["collectives"])
    assert all(c["descendant_compute_ops"] == 1 for c in audit["collectives"])
    assert audit["overlapped_device_us"] is None
    assert audit["attention_launches"]["flash_window_attention"] == 0  # CPU: the plain version
