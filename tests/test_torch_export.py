"""The port's serving artifacts (`utils/export.py`, `python -m
dlwpbench_tpu_torch.export_model`, `python -m dlwpbench_tpu_torch.serve`)
against the JAX package's (`dlwpbench_tpu/utils/export.py`,
`scripts/export_model.py`, `scripts/serve.py`).

The five cases of `tests/test_export.py` in the port, then: the port's
exported rollout against JAX's exported artifact on the same weights
(within 1e-4 of max) for the U-Net, the Swin on the flash operator,
swin_win8 on the token-major operator and Pangu on the 5D operator, each
program traced on the CPU holding the registered attention operator (not
its plain math); a JAX artifact refused by name; `device_constant` still
real and cached after an export.  The JAX side runs its CPU routes (the
flash Pallas kernel in interpret mode for the Swin, einsum for the
others); the port's operators run their plain versions on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.models import pangu as jpangu
from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu.models import unet as junet
from dlwpbench_tpu.utils import export as jexport
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import pangu as tpangu
from dlwpbench_tpu_torch.models import swin as tswin
from dlwpbench_tpu_torch.models import unet as tunet
from dlwpbench_tpu_torch.utils import export as X

TOL = 1e-4  # of max|out|: fp32, two frameworks' summation orders


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, B, T, shapes):
    """const, pres, prog as float32 numpy arrays ([B,1,Cc,H,W], [B,T,Cp,H,W],
    [B,T,Cq,H,W]); a zero channel count gives None."""
    rng = np.random.default_rng(seed)
    (cc, cp, cq), (H, W) = shapes
    out = []
    for lead, c in (((B, 1), cc), ((B, T), cp), ((B, T), cq)):
        out.append(rng.standard_normal((*lead, c, H, W)).astype(np.float32) if c else None)
    return out


def _tensors(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _shape(a):
    return None if a is None else a.shape


# ---------------------------------------------------------------- the JAX cases
def test_rollout_export_matches_eager(tmp_path):
    model = tunet.UNet(constant_channels=2, prescribed_channels=1, prognostic_channels=3,
                       hidden_channels=(4, 8), context_size=1)
    args = _tensors(_arrays(0, 2, 4, ((2, 1, 3), (16, 32))))
    with torch.no_grad():
        want = model.eval()(*args)
    ep = X.export_rollout(model, *map(_shape, args), device="cpu")
    path = str(tmp_path / "unet.pt2")
    X.save_exported(path, ep, meta={"model": {"type": "UNet"}})
    assert os.path.getsize(path) > 0
    run, meta = X.load_exported(path, device="cpu")
    assert meta["model"]["type"] == "UNet" and meta["format"] == X.FORMAT
    assert meta["device"] == "cpu" and meta["out_avals"] == ["torch.float32[2, 3, 3, 16, 32]"]
    torch.testing.assert_close(run(*args), want, rtol=1e-6, atol=1e-6)


def test_export_absent_groups_served_as_none(tmp_path):
    """Artifacts exported with const/pres absent (the navier_stokes shape)
    are called with None in their place."""
    model = tunet.UNet(constant_channels=0, prescribed_channels=0, prognostic_channels=2,
                       hidden_channels=(4, 8), context_size=1)
    _, _, prog = _tensors(_arrays(1, 1, 3, ((0, 0, 2), (16, 32))))
    with torch.no_grad():
        want = model.eval()(None, None, prog)
    path = str(tmp_path / "ns_unet.pt2")
    X.save_exported(path, X.export_rollout(model, None, None, prog.shape, device="cpu"))
    run, _ = X.load_exported(path, device="cpu")
    torch.testing.assert_close(run(None, None, prog), want, rtol=1e-6, atol=1e-6)


def test_bad_magic_rejected(tmp_path):
    p = str(tmp_path / "junk.bin")
    with open(p, "wb") as f:
        f.write(b"NOTANARTIFACT")
    with pytest.raises(ValueError, match="not a dlwpbench_tpu export"):
        X.load_exported(p, device="cpu")


def _train_run(tmp_path):
    from dlwpbench_tpu_torch import train

    run_dir = str(tmp_path / "run")
    train.main(["model=unet", "data=synthetic", "data.height=16", "data.width=32",
                "model.hidden_channels=[4,8]", "training.epochs=1", "training.batch_size=2",
                "training.sequence_length=3", "validation.sequence_length=3",
                f"run_dir={run_dir}", "--device", "cpu"])
    return run_dir


def test_serve_cli_end_to_end(tmp_path):
    """Train (CLI) -> export (CLI) -> serve (CLI): the serving path writes
    the evaluator's forecast files and metrics from the artifact, and its
    forecast equals `evaluate -c`'s on the samples both hold."""
    from dlwpbench_tpu_torch import evaluate, export_model, serve
    from dlwpbench_tpu_torch.utils import netcdf3

    run_dir = _train_run(tmp_path)
    art = str(tmp_path / "unet.pt2")
    export_model.main(["-c", run_dir, "-o", art, "--batch-size", "2", "--sequence-length", "3",
                       "--device", "cpu"])
    out_dir = str(tmp_path / "serving")
    res = serve.main(["-a", art, "-c", run_dir, "--out-dir", out_dir, "--device", "cpu"])
    m = json.load(open(os.path.join(out_dir, "metrics.json")))
    assert "rmse" in m and all(np.isfinite(v).all() for v in m["rmse"].values())
    s = json.load(open(os.path.join(out_dir, "serving.json")))
    assert res["gridpoints_per_s"] == s["gridpoints_per_s"]
    # a batch's points (2 samples x 2 leads x 16 x 32) over a batch's seconds
    assert s["gridpoints_per_s"] == pytest.approx(2 * 2 * 16 * 32 / s["steady_s_per_batch"])
    evaluate.main(["-c", run_dir, "--batch-size", "2", "--sequence-length", "3",
                   "--device", "cpu"])
    served, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    evaluated, _ = netcdf3.read_dataset(os.path.join(run_dir, "evaluation", "outputs.nc"))
    n = served["var0"].shape[0]
    for v in res["variables"]:
        np.testing.assert_allclose(served[v], evaluated[v][:n], rtol=0,
                                   atol=1e-6 * np.abs(evaluated[v]).max())
    # batch-size mismatch is refused (the artifact is shape-locked)
    with pytest.raises(ValueError, match="shape-locked"):
        serve.main(["-a", art, "-c", run_dir, "--out-dir", out_dir, "--batch-size", "5",
                    "--device", "cpu"])


def test_export_from_run_dir_cli(tmp_path):
    """Train one tiny epoch via the CLI, export the run, call the artifact."""
    from dlwpbench_tpu_torch import export_model

    run_dir = _train_run(tmp_path)
    out = str(tmp_path / "unet.pt2")
    export_model.main(["-c", run_dir, "-o", out, "--batch-size", "1", "--sequence-length", "3",
                       "--device", "cpu"])
    run, meta = X.load_exported(out, device="cpu")
    cfg = meta["model"]
    args = [torch.zeros(1, n, cfg[k], 16, 32) for n, k in
            ((1, "constant_channels"), (3, "prescribed_channels"), (3, "prognostic_channels"))]
    out_arr = run(*args)
    assert out_arr.shape[:2] == (1, 2) and torch.isfinite(out_arr).all()
    assert cfg["type"] == "UNet" and meta["shapes"]["prog"] == [1, 3, cfg["prognostic_channels"],
                                                                16, 32]


# ---------------------------------------------------------------- against JAX's artifact
# (JAX model, JAX kwargs, port model, port kwargs, channels, grid, B, T,
#  the registered operator the port's program must hold)
CASES = {
    "unet": (junet.UNet, dict(hidden_channels=(4, 8)), tunet.UNet, dict(hidden_channels=(4, 8)),
             (2, 1, 3), (8, 16), 2, 3,
             None),
    "swin": (jswin.SwinTransformer, dict(use_flash_attention=True), tswin.SwinTransformer,
             dict(use_flash_attention=True), (2, 1, 3), (8, 16), 2, 3,
             "flash_window_attention_fwd"),
    # 16 x 32 in 4 x 4 windows: 32 windows a sample, so stage 0's 64 windows
    # take the token-major route under export whatever the trace's device
    "swin_win8": (jswin.SwinTransformer, dict(window_size=(4, 4)), tswin.SwinTransformer,
                  dict(window_size=(4, 4)), (2, 1, 3), (16, 32), 2, 3,
                  "window_attention_qkv_fwd"),
    "pangu": (jpangu.PanguWeather, dict(num_heads=(1, 2, 2, 1), patch_size=(1, 1)),
              tpangu.PanguWeather, dict(num_heads=(1, 2, 2, 1), patch_size=(1, 1),
                                        use_flash_attention="packed5d"),
              (2, 1, 2), (8, 16), 2, 3, "window_attention_qkv5d_fwd"),
}


def _common(name, channels, grid):
    cc, cp, cq = channels
    H, W = grid
    common = dict(constant_channels=cc, prescribed_channels=cp, prognostic_channels=cq)
    if name.startswith("swin"):
        common.update(img_height=H, img_width=W, embed_dim=16, depths=(2, 2), num_heads=(2, 2))
    elif name == "pangu":
        common.update(embed_dim=16, n_lat=H, n_lon=W)
    return common


def _op_targets(ep):
    return {str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("dlwpbench_torch.")}


@pytest.mark.parametrize("name", list(CASES))
def test_exported_matches_jax_artifact(name, tmp_path):
    jcls, jkw, tcls, tkw, channels, grid, B, T, op = CASES[name]
    common = _common(name, channels, grid)
    arrays = _arrays(len(name), B, T, (channels, grid))
    jmodel = jcls(**common, **jkw)
    variables = jmodel.init(jax.random.PRNGKey(5), *map(jnp.asarray, arrays))
    jpath = str(tmp_path / f"{name}.stablehlo")
    jexport.save_exported(jpath, jexport.export_rollout(
        jmodel, variables["params"], *map(_shape, arrays), platforms=("cpu",)))
    jrun, _ = jexport.load_exported(jpath)
    want = np.asarray(jrun(*map(jnp.asarray, arrays)))

    model = weights.load_flax_params(tcls(**common, **tkw), jax.tree_util.tree_map(
        np.asarray, variables))
    ep = X.export_rollout(model, *map(_shape, arrays), device="cpu")
    ops = _op_targets(ep)
    if op is None:
        assert not ops
    else:
        assert f"dlwpbench_torch.{op}.default" in ops
    path = str(tmp_path / f"{name}.pt2")
    X.save_exported(path, ep)
    run, _ = X.load_exported(path, device="cpu")
    got = run(*arrays).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_jax_artifact_refused(tmp_path):
    model = junet.UNet(constant_channels=0, prescribed_channels=0, prognostic_channels=2,
                       hidden_channels=(4,))
    prog = jnp.zeros((1, 3, 2, 8, 16))
    variables = model.init(jax.random.PRNGKey(0), None, None, prog)
    path = str(tmp_path / "jax.stablehlo")
    jexport.save_exported(path, jexport.export_rollout(model, variables["params"], None, None,
                                                       prog.shape))
    with pytest.raises(ValueError, match="a JAX .StableHLO. artifact of dlwpbench_tpu"):
        X.load_exported(path, device="cpu")


def test_device_constant_stays_real_after_an_export():
    """A table first built under export is not cached as a fake tensor:
    the first eager call after it gets a real tensor, cached after that."""
    from dlwpbench_tpu_torch.utils import device as D

    def table(n):
        return np.arange(n, dtype=np.int64) * 3

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            t = D.device_constant(table, 7, device=x.device)
            seen.append(t)
            return x + t.to(x.dtype)

    torch.export.export(Probe(), (torch.zeros(7),), strict=False)
    assert type(seen[-1]) is not torch.Tensor  # the trace saw a fake tensor
    out = Probe()(torch.zeros(7))
    assert type(seen[-1]) is torch.Tensor
    assert torch.equal(out, torch.arange(7.0) * 3)
    assert D.device_constant(table, 7, device=torch.device("cpu")) is seen[-1]


def test_cpu_export_holds_the_operator_not_its_body():
    """The Swin's flash call is one node of the registered operator; the
    plain version's logsumexp and einsums of the scores do not appear."""
    model = tswin.SwinTransformer(**_common("swin", (2, 1, 3), (8, 16)), use_flash_attention=True)
    arrays = _arrays(3, 2, 3, ((2, 1, 3), (8, 16)))
    ep = X.export_rollout(model, *map(_shape, arrays), device="cpu")
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("dlwpbench_torch.flash_window_attention_fwd.default") == 2 * 4
    assert not any("logsumexp" in t for t in targets)
