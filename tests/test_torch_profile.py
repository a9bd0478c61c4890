"""The port's profile entry (`python -m dlwpbench_tpu_torch.profile_model`)
on the CPU, against JAX's `scripts/profile_model.py` (`tests/test_aux.py:210`
runs that one the same way).

- `profile.json` holds JAX's keys (`steps`, the `StepTimer` percentiles,
  `flops_per_step`, `achieved_tflops`) and the trace file is written;
- the U-Net's `flops_per_step` (an eager `FlopCounterMode` count over the
  whole rollout) against JAX's `compiled.cost_analysis()["flops"]` times
  its `trips` for the same zoo entry: within 1%.  The two count different
  elementwise ops (XLA's cost model counts activations, bias adds and
  pads; torch's counter only products and convolutions), which at this
  U-Net's width are about 0.5% of the convolutions' FLOPs;
- the Swin's count includes its attention: the registered flash operator's
  FLOP formula gives exactly 4 B heads N^2 D per block forward, every
  window of every block of the rollout.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlwpbench_tpu_torch import profile_model


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the suite's workers share the
    cores, and a test's extra threads only wait on the other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_RTOL = 0.01
KEYS = ("steps", "mean_s", "median_s", "p90_s", "total_s", "flops_per_step", "achieved_tflops")


def _jax_flops(model_name, B, T, H, W):
    """JAX's count as `scripts/profile_model.py` takes it: the compiled
    rollout's cost-model FLOPs times the scan's trip count."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from benchmark_models import model_zoo

    model = model_zoo(B, H, W, 4, 1, 8)[model_name]
    r = np.random.default_rng(0)
    const, pres, prog = (jnp.asarray(r.standard_normal(s), jnp.float32)
                         for s in ((B, 1, 4, H, W), (B, T, 1, H, W), (B, T, 8, H, W)))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), const, pres, prog)
    cost = jax.jit(lambda p: model.apply(p, const, pres, prog)).lower(params).compile(
    ).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"]) * (T - model.context_size)


def test_unet_profile_matches_jax_cost_model(tmp_path):
    info = profile_model.main(["--model", "unet", "--batch", "1", "--seq", "4", "--steps",
                               "2", "--out-dir", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "profile.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(info))
    for k in KEYS:
        assert k in saved, k
    assert saved["steps"] == 2 and saved["median_s"] > 0 and saved["flops_per_step"] > 0
    assert saved["achieved_tflops"] > 0 and saved["attention_flops_per_step"] == 0
    assert saved["device"] == "cpu" and "max_memory_allocated_mb" not in saved
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(tmp_path))
    want = _jax_flops("unet", 1, 4, 32, 64)
    ratio = saved["flops_per_step"] / want
    print(f"U-Net FLOPs a step: port {saved['flops_per_step']:.0f}, JAX {want:.0f}, "
          f"ratio {ratio:.5f}")
    assert abs(ratio - 1.0) <= FLOPS_RTOL


def test_swin_count_includes_its_attention(tmp_path):
    """Every block's windows through the flash operator's formula, on a
    16 x 32 grid: 2 rollout steps of global windows, 512 tokens at stage 0
    and 128 at stage 1, head dim 32."""
    info = profile_model.main(["--model", "swin", "--batch", "1", "--seq", "3", "--steps", "1",
                               "--grid", "16x32", "--out-dir", str(tmp_path), "--device",
                               "cpu"])
    model = profile_model.model_zoo(1, 16, 32)["swin"]()
    per_step = sum(
        4 * (st["Hp"] // st["wh"]) * (st["Wp"] // st["ww"]) * (st["wh"] * st["ww"]) ** 2
        * model.embed_dim * 2 ** i * depth
        for i, (st, depth) in enumerate(zip(model.plan, model.depths)))
    assert info["attention_flops_per_step"] == 2 * per_step
    assert info["flops_per_step"] > info["attention_flops_per_step"]


def test_train_step_counts_the_backward(tmp_path):
    """`--train`: the trainer's step (forward, backward, AdamW) counts more
    than the rollout, and both on the same inputs."""
    argv = ["--model", "unet", "--batch", "1", "--seq", "3", "--steps", "1", "--grid", "16x32",
            "--device", "cpu"]
    infer = profile_model.main([*argv, "--out-dir", str(tmp_path / "infer")])
    train = profile_model.main([*argv, "--train", "--out-dir", str(tmp_path / "train")])
    assert train["mode"] == "train" and infer["mode"] == "infer"
    # the backward's products: about twice the forward's, remat a third forward
    assert 2.5 * infer["flops_per_step"] <= train["flops_per_step"] <= 4.5 * infer[
        "flops_per_step"]


@pytest.mark.parametrize("argv", [["--model", "vit", "--device", "cpu"], ["--model", "unet"]])
def test_refusals(tmp_path, argv):
    """An unknown model, and the card (the default device) where there is
    none: no silent fallback to the CPU."""
    import torch

    if argv[1] == "unet" and torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit):
        profile_model.main([*argv, "--out-dir", str(tmp_path)])
