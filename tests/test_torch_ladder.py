"""The port's ladder entry (`python -m dlwpbench_tpu_torch.benchmark_ladder`)
against JAX's `scripts/benchmark_ladder.py`, on the CPU.  The JAX script is
imported from `scripts/` as `tests/test_ladder.py` imports it.

- parameter counts: every family of `FAMILY_RUNGS` at one width, the
  port's `count_params(build(...))` equal to JAX's `eval_shape` count as an
  integer (the HEALPix families at nside 8);
- `solve_width`: JAX's (width, params) for five (family, rung) pairs of
  `tests/test_ladder.py`;
- the CLI on the CPU: JAX's keys plus the port's, caching, `--force`,
  `--backfill-flops`, and the card (the default device) refused where
  there is none.
The step harness and its FLOP count: `tests/test_torch_ladder_step.py`.
"""

import json
import os
import sys

import jax.numpy as jnp
import pytest
import torch

from dlwpbench_tpu_torch import benchmark_ladder as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import benchmark_ladder as JL  # noqa: E402  (the JAX script)

Cc, Cp, Cq = 4, 1, 8


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_shapes(spatial, T=15):
    return tuple(jnp.zeros((1, t, c, *spatial), jnp.float32) for t, c in ((1, Cc), (T, Cp),
                                                                          (T, Cq)))


@pytest.mark.parametrize("family", sorted(TL.FAMILY_RUNGS))
def test_param_counts_equal_jax(family):
    assert set(TL.FAMILY_RUNGS) == set(JL.FAMILY_RUNGS) and len(TL.FAMILY_RUNGS) == 19
    assert TL.FAMILY_RUNGS[family] == JL.FAMILY_RUNGS[family]
    hpx = "hpx" in family
    ns, spatial = (8, (12, 8, 8)) if hpx else (None, (32, 64))
    H, W = spatial[-2:]
    width = 16
    want = JL.count_params(JL.build(family, width, H, W, Cc, Cp, Cq, ns), _jax_shapes(spatial))
    got = TL.count_params(TL.build_meta(family, width, H, W, Cc, Cp, Cq, ns))
    assert got == want, (family, got, want)
    assert TL.count_params(TL.build(family, width, H, W, Cc, Cp, Cq, ns)) == want


@pytest.mark.parametrize("family,rung", [("unet", "500k"), ("swin", "500k"), ("pangu", "8m"),
                                         ("graphcast", "8m"), ("distana", "8m")])
def test_solve_width_equals_jax(family, rung):
    assert TL.RUNGS == JL.RUNGS
    want = JL.solve_width(family, JL.RUNGS[rung], _jax_shapes((32, 64)), 32, 64, Cc, Cp, Cq,
                          None)
    got = TL.solve_width(family, TL.RUNGS[rung], 32, 64, Cc, Cp, Cq, None)
    assert got == tuple(want), (family, rung, got, want)


def _cli(tmp_path, *extra):
    out = str(tmp_path / "ladder.json")
    res = TL.main(["--device", "cpu", "--families", "unet", "--rungs", "50k", "--seq", "3",
                   "--repeats", "1", "--iters", "2", "--out", out, *extra])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    return res, out


def test_cli_writes_jax_keys_and_caches(tmp_path, capsys):
    res, out = _cli(tmp_path)
    e = res["unet@50k@32x64"]
    jax_keys = {"family", "rung", "grid", "width", "params", "batch", "seq", "step_s",
                "epoch_s_2014_protocol", "compile_s", "gridpoints_per_s", "flops_per_step",
                "achieved_tflops"}
    assert jax_keys <= set(e) and "error" not in e
    assert e["device"] == "cpu" and e["power_limit_w"] is None and "peak_mb" not in e
    assert (e["width"], e["params"]) == (10, 46888)  # JAX's results/ladder.json row
    assert e["batch"] == 1 and e["seq"] == 3 and e["step_s"] > 0
    # step_s is kept to 4 decimals, the epoch computed before that rounding
    assert abs(e["epoch_s_2014_protocol"] - 96 * e["step_s"]) <= 96 * 5e-5 + 5e-3
    assert e["attention_flops_per_step"] == 0 and e["flops_per_step"] > 0
    # cached: the second call keeps the entry as it was
    capsys.readouterr()
    again, _ = _cli(tmp_path)
    assert "cached, skipping" in capsys.readouterr().out
    assert again["unet@50k@32x64"] == e
    # --force measures again
    forced, _ = _cli(tmp_path, "--force")
    assert "cached" not in capsys.readouterr().out
    assert forced["unet@50k@32x64"]["step_s"] > 0


def test_cli_backfills_flops(tmp_path):
    _, out = _cli(tmp_path, "--no-flops")
    with open(out) as f:
        e = json.load(f)["unet@50k@32x64"]
    assert "flops_per_step" not in e and "achieved_tflops" not in e
    res = TL.main(["--device", "cpu", "--backfill-flops", "--out", out])
    f = res["unet@50k@32x64"]
    assert f["flops_per_step"] > 0 and f["step_s"] == e["step_s"]
    assert f["achieved_tflops"] == round(f["flops_per_step"] / e["step_s"] / 1e12, 3)


def test_cli_records_a_failing_row(tmp_path, monkeypatch):
    """A row that fails is `{"error": ...}` and the ladder goes on."""
    def broken(*a, **k):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(TL, "measure", broken)
    res, _ = _cli(tmp_path)
    e = res["unet@50k@32x64"]
    assert e["error"] == "RuntimeError: out of memory" and "step_s" not in e


def test_the_card_is_the_default_and_refused_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit):
        TL.main(["--families", "unet", "--rungs", "50k", "--out", str(tmp_path / "l.json")])
