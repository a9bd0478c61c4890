"""The port's flash window attention against the JAX package's.

On the CPU the port's wrapper takes its plain version; it is held against
`_flash_impl` run through Pallas interpret mode and against
`reference_attention`, on the same numpy inputs.  Tolerance: fp32, atol
2e-5 (online versus two-pass softmax: the sums run in another order).
The CUDA kernel itself is tested in `test_torch_cuda_kernels.py`.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.ops import pallas_attention as pa
from dlwpbench_tpu_torch.ops import _build
from dlwpbench_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5
B, H = 4, 2


def _inputs(seed, N, D, bias_shape):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal(bias_shape).astype(np.float32)
    return q, k, v, bias


def _bias_shape(kind, N):
    return {"3d": (H, N, N), "g1": (1, H, N, N), "g2": (2, H, N, N)}[kind]


@pytest.mark.parametrize("bias_kind", ["3d", "g1", "g2"])
@pytest.mark.parametrize("D", [8, 24])
@pytest.mark.parametrize("N", [128, 240, 60])  # panel path; streaming with key tails
def test_plain_matches_jax_flash(N, D, bias_kind):
    q, k, v, bias = _inputs(N * 1000 + D, N, D, _bias_shape(bias_kind, N))
    j_out, j_lse = pa._flash_impl(*map(jnp.asarray, (q, k, v, bias)), interpret=True)
    ref = pa.reference_attention(*map(jnp.asarray, (q, k, v, bias)), D**-0.5)
    out, lse = fa.flash_window_attention_fwd(*map(torch.from_numpy, (q, k, v, bias)))
    assert out.shape == (B, H, N, D) and lse.shape == (B, H, 1, N)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, bias = map(torch.from_numpy, _inputs(0, 16, 8, (H, 16, 16)))
    before = fa.flash_window_attention_fwd.launches
    out = fa.flash_window_attention(q, k, v, bias)
    want, _ = fa.flash_window_attention_plain(q, k, v, bias)
    assert torch.equal(out, want)
    assert fa.flash_window_attention_fwd.launches == before


def test_bf16_plain_computes_in_fp32():
    q, k, v, bias = (t.to(torch.bfloat16) for t in map(torch.from_numpy, _inputs(1, 40, 16, (H, 40, 40))))
    out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
    want, want_lse = fa.flash_window_attention_plain(q.float(), k.float(), v.float(), bias.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


@pytest.mark.parametrize(
    "q_shape, bias_shape",
    [
        ((4, 2, 16, 8), (2, 16, 8)),       # bias not [H, N, N]
        ((4, 2, 16, 8), (3, 2, 16, 16)),   # B % G != 0
        ((4, 2, 16, 8), (2, 2, 2, 16, 16)),  # 5D bias
        ((2, 16, 8), (2, 16, 16)),         # 3D q
    ],
)
def test_bad_shapes_raise(q_shape, bias_shape):
    q = torch.zeros(q_shape)
    with pytest.raises(ValueError):
        fa.flash_window_attention_fwd(q, q, q, torch.zeros(bias_shape))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A failed build raises; it never hands back the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("flash_window_attention")
    assert list(tmp_path.iterdir()) == []


def test_library_is_keyed_by_source_hash():
    path = _build.library_path("flash_window_attention")
    assert path.startswith(_build.BUILD_DIR)
    assert path.endswith(".so") and "flash_window_attention-" in path


def test_library_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edited header (`csrc/*.cuh`) rebuilds every source beside it."""
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    before = _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before


@pytest.mark.parametrize("N, D, route", [
    (2048, 24, "mma"),   # Swin stage 0
    (512, 48, "mma"),    # Swin stage 1
    (144, 32, "mma"),    # Pangu's flash route, G 36
    (1000, 32, "mma"),   # the tail case, G 4
    (60, 64, "mma"),     # the largest head dim the design takes
    (200, 72, "rows"),   # the first head dim past it
    (65, 128, "rows"),
])
def test_forward_route_is_chosen_by_shape(N, D, route):
    assert fa.fwd_route(N, D) == route


@pytest.mark.parametrize("N, D, G, route", [
    (128, 24, 0, "mma"), (60, 48, 2, "mma"), (144, 32, 4, "mma"), (40, 72, 1, "rows"),
])
def test_wrapper_launches_the_design_fwd_route_names(monkeypatch, N, D, G, route):
    """On a (faked) CUDA tensor the wrapper calls the C entry of the design
    `fwd_route` names, once, and counts it: `.launches` always,
    `.mma_launches` on the mma design only."""
    calls = []
    monkeypatch.setattr(fa, "_device_of", lambda tensors: torch.device("cuda"))
    monkeypatch.setattr(fa, "_kernel_fn",
                        lambda source, symbol, n_ptr, n_int: calls.append(symbol) or (lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    counter = fa.flash_window_attention_fwd
    monkeypatch.setattr(counter, "launches", 0)
    monkeypatch.setattr(counter, "mma_launches", 0)
    q = torch.zeros(4, 2, N, D)
    bias = torch.zeros((2, N, N) if G == 0 else (G, 2, N, N))
    out, lse = fa.flash_window_attention_fwd(q, q, q, bias)
    assert calls == ["flash_window_attention_fwd_mma" if route == "mma"
                     else "flash_window_attention_fwd"]
    assert (counter.launches, counter.mma_launches) == (1, int(route == "mma"))
    assert out.shape == q.shape and lse.shape == (4, 2, 1, N) and lse.dtype == torch.float32
