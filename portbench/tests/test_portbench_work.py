"""The benchmark's own work counts and its trace reduction, on the CPU."""

import pytest
import torch

from portbench import trace, work
from portbench.reference.common import AttentionCall
from portbench.run import count_work
from portbench.tests._tiny import tiny
from portbench import cells

STAGE0 = AttentionCall(q_shape=(32, 4, 2048, 24), bias_numel=4 * 2048 * 2048, mask_numel=0)


def test_stage0_flash_forward_is_51_5_gflop():
    # 0.3124 ms at 165 TFLOP/s in PERF.md's kernel table: 4 * 128 * 2048^2 * 24
    assert work.attention_flops(STAGE0) == 51_539_607_552


@pytest.mark.parametrize("call", [STAGE0, AttentionCall((32, 6, 6, 6, 144, 32), 6 * 6 * 144 * 144,
                                                        6 * 6 * 144 * 144)])
def test_backward_counts_twice_the_forward(call):
    assert work.attention_flops(call, backward=True) == 2 * work.attention_flops(call)


def test_attention_bytes_read_inputs_once_and_write_outputs_once():
    c = AttentionCall((2, 3, 16, 8), bias_numel=3 * 16 * 16, mask_numel=16 * 16)
    tok, stat = 2 * 3 * 16 * 8, 2 * 3 * 16
    assert work.attention_bytes(c) == 4 * (4 * tok + stat + 3 * 16 * 16 + 16 * 16)
    assert work.attention_bytes(c, backward=True) == 4 * (8 * tok + stat + 2 * 3 * 16 * 16
                                                          + 16 * 16)


def test_least_time_takes_the_larger_bound():
    flops = work.attention_flops(STAGE0)
    byts = work.attention_bytes(STAGE0)
    assert work.least_seconds([STAGE0], 495e12, 3.35e12, backward=False) == \
        max(flops / 495e12, byts / 3.35e12)


def test_swin_cell_counts_every_block_and_step():
    flops, calls = count_work(cells.load_cell("swin.train.b32"))
    # 2 rollout steps x 8 blocks: stage 0 N 2048 d 24, stage 1 N 512 d 48
    assert len(calls) == 16
    shapes = sorted({c.q_shape for c in calls})
    assert shapes == [(32, 1, 4, 512, 48), (32, 1, 4, 2048, 24)]
    attn = sum(work.attention_flops(c) for c in calls)
    assert attn == 2 * 4 * (51_539_607_552 + 4 * 32 * 4 * 512**2 * 48)
    assert flops > attn


def test_pangu_cell_counts_its_masked_blocks():
    _, calls = count_work(cells.load_cell("pangu.rollout.b32x16"))
    assert len(calls) == 16 * 16
    assert sum(c.mask_numel > 0 for c in calls) == 16 * 8
    assert {c.q_shape[-2:] for c in calls} == {(144, 32)}


def test_model_flops_of_a_tiny_cell_match_a_count_on_real_tensors():
    cell = tiny("pangu.train.b32")
    from portbench.reference import reference_class
    from torch.utils.flop_counter import FlopCounterMode

    meta_flops, _ = count_work(cell)
    ref = reference_class("pangu")(**cell.config["model"])
    x = (torch.randn(4, 1, 4, 8, 16), torch.randn(4, 3, 1, 8, 16), torch.randn(4, 3, 8, 8, 16))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(*x)
    assert meta_flops == counter.get_total_flops()


def _ev(name, dev, s, e, thread=1, corr=0):
    return trace.Event(name, dev, s, e, thread, corr)


def test_trace_summary_unions_busy_time_and_finds_the_attention_kernels():
    device_only = [_ev("gemm", True, 100, 300, 0, 1), _ev("gemm", True, 250, 400, 0, 2),
                   _ev("portbench::train_step", True, 0, 900), _ev("gemm", True, 600, 700, 0, 3)]
    with_host = [
        _ev("portbench::train_step", False, 0, 900),
        _ev("portbench::train_step", True, 0, 900),  # a span's mirror on the device
        _ev("dlwpbench_torch::flash_window_attention_fwd", False, 10, 50),
        _ev("cudaLaunchKernel", False, 20, 30, corr=7),
        _ev("aten::mm", False, 60, 80),
        _ev("cudaLaunchKernel", False, 65, 70, corr=8),
        _ev("flash_fwd", True, 100, 300, 0, 7),
        _ev("gemm", True, 500, 600, 0, 8),
    ]
    s = trace.summarize(device_only, 1e-6, with_host)
    assert s.busy_s == pytest.approx(400e-9) and s.window_s == 1e-6
    assert s.device_ops == [["gemm", pytest.approx(450e-9)]]
    assert s.attention_s == pytest.approx(200e-9)
    assert s.idle_gaps == [["train_step / aten::mm", pytest.approx(200e-9)]]


def test_trace_summary_is_none_without_device_events():
    host = [_ev("portbench::train_step", False, 0, 10)]
    assert trace.summarize(host, 1.0, host) is None
