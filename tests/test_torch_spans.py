"""The port's spans and counters (`dlwpbench_tpu_torch/utils/profiling.py`)
and the benchmark's readers of them (`portbench/metrics/`).

- with the profiler off a span records nothing, enters no range, reads
  no clock and makes no CUDA event;
- parents nest per thread, and the bounded buffer keeps the newest
  records and counts the dropped ones;
- in a CPU trace of `Trainer.train_step` each `dlwpbench.train.*` span
  sits in the host trace as a function event (not a user annotation, so
  nothing is mirrored onto a device timeline), and its recorded interval
  encloses, on the profiler's clock, the operators the trace puts inside
  it;
- a traced tiny run of each kind prints every new metric of that kind
  (`kernel_load_s` is None without a kernel library), and the readers
  pick the first of the run's two stretches;
- the `build.*` counters count one load per library and one nvcc run per
  missing build.
"""

from __future__ import annotations

import ctypes.util
import subprocess
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dlwpbench_tpu_torch.utils import profiling

TRAIN_SPANS = ("dlwpbench.train.step", "dlwpbench.train.forward", "dlwpbench.train.backward",
               "dlwpbench.train.clip", "dlwpbench.train.optimizer")
NEW_METRICS = {
    "train": ("assemble_ms.train", "pin_ms.train", "input_stall_ms.train", "fwd_ms.train",
              "bwd_ms.train", "update_ms.train"),
    "rollout": ("assemble_ms.rollout", "h2d_ms.rollout", "fwd_ms.rollout", "d2h_ms.rollout",
                "concat_ms.rollout"),
}


@pytest.fixture(autouse=True)
def _fresh_buffer():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("device", [None, torch.device("cpu"), torch.device("cuda", 0)])
def test_a_span_with_the_profiler_off_records_nothing_and_enters_no_range(device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered a range, read a clock or made an event")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=refuse))
    monkeypatch.setattr(profiling.torch.cuda, "Event", refuse)
    first = profiling.span("dlwpbench.off", device=device)
    with first as on:
        assert on is None
        with profiling.span("dlwpbench.off.inner", device=device) as inner:
            assert inner is None
    assert profiling.span("dlwpbench.other") is first  # one shared no-op: nothing allocated
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.mark.parametrize("on_a_thread", [False, True])
def test_spans_nest_by_thread(on_a_thread):
    threads = []

    def work():
        threads.append(threading.get_native_id())
        with profiling.span("dlwpbench.a") as on:
            assert on is not None
            with profiling.span("dlwpbench.b"):
                with profiling.span("dlwpbench.c"):
                    torch.ones(4) + 1
            with profiling.span("dlwpbench.d", device=torch.device("cpu")):
                pass

    with _cpu_profile():
        with profiling.span("dlwpbench.main"):
            if on_a_thread:
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=60)
                assert not t.is_alive()
            else:
                work()
    recs = {r.name: r for r in profiling.spans()}
    top = "dlwpbench.main" if not on_a_thread else None  # a parent is on the same thread
    assert {n: r.parent for n, r in recs.items()} == {
        "dlwpbench.a": top, "dlwpbench.b": "dlwpbench.a", "dlwpbench.c": "dlwpbench.b",
        "dlwpbench.d": "dlwpbench.a", "dlwpbench.main": None}
    assert {recs[f"dlwpbench.{x}"].thread for x in "abcd"} == set(threads)
    assert (recs["dlwpbench.main"].thread == threads[0]) != on_a_thread
    a, c = recs["dlwpbench.a"], recs["dlwpbench.c"]
    assert a.start_ns <= c.start_ns <= c.end_ns <= a.end_ns
    assert recs["dlwpbench.b"].device_ms is None  # a host span
    d = recs["dlwpbench.d"]
    assert d.device_ms == pytest.approx(d.host_ms)  # no card: the host clock stands in


@pytest.mark.parametrize("capacity, made", [(3, 5), (4, 4)])
def test_the_buffer_keeps_the_newest_and_counts_the_dropped(capacity, made, monkeypatch):
    import collections

    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=capacity))
    with _cpu_profile():
        for i in range(made):
            with profiling.span(f"dlwpbench.n{i}"):
                pass
    assert [r.name for r in profiling.spans()] == [
        f"dlwpbench.n{i}" for i in range(max(0, made - capacity), made)]
    dropped = made - capacity
    assert profiling.counters().get("spans.dropped", (0, 0)) == (dropped, dropped)


def test_counters_count_and_sum_until_reset():
    profiling.add("x.events")
    profiling.add("x.events")
    profiling.add("x.seconds", 0.25)
    profiling.add("x.seconds", 0.5)
    assert profiling.counters() == {"x.events": (2, 2), "x.seconds": (2, 0.75)}
    profiling.reset()
    assert profiling.counters() == {}


@pytest.fixture(scope="module")
def traced_train_step():
    """A tiny Swin's `train_step` under a CPU profile: (kineto events, span
    records)."""
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.training.trainer import Trainer

    model = registry.build_model(
        {"type": "SwinTransformer", "context_size": 1, "img_height": 8, "img_width": 16,
         "patch_size": 1, "constant_channels": 1, "prescribed_channels": 1,
         "prognostic_channels": 2, "embed_dim": 8, "depths": [1, 1], "num_heads": [2, 2],
         "use_flash_attention": True, "remat": True}, seed=0)
    trainer = Trainer(model, learning_rate=1e-3)
    state = trainer.init()
    g = torch.Generator().manual_seed(1)
    batch = (torch.randn(2, 1, 1, 8, 16, generator=g), torch.randn(2, 3, 1, 8, 16, generator=g),
             torch.randn(2, 3, 2, 8, 16, generator=g), torch.randn(2, 2, 2, 8, 16, generator=g))
    trainer.train_step(state, batch, 1e-3)  # first-call work outside the trace
    profiling.reset()
    with _cpu_profile() as prof:
        trainer.train_step(state, batch, 1e-3)
    events = list(prof.profiler.kineto_results.events())
    records = profiling.spans()
    profiling.reset()
    return events, records


@pytest.mark.parametrize("name", TRAIN_SPANS)
def test_train_step_spans_enclose_their_operators_on_the_profilers_clock(name, traced_train_step):
    events, records = traced_train_step
    mine = [r for r in records if r.name == name]
    in_trace = sorted((e for e in events if e.name() == name), key=lambda e: e.start_ns())
    assert mine and len(mine) == len(in_trace)
    for rec, ev in zip(sorted(mine, key=lambda r: r.start_ns), in_trace):
        assert not ev.is_user_annotation() and ev.scope() != 7  # not a USER_SCOPE range
        assert not str(ev.device_type()).endswith("CUDA")
        assert ev.start_ns() <= rec.start_ns <= rec.end_ns <= ev.end_ns()
        ops = [e for e in events if e.name().startswith("aten::")
               and e.start_thread_id() == ev.start_thread_id()
               and ev.start_ns() <= e.start_ns() and e.end_ns() <= ev.end_ns()]
        assert ops, f"no operator inside {name}"
        assert all(rec.start_ns <= e.start_ns() and e.end_ns() <= rec.end_ns for e in ops)
    parents = {r.parent for r in mine}
    assert parents == ({None} if name == "dlwpbench.train.step" else {"dlwpbench.train.step"})


@pytest.mark.parametrize("cell", ["swin.train.b32", "pangu.rollout.b32x16"])
def test_a_traced_tiny_run_prints_every_new_metric_of_its_kind(cell):
    from portbench import run
    from portbench.tests._tiny import tiny

    c = tiny(cell)
    res = run.run_cell(c, 2**31 + 1234, 0.3, True, torch.device("cpu"))
    assert res["correct"]
    metrics = res["metrics"]
    for name in NEW_METRICS[c.traffic["kind"]]:
        assert name in metrics and metrics[name]["value"] >= 0, name
        assert metrics[name]["unit"] == "ms"
    assert "kernel_load_s" not in metrics  # no kernel library on the CPU
    other = "rollout" if c.traffic["kind"] == "train" else "train"
    assert not set(NEW_METRICS[other]) & set(metrics)


class _Rec:
    def __init__(self, name, start, end, device_ms=None):
        self.name, self.start_ns, self.end_ns, self.device_ms = name, start, end, device_ms

    @property
    def host_ms(self):
        return (self.end_ns - self.start_ns) / 1e6


def _two_stretches(unit, n):
    """Records of an earlier run's stretch, then this run's two: each unit
    1 ms long every 10 ms, an input span of 1 ms before each, a child of
    0.4 ms (device 0.25 ms) inside each, a tail span of 1 ms after every
    second unit; this run's first stretch doubles every time but the
    units'."""
    recs, t = [], 0
    for run, units in (("earlier", 3), ("this", 2 * n)):
        for k in range(units):
            scale = 2 if run == "this" and k < n else 1
            recs.append(_Rec("input", t, t + 1_000_000 * scale))
            recs.append(_Rec(unit, t + 3_000_000, t + 4_000_000))
            recs.append(_Rec("child", t + 3_100_000, t + 3_100_000 + 400_000 * scale,
                             0.25 * scale))
            if k % 2 == 1:
                recs.append(_Rec("tail", t + 5_000_000, t + 5_000_000 + 1_000_000 * scale))
            t += 10_000_000
        t += 1_000_000_000
    return recs


@pytest.mark.parametrize("kind, unit", [("train", "dlwpbench.train.step"),
                                        ("rollout", "dlwpbench.rollout.batch")])
def test_the_readers_take_the_first_of_this_runs_two_stretches(kind, unit, monkeypatch):
    from portbench.metrics import _spans

    n = 4
    monkeypatch.setattr(_spans, "_records", lambda: _two_stretches(unit, n))
    run_record = {"kind": kind, "traced_units": n}
    assert _spans.per_unit_ms(run_record, ("input",)) == pytest.approx(2.0)
    assert _spans.per_unit_ms(run_record, ("child",)) == pytest.approx(0.8)
    assert _spans.per_unit_ms(run_record, ("child",), device=True) == pytest.approx(0.5)
    assert _spans.per_unit_ms(run_record, ("tail",), after=True) == pytest.approx(1.0)
    assert _spans.per_unit_ms(run_record, ("missing",)) is None
    assert _spans.per_unit_ms({"kind": kind, "traced_units": 0}, ("input",)) is None
    assert _spans.per_unit_ms({"kind": kind, "traced_units": 8}, ("input",)) is None


def test_the_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    from portbench.metrics import _spans

    monkeypatch.setattr(_spans, "_profiling", lambda: object())
    assert _spans.per_unit_ms({"kind": "train", "traced_units": 2}, ("x",)) is None
    assert _spans.kernel_load_s() is None


def test_build_counts_one_load_per_library(monkeypatch):
    from dlwpbench_tpu_torch.ops import _build
    from portbench.metrics import _spans

    libm = ctypes.util.find_library("m")
    monkeypatch.setattr(_build, "build", lambda name: libm)
    _build.load.cache_clear()
    try:
        for name in ("lib_a", "lib_b", "lib_a", "lib_b", "lib_a"):
            _build.load(name)
        count, seconds = profiling.counters()["build.load"]
        assert count == 2 and seconds >= 0
        assert "build.nvcc" not in profiling.counters()
        assert _spans.kernel_load_s() == pytest.approx(seconds)
    finally:
        _build.load.cache_clear()


def test_build_counts_nvcc_only_where_the_library_is_missing(monkeypatch, tmp_path):
    from dlwpbench_tpu_torch.ops import _build

    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "k.cu").write_text("// a kernel")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path / "src"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    calls = []

    def fake_nvcc(cmd, **kwargs):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\0")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    first = _build.build("k")
    assert _build.build("k") == first and len(calls) == 1
    count, seconds = profiling.counters()["build.nvcc"]
    assert count == 1 and seconds >= 0
    assert np.isfinite(seconds)
