"""The port's collective analysis on the CPU: `launch.count_bytes`, the
schedule audit's `audit_events`, and the `collective_microbench` and
`schedule_audit` entries, against JAX's scripts (imported from `scripts/`
as `tests/test_aux.py` imports them).

- `audit_events` on the two programs of `tests/test_aux.py::
  TestScheduleAudit`, written as the event lists a trace of the port
  gives: the summary keys equal those of JAX's `audit_entry` on the HLO;
- the byte tally of every collective on a one-rank gloo group: each
  call's result bytes under JAX's HLO kind, the backward included;
- the two entries through `launch.spawn_local` on 2 gloo ranks: JAX's
  keys (its `hlo_audit` as `byte_audit`, its
  `fused_step_time_virtual_mesh_s` as `fused_step_time_s`), the byte
  ratio 1 exactly, the audit merged beside the microbench's sections;
- `--device cuda` without a card, and NCCL on the CPU, refused before any
  rank starts.
The tallied bytes against JAX's HLO bytes at 4 ranks, and the ring audit
on 4 ranks, run in the spectral suite's ranks
(`tests/test_torch_spectral_dist.py`).  Counts are exact; times only
have to be positive.
"""

import json
import os
import sys
import threading

import pytest
import torch

from _torch_dist_child import one_rank_mesh
from dlwpbench_tpu_torch import collective_microbench as TCM
from dlwpbench_tpu_torch import schedule_audit as TSA
from dlwpbench_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# audit_events against JAX's audit_entry
# ---------------------------------------------------------------------------

PERMUTE = TSA.RANGE_PREFIX + "collective-permute"
INDEPENDENCE_HLO = """
HloModule m

%helper (a: f32[4]) -> f32[4] {
  %a = f32[4] parameter(0)
  ROOT %d = f32[4] dot(%a, %a)
}

ENTRY %main (p0: f32[4], p1: f32[4]) {
  %p0 = f32[4] parameter(0)
  %p1 = f32[4] parameter(1)
  %cp = f32[4] collective-permute(%p0), channel_id=1
  %indep = f32[4] dot(%p1, %p1)
  %dep = f32[4] dot(%cp, %cp)
  %fus = f32[4] fusion(%p1), kind=kLoop, calls=%helper
  ROOT %sum = f32[4] add(%dep, %fus)
}
"""
SERIAL_HLO = """
HloModule m

ENTRY %main (p0: f32[4]) {
  %p0 = f32[4] parameter(0)
  %d0 = f32[4] dot(%p0, %p0)
  %cp = f32[4] collective-permute(%d0), channel_id=1
  ROOT %d1 = f32[4] dot(%cp, %cp)
}
"""


def _events(*names):
    """Host events in issue order, one microsecond each, back to back."""
    return [{"name": n, "start_us": float(i), "end_us": i + 0.5} for i, n in enumerate(names)]


SUMMARY = ("n_collectives", "n_compute_ops", "n_collectives_with_zero_overlap_window",
           "min_independent_compute", "median_independent_compute")


def test_audit_counts_the_independent_launches_of_a_window():
    """JAX's first case as issued: the exchange posted, the independent
    product and the fusion's product launched, the wait, the dependent
    product, the add: 2 independent, 1 descendant, no zero window."""
    import schedule_audit as JSA

    got = TSA.audit_events(_events(PERMUTE + ".post", "aten::mm", "aten::bmm", PERMUTE + ".wait",
                                   "aten::mm", "aten::add"))
    row = got["collectives"][0]
    assert row["independent_compute_ops"] == 2
    assert row["descendant_compute_ops"] == 1
    assert row["overlapped_device_us"] is None
    want = JSA.audit_entry(INDEPENDENCE_HLO)
    assert {k: got[k] for k in SUMMARY} == {k: want[k] for k in SUMMARY}
    assert want["collectives"][0]["descendant_compute_ops"] == 1


def test_audit_flags_a_serial_chain():
    """JAX's second case: product, exchange, product, nothing in between:
    one zero window."""
    import schedule_audit as JSA

    got = TSA.audit_events(_events("aten::mm", PERMUTE + ".post", PERMUTE + ".wait",
                                   "aten::mm"))
    assert got["n_collectives_with_zero_overlap_window"] == 1
    want = JSA.audit_entry(SERIAL_HLO)
    assert {k: got[k] for k in SUMMARY} == {k: want[k] for k in SUMMARY}


def test_audit_blocking_calls_nesting_and_device_time():
    """A blocking collective's window is empty and what runs inside its
    range is part of it; a product inside an attention operator is that
    operator's; the device time inside a window counts, copies aside."""
    ev = [{"name": TSA.RANGE_PREFIX + "all-to-all", "start_us": 0.0, "end_us": 10.0},
          {"name": "aten::mm", "start_us": 2.0, "end_us": 3.0},  # inside the call
          {"name": PERMUTE + ".post", "start_us": 11.0, "end_us": 12.0},
          {"name": "dlwpbench_torch::flash_window_attention_fwd", "start_us": 13.0,
           "end_us": 20.0},
          {"name": "aten::bmm", "start_us": 14.0, "end_us": 15.0},  # inside the operator
          {"name": PERMUTE + ".wait", "start_us": 21.0, "end_us": 30.0}]
    dev = [{"name": "flash_fwd_mma_kernel", "start_us": 18.0, "end_us": 26.0},
           {"name": "Memcpy HtoD (Pinned -> Device)", "start_us": 27.0, "end_us": 29.0},
           {"name": "gemm", "start_us": 40.0, "end_us": 50.0}]
    got = TSA.audit_events(ev, dev)
    assert got["n_compute_ops"] == 1
    assert [(c["name"], c["independent_compute_ops"]) for c in got["collectives"]] == [
        ("all-to-all", 0), ("collective-permute", 1)]
    assert got["collectives"][1]["overlapped_device_us"] == 8.0
    assert got["collectives"][0]["overlapped_device_us"] == 0.0
    assert got["n_collectives_with_zero_overlap_window"] == 1


# ---------------------------------------------------------------------------
# the byte tally
# ---------------------------------------------------------------------------


def test_count_bytes_tallies_each_result_by_kind(monkeypatch):
    """On one gloo rank: the all-reduce's flat buffer (one call a dtype),
    the all-gather's result, the all-to-all forward and backward, the
    reduce-scatter's chunk and its backward's all-gather, an exchange's
    receives (gloo sends nothing to its own rank: the post is stubbed);
    nested tallies count what runs inside them, on any thread."""
    monkeypatch.setattr(torch.distributed, "batch_isend_irecv", lambda ops: [])
    with one_rank_mesh() as mesh:
        group = launch.axis(mesh, "x")[0]
        with launch.count_bytes() as outer:
            launch.all_reduce_([torch.zeros(3), torch.zeros(5),
                                torch.zeros(2, dtype=torch.float64)])
            launch.all_gather_cat(torch.zeros(4, 2), 0, group)
            with launch.count_bytes() as inner:
                x = torch.zeros(1, 6, requires_grad=True)
                # the backward on another thread, as autograd runs a CUDA one
                worker = threading.Thread(
                    target=lambda: launch.all_to_all(x, group).sum().backward())
                worker.start()
                worker.join(timeout=60)
                assert not worker.is_alive()
            y = torch.zeros(4, 3, requires_grad=True)
            launch.reduce_scatter(y, 0, group).sum().backward()
            launch.Exchange([(torch.ones(7), 0)], [(torch.empty(7), 0)], group).wait()
    assert inner.bytes == {"all-to-all": 2 * 6 * 4}
    assert outer.bytes == {"all-reduce": 8 * 4 + 2 * 8, "all-gather": 8 * 4 + 12 * 4,
                           "all-to-all": 2 * 6 * 4, "reduce-scatter": 12 * 4,
                           "collective-permute": 7 * 4}
    assert outer.calls == {"all-reduce": 2, "all-gather": 2, "all-to-all": 2,
                           "reduce-scatter": 1, "collective-permute": 1}


# ---------------------------------------------------------------------------
# the two entries on 2 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """`collective_microbench` then `schedule_audit` into one file, each
    on 2 gloo ranks started by `launch.spawn_local` in a temporary working
    directory; (the microbench's return, the audit's, the file)."""
    work = tmp_path_factory.mktemp("entries")
    out = str(work / "mb.json")
    env = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        mb = TCM.main(["--device", "cpu", "--devices", "2", "--channels", "16", "--nlat", "16",
                       "--nlon", "32", "--out", out])
        sa = TSA.main(["--device", "cpu", "--devices", "2", "--out", out])
    finally:
        os.environ.clear()
        os.environ.update(env)
    with open(out) as f:
        return mb, sa, json.load(f)


def test_microbench_writes_jax_keys_and_ratio_one(entries):
    import collective_microbench as JCM  # noqa: F401  (JAX's script: the keys below are its)

    mb, _, saved = entries
    assert {"devices", "channels", "grid", "byte_audit", "timing"} <= set(saved)
    assert "hlo_audit" not in saved
    assert (saved["devices"], saved["channels"], saved["grid"]) == (2, 16, "16x32")
    audit = saved["byte_audit"]
    assert {"collective_bytes_per_device", "all_to_all_bytes_per_device",
            "model_claim_bytes_per_device", "ratio_vs_model"} <= set(audit)
    # mmax 16 at 16 x 32 splits over 2 ranks: 4 x 16 x 16 x 16 x 8 / 2
    assert audit["all_to_all_bytes_per_device"] == audit["model_claim_bytes_per_device"] == 65536
    assert audit["ratio_vs_model"] == 1.0
    assert audit["all_to_all_bytes_by_rank"] == [65536, 65536]
    timing = saved["timing"]
    assert [r["payload_mb"] for r in timing["rows"]] == [1, 4, 16, 64]
    assert all(r["time_s"] > 0 for r in timing["rows"])
    assert {"latency_s", "effective_bw_gbps", "r2_linear_in_bytes"} <= set(timing)
    assert (saved["device"], saved["power_limit_w"], saved["backend"],
            saved["ranks_per_card"]) == ("cpu", None, "gloo", None)
    assert not any(saved["attention_launches"].values())
    assert mb["byte_audit"] == audit


def test_schedule_audit_merges_beside_the_microbench(entries):
    """The audit under `schedule_audit`, the microbench's sections kept;
    JAX's keys with `fused_step_time_s` in place of
    `fused_step_time_virtual_mesh_s`; on 2 ranks the ring posts one
    exchange, its window holding the attention operator, and the fused
    SFNO's 32 all-to-alls block (no window)."""
    _, sa, saved = entries
    assert saved["schedule_audit"] == sa
    assert saved["byte_audit"]["ratio_vs_model"] == 1.0
    assert {"ring_attention", "fused_sfno", "fused_step_time_s", "note"} <= set(sa)
    assert "fused_step_time_virtual_mesh_s" not in sa
    assert sa["fused_step_time_s"]["K1"] > 0 and sa["fused_step_time_s"]["K8"] > 0
    ring, sfno = sa["ring_attention"], sa["fused_sfno"]
    for s in (ring, sfno):
        assert {"geometry", "n_collectives", "n_compute_ops",
                "n_collectives_with_zero_overlap_window", "min_independent_compute",
                "median_independent_compute"} <= set(s)
        assert s["overlapped_device_us"] is None
        assert not any(s["attention_launches"].values())  # CPU tensors: the plain version
    assert ring["geometry"] == {"B": 2, "H": 4, "N": 512, "D": 32, "devices": 2,
                                "round_q": [2, 4, 256, 32], "round_bias": [1, 4, 256, 256]}
    assert (ring["n_collectives"], ring["min_independent_compute"]) == (1, 1)
    assert ring["n_collectives_with_zero_overlap_window"] == 0
    assert sfno["n_collectives"] == 32  # 2 layers x 4 chunks x 2 transposes, forward and backward
    assert sfno["n_collectives_with_zero_overlap_window"] == 32
    assert sa["n_collectives_by_rank"] == [{"ring": 1, "sfno": 32}] * 2
    assert (sa["device"], sa["backend"]) == ("cpu", "gloo")


@pytest.mark.parametrize("argv", [["--device", "cuda"], ["--device", "cpu", "--backend", "nccl"]],
                         ids=["cuda-without-card", "nccl-on-cpu"])
@pytest.mark.parametrize("entry", ["microbench", "schedule_audit"])
def test_entries_refuse_before_any_rank_starts(entry, argv, monkeypatch):
    """No card: `--device cuda` ends the entry; NCCL on the CPU raises.
    Neither starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "spawn_local", lambda *a, **k: pytest.fail("a rank started"))
    main = TCM.main if entry == "microbench" else TSA.main
    with pytest.raises(SystemExit if argv[1] == "cuda" else ValueError):
        main([*argv, "--devices", "2"])
