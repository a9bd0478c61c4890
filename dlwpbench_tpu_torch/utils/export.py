"""Ahead-of-time model export for serving (`torch.export`).

Counterpart of `dlwpbench_tpu/utils/export.py` (`jax.export` / StableHLO).
The model's full rollout forward, in eval mode with its weights as the
program's state, is traced once by `torch.export.export` and saved with
`torch.export.save`; serving loads the program and runs it with no model
class and no checkpoint.

The attention kernels are registered operators
(`dlwpbench_torch::flash_window_attention_fwd`, ...), so the program keeps
each call as one node, not its body: on the card the node launches the
hand-written kernel, on the CPU it runs the plain version, wherever the
program was traced.  An artifact therefore needs the port's operators
registered before it loads (`load_exported` imports them); a JAX artifact
needs no code at all.  A program traced on one device serves on another:
`load_exported(path, device)` moves its weights, constants and device
arguments there (`torch.export.passes.move_to_device_pass`).

Artifact layout, JAX's: an 8-byte magic, the header's length (int64, little
endian), a JSON header (format, device, input and output shapes, the
caller's metadata), then the `torch.export.save` blob.
"""

from __future__ import annotations

import io
import json
import os
import struct
import time
from typing import Optional, Sequence

import torch

_MAGIC = b"DLWPXP01"
FORMAT = "dlwpbench_tpu_torch.export.v1"
JAX_FORMAT = "dlwpbench_tpu.export.v1"


def _register_ops() -> None:
    """Import the modules that register the attention operators, which an
    exported program may call."""
    from dlwpbench_tpu_torch.ops import flash_attention, packed_attention, window_attention  # noqa: F401


def _spec(shape, device):
    return None if shape is None else torch.zeros(tuple(shape), device=device)


def export_rollout(
    model: torch.nn.Module,
    const_shape: Optional[Sequence[int]],
    pres_shape: Optional[Sequence[int]],
    prog_shape: Sequence[int],
    device: str = "cuda",
) -> torch.export.ExportedProgram:
    """Export the model's full rollout forward with its weights, traced on
    `device` (the model is moved there) for fp32 inputs.

    Shapes are [B, T, C, (F,) H, W] like the calling convention; pass None
    for absent constant/prescribed groups.  The model is traced in eval
    mode with per-step remat off (the forward is the same), under no_grad;
    both are restored after."""
    was_training, remat = model.training, getattr(model, "remat", None)
    model = model.to(device).eval()
    if remat is not None:
        model.remat = False
    args = tuple(_spec(s, device) for s in (const_shape, pres_shape, prog_shape))
    try:
        with torch.no_grad():
            return torch.export.export(model, args, strict=False)
    finally:
        model.train(was_training)
        if remat is not None:
            model.remat = remat


def _shapes(ep: torch.export.ExportedProgram, kind: str) -> list:
    """The program's user inputs or outputs as "dtype[shape]" strings."""
    specs = (ep.graph_signature.user_inputs if kind == "in"
             else ep.graph_signature.user_outputs)
    nodes = {n.name: n for n in ep.graph.nodes}
    out = []
    for name in specs:
        val = nodes[name].meta.get("val") if name in nodes else None
        out.append(None if val is None else f"{val.dtype}{list(val.shape)}")
    return out


def save_exported(path: str, exported: torch.export.ExportedProgram,
                  meta: Optional[dict] = None) -> None:
    """Write an exported rollout + JSON metadata as one artifact file."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    device = next((str(t.device) for t in exported.state_dict.values()), "cpu")
    header = json.dumps({
        "format": FORMAT,
        "device": device,
        "in_avals": _shapes(exported, "in"),
        "out_avals": _shapes(exported, "out"),
        **(meta or {}),
    }, default=str).encode()  # a zarr config's dates as ISO strings
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(header)))
        f.write(header)
        f.write(buf.getvalue())
    os.replace(tmp, path)


def read_artifact(path: str) -> tuple[dict, bytes]:
    """(header, blob) of an artifact of this port; raises ValueError for
    any other file, naming a JAX artifact as such."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a dlwpbench_tpu export artifact")
        (hlen,) = struct.unpack("<q", f.read(8))
        meta = json.loads(f.read(hlen).decode())
        blob = f.read()
    if meta.get("format") == JAX_FORMAT:
        raise ValueError(
            f"{path}: a JAX (StableHLO) artifact of dlwpbench_tpu, platforms "
            f"{meta.get('platforms')}; serve it with dlwpbench_tpu.utils.export, or "
            "export the run again with python -m dlwpbench_tpu_torch.export_model")
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: unsupported export format {meta.get('format')!r}")
    return meta, blob


def load_exported(path: str, device: str = "cuda"):
    """Load an artifact -> (callable(const, pres, prog), meta dict).

    The program runs on `device` (moved there if it was traced on another
    one).  The callable takes arrays or tensors with the shapes of the
    export, and None for the groups exported as absent (navier_stokes has
    no constants or prescribed channels), as JAX's does; it returns the
    rollout as a tensor on `device`."""
    _register_ops()
    meta, blob = read_artifact(path)
    ep = torch.export.load(io.BytesIO(blob))
    if torch.device(device) != torch.device(meta["device"]):
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    program = ep.module()

    def run(*args):
        tensors = [None if a is None else torch.as_tensor(a).to(device=device, dtype=torch.float32)
                   for a in args]
        with torch.no_grad():
            return program(*tensors)

    return run, meta


def export_from_run_dir(
    run_dir: str,
    out_path: str,
    batch_size: int = 1,
    sequence_length: Optional[int] = None,
    device: str = "cuda",
) -> str:
    """Export a trained run (config + best checkpoint, its raw parameters as
    JAX's `state.params`) to a serving artifact traced on `device`.

    Mirrors the evaluator's restore path (`evaluate.restore_run`): the run
    directory's saved config names the model and the data shapes, the best
    checkpoint gives the weights.  The header keeps the model and data
    configs, the exact call shapes (None = group absent; the artifact is
    shape-locked), the context size and the seconds `torch.export` took."""
    from dlwpbench_tpu_torch.evaluate import restore_run

    cfg, model, _ = restore_run(run_dir, device, ema=False)
    d = cfg.data
    # the faces' side is `healpix_nside`, as the data sources read it (JAX's
    # exporter reads a `nside` key that no data config has)
    hpx = cfg.model.get("mesh") == "healpix"
    spatial = ((12, int(d.healpix_nside), int(d.healpix_nside)) if hpx
               else (int(d.height), int(d.width)))
    T = int(sequence_length or cfg.get("testing", {}).get("sequence_length", 17))
    B = batch_size
    shapes = {
        "const": [B, 1, int(d.constant_channels), *spatial]
        if int(d.constant_channels) else None,
        "pres": [B, T, int(d.prescribed_channels), *spatial]
        if int(d.prescribed_channels) else None,
        "prog": [B, T, int(d.prognostic_channels), *spatial],
    }
    t0 = time.perf_counter()
    exported = export_rollout(model, shapes["const"], shapes["pres"], shapes["prog"],
                              device=device)
    save_exported(out_path, exported, meta={
        "trace_seconds": time.perf_counter() - t0,
        "model": dict(cfg.model),
        "data": dict(cfg.data),
        "run_dir": os.path.abspath(run_dir),
        "shapes": shapes,
        "context_size": int(cfg.model.get("context_size", 1)),
    })
    return out_path
