"""The port's operators: the geometry ops, the spectral and graph
movements, and the wrappers of the hand-written attention kernels."""


def kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by kernel name; each counts
    its launches in `.launches` (and its bf16 ones in `.bf16_launches`, its
    tensor-core designs' in `.wgmma_launches`, `.mma_launches` or
    `.fused_launches`).
    Importing the wrappers builds nothing."""
    from dlwpbench_tpu_torch.ops import flash_attention as fa
    from dlwpbench_tpu_torch.ops import packed_attention as pk
    from dlwpbench_tpu_torch.ops import window_attention as wa

    return {"flash_window_attention": fa.flash_window_attention_fwd,
            "flash_window_attention_bwd": fa.flash_window_attention_bwd,
            "window_attention_qkv": wa.window_attention_qkv_fwd,
            "window_attention_qkv_bwd": wa.window_attention_qkv_bwd,
            "window_attention_qkv5d": wa.window_attention_qkv5d_fwd,
            "window_attention_qkv5d_bwd": wa.window_attention_qkv5d_bwd,
            "packed_window_attention": pk.packed_window_attention_fwd,
            "packed_window_attention_bwd": pk.packed_window_attention_bwd}


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count so far, by kernel name, with the
    launches of the tensor-core designs beside them (`<name>.mma` for the
    flash kernels and `<name>.wgmma` for the flash backward, `<name>.fused`
    for the window and packed ones)."""
    out = {}
    for name, fn in kernel_wrappers().items():
        out[name] = fn.launches
        for attr in ("wgmma_launches", "mma_launches", "fused_launches"):
            if hasattr(fn, attr):
                out[f"{name}.{attr.split('_')[0]}"] = getattr(fn, attr)
    return out


def launches_since(before: dict) -> dict:
    """`kernel_launches()` minus `before`: the launches of a block."""
    return {k: v - before.get(k, 0) for k, v in kernel_launches().items()}
