"""Cells of the benchmark cut to a size the CPU tests hold."""

import copy

from portbench import cells


def shrink(cell: cells.Cell) -> cells.Cell:
    """`cell` at an 8 x 16 grid, small widths and batch 4, with its limits."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg["data"].update(height=8, width=16)
    if cfg["family"] == "swin":
        cfg["model"].update(img_height=8, img_width=16, embed_dim=16, depths=[2, 2],
                            num_heads=[2, 2])
    else:
        cfg["model"].update(n_lat=8, n_lon=16, embed_dim=16, num_heads=[1, 2, 2, 1],
                            window_size=[2, 3, 4])
    cfg["reference_rows"] = 2
    cell.traffic.update(batch_size=4, batches_per_epoch=2, batches_per_split=2, trace_steps=2,
                        trace_batches=2, warmup_steps=3)
    if cell.traffic["kind"] == "rollout":
        cell.traffic["sequence_length"] = 5
    return cell


def tiny(name: str, root: str = cells.ROOT) -> cells.Cell:
    return shrink(cells.load_cell(name, root))
