"""What the multi-rank analysis entries (`collective_microbench`,
`schedule_audit`, `benchmark_scaling`) share: the `--device` and
`--backend` flags, the start of their ranks, each rank's join, and the
record of where a run ran.

An entry started by hand (no rank in the environment) is the launcher:
it checks the device and the backend and starts `--devices` ranks of
itself on this host (`launch.spawn_local`).  An entry started with the
torch-style variables (by the launcher, or by `torchrun`) is one rank:
it joins the group and runs.  Rank 0 writes the output.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from dlwpbench_tpu_torch.parallel import launch


def add_flags(ap) -> None:
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    ap.add_argument("--backend", default=None, choices=(None, "nccl", "gloo"),
                    help="the group's backend: nccl on the card, gloo on the CPU by default; "
                         "gloo on the card stages every collective through pinned host memory")


@dataclasses.dataclass
class Rank:
    """One joined rank of an entry."""

    rank: int
    world: int
    device: torch.device
    backend: str
    ranks_per_card: Optional[int]

    def record(self) -> dict:
        """Where the run ran: the card's name and power limit (`device`,
        `power_limit_w`), the backend and how many ranks share a card,
        with a `note` where gloo stages CUDA tensors through the host."""
        from dlwpbench_tpu_torch.benchmark_ladder import card_info

        rec = {**card_info(self.device), "backend": self.backend,
               "ranks_per_card": self.ranks_per_card}
        if self.device.type == "cuda" and self.backend == "gloo":
            rec["note"] = (
                "gloo on the card: every collective copies its CUDA tensors to pinned host "
                "memory and back, so collective times and bandwidths are the host staging's, "
                f"not NVLink's; {self.ranks_per_card} rank(s) share each card, so compute "
                "times are a shared card's")
        return rec

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def gather(self, obj) -> list:
        """`obj` of every rank, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def start_or_join(module: str, args, argv, n: int, entry: str) -> Optional[Rank]:
    """The launcher (no rank in the environment) starts `n` ranks of
    `module` with `argv` and returns None once they have ended; a rank
    joins its group and returns its `Rank`.  `--device cuda` without a
    card ends the entry (SystemExit); NCCL on the CPU or for more ranks
    than cards raises ValueError."""
    from dlwpbench_tpu_torch.utils.device import entry_device

    device = entry_device(args.device, entry)
    if launch.discover_spec() is None:
        backend = launch.entry_backend(args.backend, device, n)
        argv = list(sys.argv[1:] if argv is None else argv)
        outs = launch.spawn_local(module, n, argv, backend)
        sys.stdout.write(outs[0])
        return None
    world = launch.discover_spec()["world_size"]
    backend = launch.entry_backend(args.backend, device, world)
    rank, world, device = launch.join_entry_ranks(backend, device)
    return Rank(rank, world, device, backend, launch.ranks_per_card(backend, device, world))


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def merge_write(path: str, results: dict) -> dict:
    """Write `results` to `path`, keeping the sections of an existing file
    that `results` lacks (JAX's merge-preserve of the sections other
    entries own).  Returns what was written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = {}
        for k, v in prev.items():
            results.setdefault(k, v)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
