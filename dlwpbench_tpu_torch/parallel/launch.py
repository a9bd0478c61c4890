"""Multi-process bootstrap, the device mesh, and the collectives the
port's exchanges run on (counterpart of `dlwpbench_tpu/parallel/
launch.py:26-98` and `parallel/mesh.py:26-38`).

JAX runs one SPMD program over a `Mesh` and lets GSPMD insert the
collectives.  The port runs one process per rank: each rank runs explicit
code on its shard and calls the collectives below over
`torch.distributed` process groups.  Launch with `torchrun`, which sets
the torch-style variables:

    torchrun --nproc_per_node N -m dlwpbench_tpu_torch.train \
        training.data_parallel=N ...

Rank discovery reads three environments (reference `manager.py:206-316`):
- torch-style  MASTER_ADDR / MASTER_PORT (default 12355) / RANK / WORLD_SIZE;
- SLURM        SLURM_PROCID / SLURM_NPROCS / SLURM_LAUNCH_NODE_IPADDR;
- OpenMPI      OMPI_COMM_WORLD_RANK / OMPI_COMM_WORLD_SIZE (+ MASTER_ADDR).
torch has no cluster auto-detection, so the SLURM and OpenMPI variables
are parsed here, unless `DLWPBENCH_AUTO_DISTRIBUTED=0`.

The backend is NCCL when the ranks run on CUDA and gloo on the CPU,
unless the caller names one.  Nothing switches it: NCCL refuses two ranks
on one card, and that error is left to raise.  A gloo group moves CUDA
tensors through pinned host memory: every collective and exchange below
copies a CUDA operand to a pinned host buffer, runs the gloo call on it
and copies the result back to the card (`_staged`).  That is gloo's
transport for device tensors, chosen by the group's backend; the compute
around it stays on the card.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_PORT = "12355"  # the reference's default MASTER_PORT
TIMEOUT_S = 600.0  # a collective that waits longer raises


# ----------------------------------------------------------------------
# rank discovery
# ----------------------------------------------------------------------


def _spec(addr: str, port: str, rank: str, world: str) -> dict:
    """`init_process_group` keyword arguments of one discovered job."""
    return {"init_method": f"tcp://{addr}:{port}", "world_size": int(world),
            "rank": int(rank)}


def torch_style_spec(env: Optional[dict] = None) -> Optional[dict]:
    """MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE (what `torchrun` sets)
    as `init_process_group` keyword arguments, or None when unset."""
    e = os.environ if env is None else env
    if "MASTER_ADDR" not in e or "RANK" not in e or "WORLD_SIZE" not in e:
        return None
    return _spec(e["MASTER_ADDR"], e.get("MASTER_PORT", DEFAULT_PORT), e["RANK"],
                 e["WORLD_SIZE"])


def slurm_spec(env: Optional[dict] = None) -> Optional[dict]:
    """SLURM_PROCID / SLURM_NPROCS / SLURM_LAUNCH_NODE_IPADDR (reference
    `manager.py:251-283`), or None when unset."""
    e = os.environ if env is None else env
    if "SLURM_PROCID" not in e or "SLURM_NPROCS" not in e:
        return None
    addr = e.get("SLURM_LAUNCH_NODE_IPADDR") or e.get("MASTER_ADDR")
    if addr is None:
        raise ValueError("SLURM_PROCID is set but neither SLURM_LAUNCH_NODE_IPADDR nor "
                         "MASTER_ADDR names the rendezvous host")
    return _spec(addr, e.get("MASTER_PORT", DEFAULT_PORT), e["SLURM_PROCID"],
                 e["SLURM_NPROCS"])


def openmpi_spec(env: Optional[dict] = None) -> Optional[dict]:
    """OMPI_COMM_WORLD_RANK / OMPI_COMM_WORLD_SIZE with MASTER_ADDR
    (reference `manager.py:285-316`), or None when unset."""
    e = os.environ if env is None else env
    if "OMPI_COMM_WORLD_RANK" not in e or "OMPI_COMM_WORLD_SIZE" not in e:
        return None
    if "MASTER_ADDR" not in e:
        raise ValueError("OMPI_COMM_WORLD_RANK is set but MASTER_ADDR is not")
    return _spec(e["MASTER_ADDR"], e.get("MASTER_PORT", DEFAULT_PORT),
                 e["OMPI_COMM_WORLD_RANK"], e["OMPI_COMM_WORLD_SIZE"])


def discover_spec(env: Optional[dict] = None) -> Optional[dict]:
    """torch-style variables first, then SLURM and OpenMPI unless
    `DLWPBENCH_AUTO_DISTRIBUTED=0`."""
    e = os.environ if env is None else env
    spec = torch_style_spec(e)
    if spec is None and e.get("DLWPBENCH_AUTO_DISTRIBUTED", "1") == "1":
        spec = slurm_spec(e) or openmpi_spec(e)
    return spec


def default_backend(device=None) -> str:
    """NCCL for ranks on CUDA, gloo for ranks on the CPU; `device` None
    reads CUDA's availability."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(spec: Optional[dict] = None, backend: Optional[str] = None,
               device=None, timeout_s: float = TIMEOUT_S) -> bool:
    """Join the multi-process job; True when this process is one of
    several ranks, False for a single-process run (no job in the
    environment, or a world of 1).

    Order: an explicit `spec` (`init_process_group` keyword arguments) >
    the torch-style variables > SLURM > OpenMPI.  Idempotent: a process
    that has already joined returns whether its world has several ranks.
    `backend` None takes `default_backend(device)`."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    spec = spec or discover_spec()
    if spec is None or int(spec["world_size"]) <= 1:
        return False
    dist.init_process_group(backend=backend or default_backend(device),
                            timeout=datetime.timedelta(seconds=timeout_s), **spec)
    return True


def host_info() -> tuple[int, int]:
    """(rank, world size), (0, 1) outside a job: the per-host input
    sharding's `host_id` and `n_hosts`."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK (torchrun), SLURM_LOCALID,
    OMPI_COMM_WORLD_LOCAL_RANK, else the global rank (one host)."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return host_info()[0]


def rank_device(device: torch.device) -> torch.device:
    """Under a joined group of several ranks, `cuda` (no index) means
    `cuda:{local_rank()}`; that index must name a card.  An explicit index
    is kept (two ranks may share `cuda:0` on gloo)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or host_info()[1] <= 1:
        return device
    idx = local_rank()
    n = torch.cuda.device_count()
    if idx >= n:
        raise RuntimeError(f"local rank {idx} has no card: this host has {n}; launch at most "
                           f"{n} ranks a host, or pass an explicit device such as cuda:0")
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def global_mesh(data: Optional[int] = None, x: int = 1):
    """A `DeviceMesh` over every rank, dims ("data", "x"): data spanning
    hosts, x the model axis (`launch.py:90-98`, `mesh.py:26-38`).  Its
    device type follows the default group's backend (NCCL -> cuda, else
    cpu); the port's collectives read only its groups."""
    from torch.distributed.device_mesh import init_device_mesh

    n = host_info()[1]
    if n % x:
        raise ValueError(f"{n} ranks not divisible by x={x}")
    data = data or n // x
    if data * x != n:
        raise ValueError(f"mesh {data}x{x} != {n} ranks")
    kind = "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (data, x), mesh_dim_names=("data", "x"))


def axis(mesh, name: str) -> tuple:
    """(group, this rank's index, size) of the mesh dim `name`."""
    size = mesh.size(list(mesh.mesh_dim_names).index(name))
    return mesh.get_group(name), mesh.get_local_rank(name), size


# ----------------------------------------------------------------------
# collectives (gloo moves CUDA tensors through pinned host memory)
# ----------------------------------------------------------------------


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum `tensors` in place over `group`: one flat buffer per dtype, so
    one collective per dtype whatever their number."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if _staged(group, flat):
            host = _to_host(flat)
            dist.all_reduce(host, group=group)
            flat.copy_(host)
        else:
            dist.all_reduce(flat, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated along `dim` in rank order."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    staged = _staged(group, src)
    if staged:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device, non_blocking=True) if staged else out


def all_to_all_single(x: torch.Tensor, group=None) -> torch.Tensor:
    """Equal split of dim 0: slot j of `x` goes to rank j; the result's
    slot i comes from rank i."""
    src = x.contiguous()
    staged = _staged(group, src)
    if staged:
        src = _to_host(src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device, non_blocking=True) if staged else out


class Exchange:
    """Point-to-point sends and receives posted together
    (`batch_isend_irecv`).  `recvs` name the tensors to receive into;
    they hold the data once `wait()` has returned (on gloo with CUDA
    tensors, after the copy from their pinned host buffers).  Peers are
    indices in `group`."""

    def __init__(self, sends: Sequence[tuple], recvs: Sequence[tuple], group=None):
        """sends: (tensor, peer); recvs: (contiguous out tensor, peer)."""
        peer_of = (lambda i: i) if group is None else (
            lambda i: dist.get_global_rank(group, i))
        ops, self._keep, self._copies = [], [], []
        for t, peer in sends:
            t = _to_host(t) if _staged(group, t) else t.contiguous()
            self._keep.append(t)
            ops.append(dist.P2POp(dist.isend, t, peer_of(peer), group))
        for out, peer in recvs:
            buf = out
            if _staged(group, out):
                buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                self._copies.append((out, buf))
            ops.append(dist.P2POp(dist.irecv, buf, peer_of(peer), group))
        self._works = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        with torch.no_grad():
            for out, buf in self._copies:
                out.copy_(buf, non_blocking=True)
        self._keep, self._copies, self._works = [], [], []


# ----------------------------------------------------------------------
# entering and leaving a sharded region (the conjugate pair of Megatron's
# sequence-parallel regions): outside, activations and their cotangents
# are the same on every rank; inside, each rank holds its chunk
# ----------------------------------------------------------------------


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        m = x.shape[dim] // n
        return x.narrow(dim, i * m, m).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        m = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, i * m, m).contiguous(), None, None


def scatter_to_ranks(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's chunk of the replicated `x` along `dim` (equal chunks,
    in rank order); the backward all-gathers the chunks' cotangents, so
    the cotangent of `x` is again the same on every rank."""
    if dist.get_world_size(group) == 1:
        return x
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{dist.get_world_size(group)} ranks")
    return _Scatter.apply(x, dim, group)


def gather_from_ranks(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's chunk concatenated along `dim`: the replicated whole.
    The backward keeps this rank's chunk of the (replicated) cotangent; a
    gather whose backward sums over the ranks would multiply every
    upstream gradient by the rank count."""
    if dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group)
