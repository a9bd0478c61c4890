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

The analysis entries (`collective_microbench`, `schedule_audit`,
`benchmark_scaling`) read two things off these collectives:
- `count_bytes()`, a tally of the bytes of each call's result on this
  rank, by collective kind (JAX's HLO kinds: "all-to-all", "all-reduce",
  "all-gather", "reduce-scatter", and "collective-permute" for an
  `Exchange`'s receives), the counterpart of summing the result shapes of
  the per-device HLO (`scripts/collective_microbench.py:48-79`);
- a `torch.profiler.record_function` range around every collective,
  `dlwpbench.collective.<kind>`, and two around an `Exchange`, at its
  post (`...collective-permute.post`) and at its `wait`
  (`...collective-permute.wait`), so that a trace shows each exchange's
  window.
`spawn_local` starts the ranks of such an entry on this host.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import subprocess
import sys
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_PORT = "12355"  # the reference's default MASTER_PORT
TIMEOUT_S = 600.0  # a collective that waits longer raises
RENDEZVOUS_S = 60.0  # the process-group timeout of a rank that `spawn_local` starts
CHILD_TIMEOUT_S = 1800.0  # a rank that `spawn_local` starts and that runs longer is killed
RANGE_PREFIX = "dlwpbench.collective."


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


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(module: str, n: int, argv: Sequence[str], backend: str,
                timeout_s: float = CHILD_TIMEOUT_S) -> list[str]:
    """Run `n` ranks of `python -m module *argv --backend backend` on this
    host, with the torch-style variables on a free port (RANK and
    LOCAL_RANK r, WORLD_SIZE n), in the caller's working directory; each
    rank is killed after `timeout_s`.  Returns each rank's output (stdout
    and stderr) in rank order; raises RuntimeError with a failing rank's
    output."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    cmd = [sys.executable, "-m", module, *argv, "--backend", backend]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{module}: a rank ran longer than {timeout_s:.0f} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{module} rank {r} of {n} exited {p.returncode}:\n{out[-6000:]}")
    return outs


def entry_backend(backend: Optional[str], device: torch.device, n: int) -> str:
    """The backend of an entry's `n` ranks on `device`: `backend`, or NCCL
    on the card and gloo on the CPU.  NCCL on the CPU, or NCCL for more
    ranks than this host has cards, raises ValueError; nothing switches to
    gloo unasked."""
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use nccl or gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL needs the card: pass --backend gloo with --device cpu")
        if n > torch.cuda.device_count():
            raise ValueError(f"NCCL for {n} ranks needs {n} cards and this host has "
                             f"{torch.cuda.device_count()}; pass --backend gloo to share a card")
    return backend


def ranks_per_card(backend: str, device: torch.device, n: int) -> Optional[int]:
    """How many of `n` ranks share each card (None on the CPU): gloo ranks
    beyond the host's cards share them round-robin, NCCL's one each."""
    if device.type != "cuda":
        return None
    return -(-n // torch.cuda.device_count())


def join_entry_ranks(backend: str, device: torch.device) -> tuple[int, int, torch.device]:
    """Join the job the environment names (a world of one included) as
    one rank of an analysis entry; (rank, world size, this rank's device:
    `cuda:{local rank % cards}` on the card)."""
    spec = discover_spec()
    if spec is None:
        raise RuntimeError("no rank in the environment: start the entry's ranks with spawn_local")
    if device.type == "cuda":
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, timeout=datetime.timedelta(seconds=RENDEZVOUS_S),
                            **spec)
    return dist.get_rank(), dist.get_world_size(), device


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
# the byte tally
# ----------------------------------------------------------------------


class ByteTally:
    """Bytes of the collectives' results on this rank, by kind, and the
    number of calls of each kind."""

    def __init__(self):
        self.bytes: dict[str, int] = {}
        self.calls: dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.calls[kind] = self.calls.get(kind, 0) + 1


# the open tallies: process-wide, not a context variable, because autograd
# runs a CUDA backward (and its collectives) on a device thread of its own
_TALLIES: list = []
_TALLIES_LOCK = threading.Lock()


@contextlib.contextmanager
def count_bytes():
    """A `ByteTally` of every collective called in this process while the
    block runs, forward and backward, whatever the thread: `all_reduce_`,
    `all_gather_cat`, `all_to_all_single` / `all_to_all`, `reduce_scatter`
    and each `Exchange`'s receives.  Blocks nest; each tally counts what
    runs inside it."""
    tally = ByteTally()
    with _TALLIES_LOCK:
        _TALLIES.append(tally)
    try:
        yield tally
    finally:
        with _TALLIES_LOCK:
            _TALLIES.remove(tally)


def _tally(kind: str, *tensors: torch.Tensor) -> None:
    if _TALLIES:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        with _TALLIES_LOCK:
            for t in _TALLIES:
                t.add(kind, nbytes)


def _range(kind: str):
    return torch.profiler.record_function(RANGE_PREFIX + kind)


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
        with _range("all-reduce"):
            flat = torch.cat([t.reshape(-1) for t in ts])
            if _staged(group, flat):
                host = _to_host(flat)
                dist.all_reduce(host, group=group)
                flat.copy_(host)
            else:
                dist.all_reduce(flat, group=group)
            _tally("all-reduce", flat)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated along `dim` in rank order."""
    with _range("all-gather"):
        n = dist.get_world_size(group)
        src = x.contiguous()
        staged = _staged(group, src)
        if staged:
            src = _to_host(src)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        _tally("all-gather", out)
        return out.to(x.device, non_blocking=True) if staged else out


def all_to_all_single(x: torch.Tensor, group=None,
                      kind: Optional[str] = "all-to-all") -> torch.Tensor:
    """Equal split of dim 0: slot j of `x` goes to rank j; the result's
    slot i comes from rank i.  `kind` names the call in the byte tally and
    its profiler range (None: neither, for a caller that tallies the call
    as part of its own)."""
    with _range(kind) if kind else contextlib.nullcontext():
        src = x.contiguous()
        staged = _staged(group, src)
        if staged:
            src = _to_host(src)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        if kind:
            _tally(kind, out)
        return out.to(x.device, non_blocking=True) if staged else out


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` under autograd: with equal slots the exchange
    is its own adjoint, so the backward is the same exchange.  `kinds`:
    the tally's and ranges' kind of the forward and of the backward
    exchange."""

    @staticmethod
    def forward(ctx, x, group, kinds):
        ctx.group, ctx.kind = group, kinds[1]
        return all_to_all_single(x, group, kinds[0])

    @staticmethod
    def backward(ctx, g):
        return all_to_all_single(g, ctx.group, ctx.kind), None, None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """`all_to_all_single` (slot j of dim 0 to rank j) that autograd
    differentiates."""
    return _AllToAll.apply(x, group, ("all-to-all", "all-to-all"))


def reduce_scatter(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Sum `x` over `group` and keep this rank's equal chunk of `dim`
    (JAX's tiled `psum_scatter`), differentiable.  Built from one
    `all_to_all` and a sum over the received partials, as gloo has no
    reduce-scatter of tensors: the same bytes as a reduce-scatter, and the
    backward (the all-to-all's own, then the sum's broadcast) is the
    all-gather JAX derives.  The tally counts them as JAX's HLO names
    them: the forward a "reduce-scatter" of its result (this rank's
    chunk), the backward an "all-gather" of the whole cotangent."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    d = dim % x.ndim
    with _range("reduce-scatter"):
        parts = x.reshape(*x.shape[:d], n, x.shape[d] // n, *x.shape[d + 1:]).movedim(d, 0)
        out = _AllToAll.apply(parts, group, (None, "all-gather")).sum(0)
        _tally("reduce-scatter", out)
    return out


class Exchange:
    """Point-to-point sends and receives posted together
    (`batch_isend_irecv`).  `recvs` name the tensors to receive into;
    they hold the data once `wait()` has returned (on gloo with CUDA
    tensors, after the copy from their pinned host buffers).  Peers are
    indices in `group`.  The post and the wait each run in a profiler
    range (`dlwpbench.collective.collective-permute.post` / `.wait`); the
    tally counts the receives' bytes as a "collective-permute"."""

    def __init__(self, sends: Sequence[tuple], recvs: Sequence[tuple], group=None):
        """sends: (tensor, peer); recvs: (contiguous out tensor, peer)."""
        peer_of = (lambda i: i) if group is None else (
            lambda i: dist.get_global_rank(group, i))
        with _range("collective-permute.post"):
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
            _tally("collective-permute", *(out for out, _ in recvs))

    def wait(self) -> None:
        with _range("collective-permute.wait"):
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
