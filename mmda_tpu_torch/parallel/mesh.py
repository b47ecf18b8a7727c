"""The ('data', 'model') mesh over `torch.distributed`: data parallelism.

Counterpart of `mmda_tpu/parallel/mesh.py` for the 'data' axis.  The JAX
package runs data parallelism as SPMD over one global batch: the batch is
sharded over 'data', XLA computes the objective over the whole batch and
inserts the gradient all-reduce.  A data-parallel step is therefore, up to
summation order, the one-device step at the global batch, and so is the
port's: each rank runs the forward on its rows, `gather_rows` gathers what
the objective reads, every rank computes the same global objective, and
`all_reduce_grads` sums the ranks' shares of its gradient (`train/step.py`).
Averaging per-rank losses (naive DDP) would change the objective, since
MISA's diff, CMD, reconstruction and ConfidNet terms couple the rows of a
batch.

* `init_distributed` joins the process group: the rank, world size and
  local rank from torchrun's environment or given, `env://` or a `file://`
  store, always a timeout.  The backend follows the device, `nccl` on CUDA
  and `gloo` on the CPU; gloo on CUDA must be asked for (tensors then cross
  the host at each collective), and a CUDA device without `nccl` raises.
* `make_mesh(dp, tp)` is the mesh of the world: dp = -1 takes all of it,
  dp * tp must equal the world size, and tp > 1 raises (tensor parallelism
  is ROADMAP Queue 1 item 2).
* `shard_batch` takes a rank's contiguous rows [r B / dp, (r + 1) B / dp)
  of a host batch, and leaves a batch whose B does not divide dp whole: the
  JAX trainer runs such a batch replicated.
* `replicated` broadcasts a module's parameters and buffers from rank 0.

The collectives are `all_reduce`, `all_gather`, `broadcast` and `barrier`.
`all_gather` and `broadcast` move bytes (a `uint8` view), so every backend
takes every dtype; `all_reduce` sums gradients in their own dtype.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
GRAD_BUCKET_BYTES = 32 << 20      # all_reduce_grads: one collective per bucket


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, local_rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group; returns this rank's device.  rank,
    world_size and local_rank default to torchrun's RANK, WORLD_SIZE and
    LOCAL_RANK; init_method to `env://` (MASTER_ADDR, MASTER_PORT).
    device: "cuda" (the card LOCAL_RANK), "cuda:N" or "cpu"."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed on CUDA, but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run the ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"device must be cuda[:N] or cpu, got {device}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and (device.type != "cuda" or not dist.is_nccl_available()):
        raise RuntimeError(f"the nccl backend needs a CUDA device and a torch built with "
                           f"NCCL (device {device}, nccl available: "
                           f"{dist.is_nccl_available()})")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the ('data', 'model') mesh: dp ranks on 'data',
    one on 'model'.  `staged`: tensors on the card cross the host at each
    collective (gloo on CUDA)."""
    dp: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    @property
    def staged(self) -> bool:
        return self.device.type == "cuda" and self.backend == "gloo"

    def divides(self, n: int) -> bool:
        """Whether a batch of n rows is sharded (else it runs replicated)."""
        return n % self.dp == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n (a multiple of dp) rows."""
        k = n // self.dp
        return slice(self.rank * k, (self.rank + 1) * k)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (every rank gets the answer)."""
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device="cpu" if self.backend == "gloo" else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


def make_mesh(dp: int = -1, tp: int = 1, device=None) -> Mesh:
    """The mesh of the process group's world.  dp = -1 uses every rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: init_distributed first "
                           "(or run under torchrun)")
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must divide the world size {n}")
    if dp == -1:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != world size {n}; start as many ranks as "
                         "the mesh has")
    if tp > 1:
        raise ValueError(f"tp={tp}: tensor parallelism is not ported yet (ROADMAP Queue 1 "
                         "item 2)")
    device = torch.device(device if device is not None else
                          "cuda" if dist.get_backend() == "nccl" else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp=dp, rank=dist.get_rank(), device=device)


def shard_batch(arrays: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a host batch (dict of arrays; None stays None),
    or the whole batch where its rows do not divide dp."""
    n = len(next(v for v in arrays.values() if v is not None))
    if not mesh.divides(n):
        return dict(arrays)
    rows = mesh.rows(n)
    return {k: None if v is None else v[rows] for k, v in arrays.items()}


def rank_seed(seed: int, rank: int, *tags: int) -> int:
    """A seed of its own for (seed, rank, *tags), the same on every run."""
    return int(np.random.SeedSequence([seed, rank, *tags]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


# ------------------------------------------------------------- collectives


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.cpu() if mesh.staged else t


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        buf = _host(_bytes(t.data), mesh)
        dist.broadcast(buf, src=0)
        if mesh.staged or buf.data_ptr() != t.data.data_ptr():
            t.data.copy_(buf.to(t.device).view(t.dtype).view(t.shape))
    return module


def _all_gather_rows(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each x (n rows, any dtype) gathered over the ranks along dim 0, in
    rank order: one all_gather of every x's bytes side by side."""
    n = xs[0].shape[0]
    cols = [x.contiguous().reshape(n, -1).view(torch.uint8) for x in xs]
    widths = [c.shape[1] for c in cols]
    local = _host(torch.cat(cols, dim=1) if len(cols) > 1 else cols[0], mesh)
    parts = [torch.empty_like(local) for _ in range(mesh.dp)]
    dist.all_gather(parts, local)
    whole = torch.cat(parts).to(xs[0].device)
    out = []
    for x, part in zip(xs, whole.split(widths, dim=1)):
        out.append(part.contiguous().view(x.dtype).reshape(mesh.dp * n, *x.shape[1:]))
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' rows concatenated.  Backward: this rank's slice of
    the incoming gradient, not reduced: every rank computes the same global
    objective from the gathered rows, so its gradient w.r.t. the gathered
    tensor is the same on every rank, and the rows' own slice is the
    objective's gradient w.r.t. this rank's outputs (a sum over ranks here
    would count it dp times)."""

    @staticmethod
    def forward(ctx, mesh: Mesh, *xs):
        ctx.mesh, ctx.n = mesh, xs[0].shape[0]
        return tuple(_all_gather_rows(mesh, xs))

    @staticmethod
    def backward(ctx, *grads):
        rows = slice(ctx.mesh.rank * ctx.n, (ctx.mesh.rank + 1) * ctx.n)
        return (None, *(None if g is None else g[rows] for g in grads))


def gather_rows(mesh: Mesh, *xs: torch.Tensor) -> tuple:
    """The tensors `xs` (the same number of rows on every rank) gathered
    along dim 0 in rank order, differentiable (`_GatherRows`)."""
    return _GatherRows.apply(mesh, *xs)


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum `grads` over the ranks, in place: consecutive gradients of one
    dtype flattened into buckets of up to GRAD_BUCKET_BYTES, one all_reduce
    a bucket."""
    def flush(bucket):
        flat = _host(torch.cat([g.reshape(-1) for g in bucket]), mesh)
        dist.all_reduce(flat)
        flat = flat.to(bucket[0].device)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))

    bucket: List[torch.Tensor] = []
    size = 0
    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype or size + g.numel() * g.element_size()
                       > GRAD_BUCKET_BYTES):
            flush(bucket)
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        flush(bucket)
