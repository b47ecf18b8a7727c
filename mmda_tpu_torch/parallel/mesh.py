"""The ('data', 'model') mesh over `torch.distributed`: data and tensor
parallelism.

Counterpart of `mmda_tpu/parallel/mesh.py`.  The JAX
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
  and dp * tp must equal the world size.  Ranks lie as the JAX mesh lays
  its devices out (`mmda_tpu/parallel/mesh.py:92-95`): rank = d * tp + m,
  'model' innermost.  Each rank holds a `torch.distributed` group for its
  'data' column (the ranks m, tp + m, ...) and one for its 'model' row (d
  tp .. d tp + tp - 1), every group made on every rank in the same order.
* `shard_batch` takes a rank's contiguous rows [d B / dp, (d + 1) B / dp) of
  a host batch (d its 'data' coordinate), and leaves a batch whose B does
  not divide dp whole: the JAX trainer runs such a batch replicated.
* `replicated` broadcasts a module's parameters and buffers from rank 0.

Tensor parallelism is Megatron's, as `_bert_layer_spec` shards the JAX
BERT (`mmda_tpu/parallel/mesh.py:232-298`): `param_partition_specs` names
the dim of each BERT leaf split over 'model' in the port's (out, in)
layout (q, k, v and ffn_in column-parallel: dim 0 of `weight`, `weight_q`,
`scale` and `bias`; attn_out and ffn_out row-parallel: dim 1 of `weight`
and `weight_q`, their bias and scale whole; everything else whole),
`shard_params` keeps each rank's block of them in place, and
`gather_params` puts the blocks back together (checkpoints hold the full
layout).  In the forward (`models/bert.py`) `copy_to_model` and
`reduce_from_model` are Megatron's f and g: the identity with the gradient
summed over 'model', and the sum over 'model' with the gradient passed
through.  Gradients are summed over 'data' only (`all_reduce_grads`): a
rank of a 'model' row holds its own block of a sharded parameter and the
same whole parameters and gradients as the rest of its row.  A MoE layer's
experts shard on their leading E (the JAX package's 'moe' case): rank m of
a row holds experts m E / tp .. (m + 1) E / tp - 1, the router whole
(`parallel/expert.py`).

Sequence parallelism (`parallel/sequence.py`) adds Megatron-SP's pairs
along a dim, over 'model': `split_model` (this rank's chunk, its gradient
gathered), `all_gather_model` (the chunks joined; the gradient
reduce-scattered, or with grad="slice" this rank's chunk of it, for work
every rank of the row computes whole and alike) and `reduce_scatter_model`
(the sum over 'model' of f32 parts, this rank's chunk of it; the gradient
gathered).  `sum_grads_over_model` is the identity on parameters that are
whole on every rank but see only its rows, with their gradients summed over
'model' in one collective.  Under gloo a reduce-scatter is an all_reduce and
this rank's chunk of it (every gloo build has those); nccl runs
`reduce_scatter_tensor`.

The collectives are `all_reduce`, `all_gather`, `broadcast` and `barrier`
(and nccl's `reduce_scatter_tensor`), each over the world or one axis's
group.  `all_gather` and `broadcast` move bytes (a `uint8` view), so every
backend takes every dtype; the sums are in the tensors' own dtype.  Over
an axis of one rank they move nothing.
"""

from __future__ import annotations

import datetime
import gc
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

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


def leave_process_group() -> None:
    """`destroy_process_group`, once no CUDA graph holds a collective: a
    graph that captured one keeps its nccl communicator, whose teardown
    then waits for it without end.  The caller drops its last reference to
    what holds graphs (a `Trainer`, a `Predictor`); this collects what only
    reference cycles still keep (a Predictor's graphs are reachable from
    their own body) and waits for the card before destroying the group."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the ('data', 'model') mesh: dp ranks on 'data', tp
    on 'model'; `data_group` and `model_group` the groups of this rank's
    'data' column and 'model' row (None: the world, where that axis is all
    of it).  `staged`: tensors on the card cross the host at each collective
    (gloo on CUDA)."""
    dp: int
    rank: int
    device: torch.device
    tp: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def dp_rank(self) -> int:
        """This rank's coordinate on 'data'."""
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on 'model'."""
        return self.rank % self.tp

    def __deepcopy__(self, memo):
        return self                 # a copied module shares its mesh (and its groups)

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
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)

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
    """The mesh of the process group's world.  dp = -1 uses every rank.
    Every rank must call it (it makes the axes' groups) in the same order."""
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
    device = torch.device(device if device is not None else
                          "cuda" if dist.get_backend() == "nccl" else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    data_group = model_group = None
    if tp > 1:          # every rank makes every group, columns then rows, in order
        for m in range(tp):
            group = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                data_group = group
        for d in range(dp):
            group = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model_group = group
    return Mesh(dp=dp, rank=rank, device=device, tp=tp, data_group=data_group,
                model_group=model_group)


def check_tp(tp: int, num_heads: int, intermediate_size: int, moe_experts: int = 0) -> None:
    """Raises ValueError unless tp divides the heads, the FFN width and
    (expert parallelism) the experts."""
    if num_heads % tp or intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide num_heads={num_heads} and "
                         f"intermediate_size={intermediate_size}")
    check_experts(tp, moe_experts)


def check_experts(tp: int, moe_experts: int) -> None:
    """Raises the JAX trainer's ValueError unless tp divides the experts."""
    if moe_experts % tp:
        raise ValueError(f"moe_experts={moe_experts} must be divisible by tp_size={tp} for "
                         "expert parallelism")


def shard_batch(arrays: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a host batch (dict of arrays; None stays None),
    or the whole batch where its rows do not divide dp."""
    n = len(next(v for v in arrays.values() if v is not None))
    if not mesh.divides(n):
        return dict(arrays)
    rows = mesh.rows(n)
    return {k: None if v is None else v[rows] for k, v in arrays.items()}


def rank_seed(seed: int, rank: int, *tags: int) -> int:
    """A seed of its own for (seed, rank, *tags), the same on every run.
    The trainer passes a rank's 'data' coordinate: the ranks of a 'model'
    row hold the same activations and draw the same dropout."""
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
    """Each x (n rows, any dtype) gathered over the 'data' ranks along dim
    0, in rank order: one all_gather of every x's bytes side by side."""
    n = xs[0].shape[0]
    cols = [x.contiguous().reshape(n, -1).view(torch.uint8) for x in xs]
    widths = [c.shape[1] for c in cols]
    local = _host(torch.cat(cols, dim=1) if len(cols) > 1 else cols[0], mesh)
    parts = [torch.empty_like(local) for _ in range(mesh.dp)]
    dist.all_gather(parts, local, group=mesh.data_group)
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
        rows = slice(ctx.mesh.dp_rank * ctx.n, (ctx.mesh.dp_rank + 1) * ctx.n)
        return (None, *(None if g is None else g[rows] for g in grads))


def gather_rows(mesh: Mesh, *xs: torch.Tensor) -> tuple:
    """The tensors `xs` (the same number of rows on every rank) gathered
    over 'data' along dim 0 in rank order, differentiable (`_GatherRows`)."""
    if mesh.dp == 1:
        return xs
    return _GatherRows.apply(mesh, *xs)


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum `grads` over 'data', in place: consecutive gradients of one
    dtype flattened into buckets of up to GRAD_BUCKET_BYTES, one all_reduce
    a bucket."""
    if mesh.dp == 1:
        return

    def flush(bucket):
        flat = _host(torch.cat([g.reshape(-1) for g in bucket]), mesh)
        dist.all_reduce(flat, group=mesh.data_group)
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


# ------------------------------------------------------ tensor parallelism


def _all_reduce_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over this rank's 'model' row (a new tensor)."""
    flat = _host(x.contiguous(), mesh).clone()
    dist.all_reduce(flat, group=mesh.model_group)
    return flat.to(x.device)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity, the gradient summed over 'model' (each
    rank's column-parallel products see the whole input and give it their
    part of its gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_model(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over 'model' of the row-parallel products'
    parts, the gradient passed through (it is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_model(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """f before a column-parallel product: x, its gradient summed over
    'model' (x itself without tensor parallelism)."""
    return x if mesh is None or mesh.tp == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """g after a row-parallel product: x summed over 'model' (x itself
    without tensor parallelism)."""
    return x if mesh is None or mesh.tp == 1 else _ReduceFromModel.apply(x, mesh)


@torch.no_grad()
def sum_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over 'model', outside autograd (a norm's squares)."""
    return x if mesh.tp == 1 else _all_reduce_model(x, mesh)


def _chunk(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_rank * n, n)


def _reduce_scatter_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk along `dim` of x summed over 'model' (a new
    tensor): nccl's reduce_scatter_tensor, else an all_reduce and the
    chunk."""
    if mesh.backend != "nccl":
        return _chunk(_all_reduce_model(x, mesh), dim, mesh).contiguous()
    lead = x.movedim(dim, 0).contiguous()
    out = lead.new_empty((lead.shape[0] // mesh.tp, *lead.shape[1:]))
    dist.reduce_scatter_tensor(out, lead, group=mesh.model_group)
    return out.movedim(0, dim).contiguous()


class _SplitModel(torch.autograd.Function):
    """This rank's chunk along a dim of a tensor every rank holds alike; the
    gradient: the ranks' chunks' gradients gathered."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _chunk(x, dim, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_tensors([g], [ctx.dim], ctx.mesh)[0], None, None


class _AllGatherModel(torch.autograd.Function):
    """The ranks' chunks joined along a dim.  The gradient: summed over
    'model' and this rank's chunk of it (each rank's products read the whole
    tensor and give it their part of its gradient), or with `slice` only
    this rank's chunk (every rank computes the same from the whole tensor,
    so its gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, slice_grad):
        ctx.mesh, ctx.dim, ctx.slice_grad = mesh, dim, slice_grad
        return gather_tensors([x], [dim], mesh)[0]

    @staticmethod
    def backward(ctx, g):
        if ctx.slice_grad:
            return _chunk(g, ctx.dim, ctx.mesh).contiguous(), None, None, None
        return _reduce_scatter_model(g, ctx.dim, ctx.mesh), None, None, None


class _ReduceScatterModel(torch.autograd.Function):
    """This rank's chunk of the sum over 'model' of the ranks' parts; the
    gradient: the ranks' chunks' gradients gathered."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _reduce_scatter_model(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return gather_tensors([g], [ctx.dim], ctx.mesh)[0], None, None


def split_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's chunk of x along `dim` (tp divides it), its gradient
    gathered over 'model'."""
    return _SplitModel.apply(x, mesh, dim)


def all_gather_model(x: torch.Tensor, mesh: Mesh, dim: int, grad: str = "reduce_scatter"
                     ) -> torch.Tensor:
    """The ranks' x joined along `dim` in 'model' order.  grad:
    "reduce_scatter" (the gradient summed over 'model', this rank's chunk)
    or "slice" (this rank's chunk of it)."""
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"grad must be reduce_scatter or slice, got {grad!r}")
    return _AllGatherModel.apply(x, mesh, dim, grad == "slice")


def reduce_scatter_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` of x summed over 'model', the gradient
    gathered."""
    return _ReduceScatterModel.apply(x, mesh, dim)


class _SumGradsOverModel(torch.autograd.Function):
    """The identity on each tensor; their gradients summed over 'model' in
    one all_reduce."""

    @staticmethod
    def forward(ctx, mesh, *ts):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        present = [g for g in grads if g is not None]
        if not present:
            return (None, *grads)
        flat = _all_reduce_model(torch.cat([g.reshape(-1) for g in present]), ctx.mesh)
        parts = iter(flat.split([g.numel() for g in present]))
        return (None, *(None if g is None else next(parts).view_as(g) for g in grads))


def sum_grads_over_model(mesh: Mesh, *ts: torch.Tensor) -> tuple:
    """`ts` themselves, their gradients summed over 'model' (parameters whole
    on every rank that see only its rows, one dtype)."""
    return _SumGradsOverModel.apply(mesh, *ts)


COLUMN_PARALLEL = ("q", "k", "v", "ffn_in")
ROW_PARALLEL = ("attn_out", "ffn_out")
EXPERTS = ("w_in", "b_in", "w_out", "b_out")   # a SwitchFFN's E-leading leaves


def param_partition_specs(model: torch.nn.Module, tp: int) -> Dict[str, int]:
    """{parameter or buffer name: the dim split over 'model'} for every
    leaf that tensor parallelism shards (`_bert_layer_spec`'s rules in the
    port's (out, in) layout, module docstring; a MoE layer's experts on
    their leading E, the router whole); a name not in it is whole.  Empty
    at tp = 1."""
    from mmda_tpu_torch.models.bert import BertEncoder

    specs: Dict[str, int] = {}
    if tp == 1:
        return specs
    for prefix, module in model.named_modules():
        if not isinstance(module, BertEncoder):
            continue
        head = f"{prefix}." if prefix else ""
        for i, layer in enumerate(module.layers):
            if hasattr(layer, "moe"):
                specs.update({f"{head}layers.{i}.moe.{leaf}": 0 for leaf in EXPERTS})
            for name in COLUMN_PARALLEL + ROW_PARALLEL:
                dense = getattr(layer, name, None)
                if dense is None:
                    continue
                for leaf, _ in list(dense.named_parameters()) + list(dense.named_buffers()):
                    if name in COLUMN_PARALLEL:
                        specs[f"{head}layers.{i}.{name}.{leaf}"] = 0
                    elif leaf in ("weight", "weight_q"):
                        specs[f"{head}layers.{i}.{name}.{leaf}"] = 1
    return specs


def shard_tensor(name: str, t: torch.Tensor, specs: Dict[str, int], mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full-layout tensor `t` of leaf `name` (`t`
    itself for a whole leaf)."""
    return _chunk(t, specs[name], mesh).contiguous() if name in specs else t


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's block of every sharded leaf, in place (the same
    Parameter objects, each sharded one given the mesh as its `tp_mesh`:
    `train/step.py::global_grad_norm` reads it), and give each BERT encoder
    the mesh its forward runs on (`models/bert.py`); tp must divide each
    encoder's heads, FFN width and experts.  A model on the meta device
    takes its shapes.  Returns `model`."""
    from mmda_tpu_torch.models.bert import BertEncoder

    if mesh.tp == 1:
        return model
    for module in model.modules():
        if isinstance(module, BertEncoder):
            check_tp(mesh.tp, module.cfg.num_heads, module.cfg.intermediate_size,
                     module.cfg.moe_experts)
            module.tp_mesh = mesh
    for name, dim in param_partition_specs(model, mesh.tp).items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        if leaf in module._parameters:
            param = module._parameters[leaf]
            param.data = _chunk(param.data, dim, mesh).contiguous()
            param.tp_mesh = mesh
        else:
            module._buffers[leaf] = _chunk(module._buffers[leaf], dim, mesh).contiguous()
    return model


@torch.no_grad()
def gather_tensors(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                   mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor whole: the blocks of a sharded one (dims[i] not None)
    gathered over this rank's 'model' row and joined along its dim, the
    rest as they are.  A collective over the row: one all_gather of every
    block's bytes side by side."""
    out = list(tensors)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    if mesh.tp == 1 or not sharded:
        return out
    flat = [tensors[i].contiguous().reshape(-1).view(torch.uint8) for i in sharded]
    local = _host(torch.cat(flat), mesh)
    parts = [torch.empty_like(local) for _ in range(mesh.tp)]
    dist.all_gather(parts, local, group=mesh.model_group)
    split = [p.to(tensors[sharded[0]].device).split([f.numel() for f in flat]) for p in parts]
    for j, i in enumerate(sharded):
        t = tensors[i]
        out[i] = torch.cat([split[r][j].view(t.dtype).reshape(t.shape) for r in range(mesh.tp)],
                           dim=dims[i])
    return out


def gather_params(model: torch.nn.Module, mesh: Mesh,
                  tensors: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """`model`'s parameters (or `tensors` in their place, in
    `named_parameters` order: the EMA shadow) in the full layout, the
    inverse of `shard_params` (a collective over the 'model' row)."""
    specs = param_partition_specs(model, mesh.tp)
    named = list(model.named_parameters())
    values = [p.detach() for _, p in named] if tensors is None else list(tensors)
    return gather_tensors(values, [specs.get(n) for n, _ in named], mesh)


def local_blocks(model: torch.nn.Module, mesh: Optional[Mesh]):
    """For loading a full-layout checkpoint into `model` on `mesh`:
    (name, full tensor) -> this rank's block of it (`shard_tensor`); None
    where nothing is sharded."""
    specs = {} if mesh is None else param_partition_specs(model, mesh.tp)
    return (lambda name, t: shard_tensor(name, t, specs, mesh)) if specs else None
