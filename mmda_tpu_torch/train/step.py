"""One training step and one eval step, eager or captured.

Counterpart of `mmda_tpu/train/step.py` (`make_train_step`,
`_make_eval_body`, `make_train_epoch`, `make_eval_epoch`).  A step is a
function over the model, the optimizer and a batch already on the device;
its results stay on the device until the caller reads them (the trainer
reads an epoch's losses in one copy).

* `train_step`: modality-keep sampling (train-time random modality dropout
  on top of the static `missing_modality` setting), the forward with
  dropout on, the objective, the gradients of the trainable parameters (the
  frozen ones have requires_grad False, so autograd computes no weight
  gradient for them, as `_stop_frozen` prunes them in JAX), `grad_norm` over
  those gradients before the clip, the optimizer update, the EMA shadow.
* `eval_step`: the deterministic forward with the static modality setting,
  and the same outputs as `_make_eval_body`.

`conf_only=True` is `make_train_step(conf_only=True)`, ConfidNet's stage 2:
the gradient of `losses["conf"]` alone, over the optimizer's parameters (the
trainer hands it the confidence head's; every other parameter has
requires_grad False, so autograd builds no backward through the backbone and
the recurrences take their forward-only path).  With grad_accum_steps > 1 a
step is a mini-step (`Optimizer.advance` says whether it applies); grad_norm
is the mini-batch gradient's and the EMA shadow moves every mini-step, as
in the JAX step.

Under a data-parallel mesh (`mesh`, `parallel/mesh.py`) `batch` is this
rank's rows of a global batch whose rows divide dp, and a step is the
one-process step at the global batch up to summation order, as XLA's SPMD
step is in the JAX package: the modality-keep mask is drawn at the global
batch size from `generator` (the same on every rank) and this rank's rows
taken; the forward runs on the rank's rows with its dropout from
`dropout_generator` (the rank's own, so that no two ranks drop alike); the
output tensors the objective reads and the batch's labels and weights are
gathered over the ranks (`gather_rows`), every rank computes the objective
on the global tensors, and after the backward the gradients are summed over
the ranks (`all_reduce_grads`) before grad_norm, the clip and the update.
The optimizer state and the EMA shadow stay replicated.  A batch whose rows
do not divide dp runs whole on every rank with mesh=None and one generator
for everything, with no reduction, as the JAX trainer runs it replicated.
An eval step under a mesh gathers its outputs the same way, so every rank
returns the global batch's.

`make_train_graph` and `make_eval_graph` are the counterparts of the JAX
package's scanned epoch and eval (`compiled_epoch`, `compiled_eval`): one
`StepGraphs` each, which runs the same body over device buffers kept for
each batch shape (and, for training with grad_accum_steps > 1, for each
of the optimizer's two kinds of mini-step).  On CUDA the first batch of a
shape runs it eagerly (the
warm-up: kernels built, allocator, autograd and cuBLAS warm), and the body
is then captured over those buffers as a CUDA graph (a capture runs
nothing); every later batch is copied into the buffers and replayed, one
launch for some 3,700 device ops.  The graph reads
every value that changes between steps from device memory: the parameters,
moments and EMA shadow updated in place, the optimizer's scalars
(`Optimizer.advance`, on the host before each replay), and the trainer's
generator (registered with the graph, so a replay draws what an eager step
from the same state draws).  A capture that fails raises: nothing falls
back.  `scan_chunk` has no counterpart: a replay is one step.  On the CPU
there is no graph: the body runs over the same buffers every time.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mmda_tpu_torch.data.loader import StaticBatch, batch_shape
from mmda_tpu_torch.ops import losses as L
from mmda_tpu_torch.ops.kernels import _launch
from mmda_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, gather_rows
from mmda_tpu_torch.train.objective import OUTPUT_FIELDS, compute_losses


def static_modality_keep(cfg, batch_size: int, device) -> Optional[torch.Tensor]:
    """(B, 3) keep mask of the static missing_modality setting, or None."""
    if cfg.missing_modality == "none":
        return None
    keep = torch.ones(batch_size, 3, device=device)
    if cfg.missing_modality in ("visual", "both"):
        keep[:, 1] = 0.0
    if cfg.missing_modality in ("acoustic", "both"):
        keep[:, 2] = 0.0
    return keep


def sample_modality_keep(cfg, batch_size: int, device,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[torch.Tensor]:
    """With probability missing_modality_prob, zero the visual and the
    acoustic stream of each example independently; text is always kept."""
    static = static_modality_keep(cfg, batch_size, device)
    if cfg.missing_modality_prob <= 0.0:
        return static
    u = torch.rand(2, batch_size, generator=generator, device=device)
    keep_va = (u < 1.0 - cfg.missing_modality_prob).float()
    keep = torch.stack([torch.ones(batch_size, device=device), keep_va[0], keep_va[1]],
                       dim=1)
    return keep if static is None else keep * static


def ema_update(ema: Optional[List[torch.Tensor]], params: List[torch.Tensor],
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    if not ema or decay <= 0.0:
        return
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, params, alpha=1.0 - decay)


def gather_batch(out, batch, mesh: Mesh, fields: Sequence[str] = OUTPUT_FIELDS):
    """(out, batch) with the output tensors named in `fields` and the
    batch's labels and weights gathered over the mesh's ranks, in one
    collective (the rest of `batch` stays this rank's rows)."""
    names = [f for f in fields if getattr(out, f) is not None]
    labels = ("emo_label", "sentiment", "sample_weight")
    gathered = gather_rows(mesh, *[getattr(out, f) for f in names],
                           *[getattr(batch, f) for f in labels])
    return (out._replace(**dict(zip(names, gathered))),
            batch._replace(**dict(zip(labels, gathered[len(names):]))))


def loss_and_grads(model, batch, cfg, params: List[torch.Tensor],
                   modality_keep: Optional[torch.Tensor] = None, recurrence=None,
                   generator: Optional[torch.Generator] = None, conf_only: bool = False,
                   mesh: Optional[Mesh] = None):
    """The objective of one forward in the model's current mode (dropout
    only under train()) and its gradients w.r.t. `params`: of
    losses["total"], or of losses["conf"] under conf_only.  A parameter no
    loss reaches (the sp discriminator) gets a zero gradient, as jax.grad
    gives it.  Under `mesh`: the objective of the gathered global batch and
    its gradient summed over the ranks (module docstring)."""
    out = model(batch, modality_keep, recurrence, generator)
    if mesh is not None:
        out, batch = gather_batch(out, batch, mesh)
    losses = compute_losses(cfg, out, batch)
    grads = torch.autograd.grad(losses["conf" if conf_only else "total"], params,
                                allow_unused=True, materialize_grads=True)
    if mesh is not None:
        all_reduce_grads(grads, mesh)
    return losses, grads


def train_step(model, optimizer, batch, cfg,
               generator: Optional[torch.Generator] = None,
               ema: Optional[List[torch.Tensor]] = None,
               recurrence=None, conf_only: bool = False, mesh: Optional[Mesh] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One update (a mini-step under grad_accum_steps > 1); returns the
    loss dict plus grad_norm, as 0-dim device tensors.  `ema` is the shadow
    of `model.parameters()` (same order).  `mesh`: `batch` is this rank's
    rows of the global batch (module docstring); `dropout_generator`
    (default `generator`) draws the forward's dropout."""
    optimizer.advance()
    return train_body(model, optimizer, batch, cfg, generator, ema, recurrence, conf_only,
                      mesh, dropout_generator)


def train_body(model, optimizer, batch, cfg,
               generator: Optional[torch.Generator] = None,
               ema: Optional[List[torch.Tensor]] = None,
               recurrence=None, conf_only: bool = False, mesh: Optional[Mesh] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """The device work of `train_step`, after `optimizer.advance()`: what a
    training graph captures."""
    model.train()
    n = batch.emo_label.shape[0]
    dp = 1 if mesh is None else mesh.dp
    keep = sample_modality_keep(cfg, n * dp, batch.emo_label.device, generator)
    if keep is not None and mesh is not None:
        keep = keep[mesh.rows(n * dp)]
    losses, grads = loss_and_grads(model, batch, cfg, optimizer.params, keep, recurrence,
                                   dropout_generator or generator, conf_only, mesh)
    grad_norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))
    optimizer.apply(grads)
    if ema:
        ema_update(ema, [p.detach() for p in model.parameters()], cfg.ema_decay)
    result = {k: v.detach() for k, v in losses.items()}
    result["grad_norm"] = grad_norm
    return result


@torch.no_grad()
def eval_step(model, batch, cfg, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Deterministic forward: scores, labels, tcp, the batch's cls loss and
    the per-example (per-class) loss the trainer averages over real rows;
    under `mesh` of the global batch, from this rank's rows."""
    model.eval()
    keep = static_modality_keep(cfg, batch.emo_label.shape[0], batch.emo_label.device)
    out = model(batch, keep)
    if mesh is not None:
        out, batch = gather_batch(out, batch, mesh, ("scores", "labels", "tcp"))
    if cfg.resolved_task() == "regression":
        err = torch.abs(out.scores[:, 0] - batch.sentiment)
        cls_loss = err.mean()
        bce = err[:, None]
    else:
        cls_loss = L.bce_sum_over_classes(out.scores, batch.emo_label)
        p, t = out.scores.float(), batch.emo_label.float()
        bce = -(t * L.log_clamped(p) + (1.0 - t) * L.log_clamped(1.0 - p))
    return {"scores": out.scores, "labels": out.labels, "tcp": out.tcp,
            "cls_loss": cls_loss, "bce": bce}


Outputs = Dict[str, torch.Tensor]


class StepGraphs:
    """`body(batch) -> dict of tensors` over `StaticBatch` buffers, one set
    per batch shape, captured and replayed on CUDA (module docstring).
    `prepare()` is the host work that precedes every run of the body (the
    optimizer's `advance`); what it returns joins the batch shape in the
    key of a graph (the optimizer's `emit`: whether the body applies the
    update or only accumulates), so each kind of run is warmed up and
    captured on its own; `generators` are the generators the body draws
    from; `pool` a memory pool the graphs share (`graph_pool`; None: one of
    their own).  A call returns the body's outputs: on CUDA a replay's are
    the graph's own tensors, overwritten by the next replay (of any graph in
    the pool), so read or clone them first."""

    def __init__(self, body: Callable[[object], Outputs], device,
                 prepare: Optional[Callable[[], object]] = None,
                 generators: Sequence[torch.Generator] = (), pool=None):
        self.body = body
        self.device = torch.device(device)
        self.prepare = prepare or (lambda: None)
        self.generators = tuple(g for g in generators if g is not None)
        self.pool = pool
        self.buffers: Dict[tuple, StaticBatch] = {}
        # (shape, prepare's result) -> (graph, outputs, launches)
        self.graphs: Dict[tuple, tuple] = {}

    def __call__(self, arrays: Dict[str, Optional[np.ndarray]]) -> Outputs:
        shape = batch_shape(arrays)
        static = self.buffers.get(shape)
        if static is None:
            static = self.buffers[shape] = StaticBatch(arrays, self.device)
        batch = static.load(arrays)
        key = (shape, self.prepare())
        if self.device.type != "cuda":
            return self.body(batch)
        if key not in self.graphs:              # the warm-up, then the capture
            outputs = self.body(batch)
            self.graphs[key] = self._capture(batch)
            return outputs
        graph, outputs, launches = self.graphs[key]
        graph.replay()
        _launch.add_launches(launches)
        return outputs

    def _capture(self, batch) -> tuple:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with _launch.recording() as launches:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.body(batch)
        return graph, outputs, dict(launches)


def graph_pool(device):
    """One memory pool for every graph of a trainer or a Predictor (their
    replays never overlap and each one's outputs are read before the next);
    None off CUDA."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def make_train_graph(model, optimizer, cfg, device,
                     generator: Optional[torch.Generator] = None,
                     ema: Optional[List[torch.Tensor]] = None, pool=None,
                     mesh: Optional[Mesh] = None,
                     dropout_generator: Optional[torch.Generator] = None) -> StepGraphs:
    """Training steps as `StepGraphs` over `train_body`: each call takes a
    host batch (this rank's rows under `mesh`) and returns `train_step`'s
    dict.  Under `mesh` a capture records the step's collectives (nccl)."""
    generators = (generator,) if dropout_generator in (None, generator) else (
        generator, dropout_generator)
    return StepGraphs(lambda b: train_body(model, optimizer, b, cfg, generator, ema,
                                           mesh=mesh, dropout_generator=dropout_generator),
                      device, optimizer.advance, generators, pool)


def make_eval_graph(model, cfg, device, pool=None, mesh: Optional[Mesh] = None) -> StepGraphs:
    """Eval steps as `StepGraphs` over `eval_step`: each call takes a host
    batch (this rank's rows under `mesh`) and returns its dict."""
    return StepGraphs(lambda b: eval_step(model, b, cfg, mesh), device, pool=pool)
