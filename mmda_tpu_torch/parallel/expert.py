"""Expert parallelism for the Switch MoE FFN, and MoE routing over 'data'.

Counterpart of `mmda_tpu/parallel/expert.py`.  The JAX package shards the
stacked expert weights on their leading E over 'model' and constrains the
dispatched (E, C, H) blocks to P('model', None, None); XLA then derives
GShard's all-to-all.  Within a 'model' row of the port every rank holds the
same tokens (tensor parallelism keeps the residual stream whole, sequence
parallelism gathers it first), so the all-to-all reduces to this
(`ops/moe.py::switch_ffn`):

* every rank routes all the tokens with the whole router (the same bits);
* rank m runs its experts m E / tp .. (m + 1) E / tp - 1 on their slots,
  from the tokens entering the dispatch through `copy_to_model` (each
  rank's experts give the tokens their part of the gradient, summed over
  'model');
* the experts' outputs are gathered over 'model' (`all_gather_model`, the
  gradient this rank's experts' slice, as every rank computes the same
  combine from them) and every rank combines in full.

So the router's gradient, from the combine and the aux losses every rank
computes whole, is whole on every rank, and each expert's is its owner's.

Data parallelism (`route_over_data`): a rank's batch is its rows of the
global batch, and the router's statistics are the global batch's, as the
JAX package computes them on the whole batch.  The aux losses are products
of global means, so the per-expert sums (first choices, router
probabilities), the z-loss sum and the kept routes are summed over 'data'
(`sum_over_data`, differentiable: each rank's gradient flows to its own
rows, as the data-parallel objective's does) before the products.  With
one routing group over the batch (G = 1) a token's queue position also
counts the lower ranks' tokens: the exclusive prefix of the per-expert
counts over 'data' (`data_prefix`), and a second choice queues after every
rank's first choices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmda_tpu_torch.parallel.mesh import Mesh, _all_gather_rows, gather_rows


@torch.no_grad()
def data_prefix(counts: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the sum of `counts` over the lower 'data' ranks, the sum over all of
    them): one all_gather, no gradient."""
    (rows,) = _all_gather_rows(mesh, [counts[None]])
    return rows[:mesh.dp_rank].sum(0), rows.sum(0)


def sum_over_data(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """v summed over the 'data' ranks, differentiable: every rank computes
    the same from the sum, so each takes its own row of the gradient."""
    return gather_rows(mesh, v[None])[0].sum(0)


def route_over_data(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Route every MoE BERT encoder of `model` over the global batch of the
    mesh's 'data' axis, in place: where each rank's batch is its rows of a
    batch split over 'data' (dp > 1).  Returns `model`."""
    from mmda_tpu_torch.models.bert import BertEncoder

    if mesh.dp == 1:
        return model
    for enc in model.modules():
        if isinstance(enc, BertEncoder) and enc.cfg.moe_experts > 0:
            enc.tp_mesh = mesh
            enc.routes_over_data = True
    return model
