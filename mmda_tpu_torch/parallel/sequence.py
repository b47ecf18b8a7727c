"""Sequence parallelism (Megatron-SP) for a tensor-parallel BERT encoder.

Counterpart of `mmda_tpu/parallel/sequence.py`.  The JAX package constrains
the residual stream (B, S, H) to P('data', 'model', None) after the
embedding's dropout and after every encoder layer, and XLA derives the
Megatron-SP collectives from that and the TP weight shardings.  The port
places them by hand (`models/bert.py`): between the attention and FFN
blocks each rank of a 'model' row holds only its S-shard of the stream,
B x S_local rows, and runs the residual adds, the dropout and the LayerNorms
on them alone; each block gathers S before its column-parallel products
(`gather_from_sequence`, its gradient reduce-scattered) and reduce-scatters
the f32 parts of its row-parallel product (`reduce_scatter_to_sequence`, its
gradient gathered) instead of summing them whole.

When tp does not divide S the shards hold S_local = ceil(S / tp) rows, the
last one padded with zeros: the gathers cut the padding off, so no padded
row reaches attention, the pooled output, a loss or a gradient (the JAX
package takes any S; XLA pads).

`shard_sequence(model)` turns SP on for every BERT encoder of a model that
`parallel/mesh.py::shard_params` sharded (the encoder's `tp_mesh` is the
one mesh it names), as `install_sequence_sharding` does for the JAX BERT.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mmda_tpu_torch.parallel.mesh import (Mesh, all_gather_model, reduce_scatter_model,
                                          split_model)


def sequence_rows(S: int, mesh: Mesh) -> Tuple[int, int]:
    """(S_local, s0): this rank's shard of a sequence of S, rows s0 ..
    s0 + S_local - 1 (those past S are padding)."""
    s_local = -(-S // mesh.tp)
    return s_local, mesh.tp_rank * s_local


def _padded(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x (B, S, ...) with zero rows appended along S up to tp * S_local."""
    pad = sequence_rows(x.shape[1], mesh)[0] * mesh.tp - x.shape[1]
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's S-shard of x (B, S, ...), padded, outside autograd's
    collectives (a mask every rank draws whole)."""
    s_local, s0 = sequence_rows(x.shape[1], mesh)
    return _padded(x, mesh).narrow(1, s0, s_local)


def scatter_to_sequence(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's S-shard (B, S_local, ...) of x (B, S, ...), which every
    rank of the row holds alike; the gradient gathered over 'model'."""
    return split_model(_padded(x, mesh), mesh, 1)


def gather_from_sequence(x: torch.Tensor, mesh: Mesh, S: int,
                         grad: str = "reduce_scatter") -> torch.Tensor:
    """The whole (B, S, ...) from the ranks' shards x (B, S_local, ...).
    grad "reduce_scatter": before column-parallel products (each rank's
    part of the gradient summed); "slice": before work every rank computes
    whole and alike (the encoder's output, the injection hook, the MoE
    router)."""
    return all_gather_model(x, mesh, 1, grad).narrow(1, 0, S)


def reduce_scatter_to_sequence(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's S-shard of the sum over 'model' of the ranks' parts x
    (B, S, ...) of a row-parallel product; the gradient gathered."""
    return reduce_scatter_model(_padded(x, mesh), mesh, 1)


def shard_sequence(model: torch.nn.Module) -> torch.nn.Module:
    """Turn sequence parallelism on for every BERT encoder of `model`, in
    place; each must be tensor-parallel (`shard_params` at tp > 1).
    Returns `model`."""
    from mmda_tpu_torch.models.bert import BertEncoder

    encoders = [m for m in model.modules() if isinstance(m, BertEncoder)]
    for enc in encoders:
        if enc.tp_mesh is None or enc.tp_mesh.tp == 1:
            raise ValueError("sp=True needs tp_size > 1 (S is sharded over the TP 'model' "
                             "axis)")
        enc.sequence_parallel = True
    return model
