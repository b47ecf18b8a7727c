"""Carry the JAX package's parameters across into the port's modules.

The JAX tree (`mmda_tpu.models.misa.init_misa_params`, or a best-on-dev
export read by `train/checkpoint.py`) maps leaf by leaf onto the port's
parameter names:

* `.../kernel` (in, out)   -> `.../weight` (out, in), transposed
  (linear layers, BERT denses, the fusion layer's in/out projections);
* `.../scale`              -> `.../weight` (LayerNorms);
* every other leaf keeps its name: biases, LSTM `w_ih`/`w_hh`/`b_ih`/`b_hh`
  (already in torch layout), BERT embedding tables, the GloVe table.

Lists (BERT layers) flatten by index; a fastser file's '0', '1', ... keys
flatten the same way.  Any leaf the port has no parameter for, any port
parameter left unfilled, and any shape mismatch raise.  `to_jax_tree` is
the inverse, for the checkpoints the port's trainer writes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{'a.b.0.c': leaf} over nested dicts and lists."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def to_tensor(leaf: Any) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) or torch leaf -> torch tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def port_name(path: str) -> str:
    head, _, leaf = path.rpartition(".")
    if leaf in ("kernel", "scale"):
        return head + _ + "weight"
    return path


def convert_params(tree: Any, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port state dict for `model` from a JAX parameter tree."""
    targets = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    extra = []
    for path, leaf in flatten_tree(tree).items():
        name = port_name(path)
        if name not in targets:
            extra.append(path)
            continue
        value = to_tensor(leaf)
        if path.rpartition(".")[2] == "kernel":
            value = value.t()
        if tuple(value.shape) != tuple(targets[name].shape):
            raise ValueError(f"leaf {path!r} has shape {tuple(value.shape)}, port "
                             f"parameter {name!r} needs {tuple(targets[name].shape)}")
        out[name] = value.contiguous()
    missing = sorted(set(targets) - set(out))
    if extra or missing:
        raise ValueError(f"parameter trees do not match: JAX leaves with no port "
                         f"parameter {extra}; port parameters not filled {missing}")
    return out


def load_jax_params(model: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX parameter tree into `model` (cast to its dtypes); returns it."""
    model.load_state_dict(convert_params(tree, model), strict=True)
    return model


def jax_name(model: nn.Module, name: str) -> str:
    """The JAX leaf path of port parameter `name`: a linear layer's weight
    is its `kernel`, a LayerNorm's its `scale`; other names are kept."""
    from mmda_tpu_torch.models.bert import Dense
    from mmda_tpu_torch.models.common import LayerNorm, Linear

    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        owner = model.get_submodule(head)
        if isinstance(owner, (Linear, Dense)):
            return head + ".kernel"
        if isinstance(owner, LayerNorm):
            return head + ".scale"
    return name


def jax_leaves(model: nn.Module, tensors: Optional[List[torch.Tensor]] = None
               ) -> List[Tuple[str, torch.Tensor]]:
    """(JAX leaf path, host copy) of each of `model`'s parameters, or of
    `tensors` in their place (same order: the EMA shadow), a linear layer's
    weight transposed back to the JAX (in, out) kernel."""
    out = []
    for i, (name, p) in enumerate(model.named_parameters()):
        path = jax_name(model, name)
        value = (p if tensors is None else tensors[i]).detach().to("cpu", copy=True)
        if path.endswith(".kernel"):
            value = value.t().contiguous()
        out.append((path, value))
    return out


def to_jax_tree(model: nn.Module, tensors: Optional[List[torch.Tensor]] = None
                ) -> Dict[str, Any]:
    """The inverse of `convert_params`: the model's parameters (or
    `tensors`, as `jax_leaves`) as the JAX package's nested tree, copies on
    the CPU.  List entries (BERT layers) are dicts keyed '0', '1', ..., the
    form a fastser checkpoint stores them in."""
    tree: Dict[str, Any] = {}
    for path, value in jax_leaves(model, tensors):
        parts = path.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree
