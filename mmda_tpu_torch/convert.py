"""Carry the JAX package's parameters across into the port's modules.

The JAX tree of any registered family (`mmda_tpu.models.misa.init_misa_params`,
the zoo's `init_*_params`: EF_LSTM's `fused_extractor` and heads, the pooled
families' `enc_t`/`enc_v`/`enc_a`, LMF's factors and fusion bias, TFN's
`post_*` and `fusion`, MULT's conv projections and attention stacks,
MAG_BERT's `mag` gate, MMIM's MI estimators; or a best-on-dev export read
by `train/checkpoint.py`) maps leaf by leaf onto the port's parameter names:

* `.../kernel` (in, out)   -> `.../weight` (out, in), transposed
  (linear layers, BERT denses, the fusion layer's in/out projections);
* `.../kernel` (width, in, out) -> `.../weight` (out, in, width), the axes
  reversed (MULT's `proj_t` / `proj_v` / `proj_a` temporal convolutions);
* `.../scale`              -> `.../weight` (LayerNorms);
* `.../moe/gate/kernel`    -> `.../moe.gate`, not transposed (a MoE layer's
  router is (H, E) in both packages, as are its E-leading expert weights);
* every other leaf keeps its name: biases, LSTM `w_ih`/`w_hh`/`b_ih`/`b_hh`
  (already in torch layout), BERT embedding tables, the GloVe table, LMF's
  (R, H+1, H) factors.

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


def to_port_layout(kernel: torch.Tensor) -> torch.Tensor:
    """A JAX `kernel` in the port's `weight` layout: a dense (in, out)
    transposed, a conv (width, in, out) with its axes reversed.  Its own
    inverse."""
    return kernel.permute(*reversed(range(kernel.dim())))


ROUTER = ".moe.gate"       # a MoE layer's router: the JAX `moe.gate.kernel`, (H, E) in both


def port_name(path: str) -> str:
    head, _, leaf = path.rpartition(".")
    if head.endswith(ROUTER) and leaf == "kernel":
        return head
    if leaf in ("kernel", "scale"):
        return head + _ + "weight"
    return path


def transposed(path: str) -> bool:
    """Whether the JAX leaf at `path` is stored transposed in the port."""
    return path.rpartition(".")[2] == "kernel" and not path.endswith(ROUTER + ".kernel")


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
        if transposed(path):
            value = to_port_layout(value)
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
    is its `kernel` (a conv's too), a LayerNorm's its `scale`; other names
    are kept."""
    from mmda_tpu_torch.models.bert import Dense
    from mmda_tpu_torch.models.common import Conv1d, LayerNorm, Linear

    if name.endswith(ROUTER):
        return name + ".kernel"
    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        owner = model.get_submodule(head)
        if isinstance(owner, (Linear, Dense, Conv1d)):
            return head + ".kernel"
        if isinstance(owner, LayerNorm):
            return head + ".scale"
    return name


def jax_leaves(model: nn.Module, tensors: Optional[List[torch.Tensor]] = None
               ) -> List[Tuple[str, torch.Tensor]]:
    """(JAX leaf path, host copy) of each of `model`'s parameters, or of
    `tensors` in their place (same order: the EMA shadow), a linear layer's
    weight transposed back to the JAX (in, out) kernel, a conv's to
    (width, in, out)."""
    out = []
    for i, (name, p) in enumerate(model.named_parameters()):
        path = jax_name(model, name)
        value = (p if tensors is None else tensors[i]).detach()
        if transposed(path):              # transposed where it lives: on the card, fast
            value = to_port_layout(value).contiguous()
        out.append((path, value.to("cpu", copy=True)))
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
