"""Core ops: activation registry, gradient reversal, binarizer, masked mean.

Counterpart of `mmda_tpu/ops/functions.py`, with the same PyTorch-default
hyper-parameters (LeakyReLU slope 0.01, ELU alpha 1.0; PReLU/RReLU in their
deterministic-inference forms).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _hardshrink(x, lambd=0.5):
    return torch.where(x.abs() > lambd, x, torch.zeros_like(x))


def _hardtanh(x, min_val=-1.0, max_val=1.0):
    return x.clamp(min_val, max_val)


ACTIVATION_FNS = {
    "elu": F.elu,
    "hardshrink": _hardshrink,
    "hardtanh": _hardtanh,
    "leakyrelu": functools.partial(F.leaky_relu, negative_slope=0.01),
    "prelu": functools.partial(F.leaky_relu, negative_slope=0.25),
    "relu": F.relu,
    "rrelu": functools.partial(F.leaky_relu, negative_slope=(1 / 8 + 1 / 3) / 2),
    "tanh": torch.tanh,
}


def get_activation(name: str):
    try:
        return ACTIVATION_FNS[name]
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; known: {sorted(ACTIVATION_FNS)}")


class _ReverseGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.p * g, None


def reverse_grad(x: torch.Tensor, p: float) -> torch.Tensor:
    """Gradient reversal (domain-adversarial training): the identity
    forward, -p * g backward."""
    return _ReverseGrad.apply(x, p)


def binarize(scores: torch.Tensor, threshold: float = 0.35) -> torch.Tensor:
    """1.0 where score > threshold else 0.0 (strict >), in the scores' dtype."""
    return (scores > threshold).to(scores.dtype)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with each id clamped into the table, as the JAX package's
    gather reads an out-of-range id: the last row (or the first).  A word id
    of a dev or test split can lie beyond a GloVe table sized from the train
    split."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """sum(mask * x, dim) / sum(mask, dim) -- no epsilon: the BERT mask always
    holds the CLS/SEP tokens."""
    mask = mask.to(x.dtype)
    num = (x * mask.unsqueeze(-1)).sum(dim)
    den = mask.sum(dim).unsqueeze(-1)
    return num / den


def length_mask(lengths: torch.Tensor, max_len: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, T) mask of 1.0 for t < length."""
    t = torch.arange(max_len, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(dtype)
