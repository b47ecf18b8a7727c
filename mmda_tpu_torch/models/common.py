"""Shared layer primitives: linear, LayerNorm, dropout and the fusion
transformer layer.

Counterpart of `mmda_tpu/models/common.py`.  Parameters live in
`nn.Module`s with PyTorch layouts (a linear weight is (out, in)); the math
keeps the JAX package's rounding points:

* `linear`: the product accumulates in f32 from operands rounded to the
  input's dtype, the f32 bias is added, then the sum is cast back;
* `layer_norm`: f32 statistics, eps 1e-5, output in the input's dtype;
* `dropout`: inverted, one float draw per element (keep where u < 1 - rate),
  from a `torch.Generator` instead of a JAX key, so the masks differ from the
  JAX package's while their law is the same.

Initializers take an explicit `torch.Generator` and draw from the JAX
package's distributions (torch-default linear init, xavier in_proj); the
numbers differ from `jax.random`'s, so parity tests carry JAX weights across
with `mmda_tpu_torch.convert`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = x @ weight.T + bias: f32 accumulation, cast back to x.dtype."""
    y = torch.matmul(x.float(), weight.to(x.dtype).float().t())
    return (y + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x / (1 - rate) where a uniform draw is below 1 - rate, else 0, in
    x's dtype; the identity unless training and rate > 0."""
    if not training or rate == 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.empty(d_out, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch nn.Linear default: uniform(+-1/sqrt(fan_in)) for both."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class TransformerLayer(nn.Module):
    """Post-norm encoder layer (torch nn.TransformerEncoderLayer semantics):
    MHA -> dropout -> add -> LN -> FFN(relu, dropout) -> dropout -> add -> LN,
    with dropout on the attention probs too (four sites, all at
    `dropout_rate`)."""

    def __init__(self, d_model: int, dim_feedforward: int = 2048, device=None):
        super().__init__()
        self.in_proj = Linear(d_model, 3 * d_model, device)
        self.out_proj = Linear(d_model, d_model, device)
        self.ln1 = LayerNorm(d_model, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.ffn1 = Linear(d_model, dim_feedforward, device)
        self.ffn2 = Linear(dim_feedforward, d_model, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.out_proj.weight.shape[0]
        # torch MHA: in_proj xavier_uniform, zero in_proj/out_proj biases
        uniform_(self.in_proj.weight, math.sqrt(6.0 / (d + 3 * d)), generator)
        self.out_proj.reset_parameters(generator)
        self.ffn1.reset_parameters(generator)
        self.ffn2.reset_parameters(generator)
        with torch.no_grad():
            self.in_proj.bias.zero_()
            self.out_proj.bias.zero_()
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()

    def forward(self, x: torch.Tensor, num_heads: int,
                attn_bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.1,
                training: bool = False, generator: Optional[torch.Generator] = None):
        """x (B, S, D); attn_bias (B, S) additive key bias.
        Returns (out (B, S, D), attention probs (B, nh, S, S), after their
        dropout when training)."""
        def drop(t):
            return dropout(t, dropout_rate, training, generator)

        B, S, D = x.shape
        hd = D // num_heads
        q, k, v = self.in_proj(x).split(D, dim=-1)

        def heads(t):
            return t.reshape(B, S, num_heads, hd).transpose(1, 2)  # (B, nh, S, hd)

        logits = torch.matmul(heads(q).float(),
                              heads(k).float().transpose(-1, -2)) / math.sqrt(hd)
        if attn_bias is not None:
            logits = logits + attn_bias[:, None, None, :]
        probs = drop(torch.softmax(logits, dim=-1))
        ctx = torch.matmul(probs.to(x.dtype).float(), heads(v).float()).to(x.dtype)
        attn = drop(self.out_proj(ctx.transpose(1, 2).reshape(B, S, D)))
        x = self.ln1(x + attn)
        h = drop(self.ffn2(drop(F.relu(self.ffn1(x)))))
        return self.ln2(x + h), probs
