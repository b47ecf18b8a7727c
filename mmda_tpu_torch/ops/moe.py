"""Mixture-of-Experts FFN (Switch top-1 / GShard top-2) for the BERT tower.

Counterpart of `mmda_tpu/ops/moe.py` on one card, with its parameters in the
JAX package's layout: `gate` (H, E), `w_in` (E, H, F), `b_in` (E, F),
`w_out` (E, F, H), `b_out` (E, H), so `convert.py` carries a MoE checkpoint
across in either direction.

- **Dense dispatch, static shapes.** Tokens reach their expert through a
  one-hot (G, n, E, C) dispatch tensor in two products, not a gather or a
  scatter: every shape is static (a CUDA graph captures it), and no atomic
  sum makes two runs differ.  Each token's (G, n, E, C) row has at most
  top_k ones, so the dispatch and combine products add one or two nonzero
  terms and are exact.
- **Capacity.** Each expert takes at most C = ceil(capacity_factor * top_k
  * n / E) tokens of each of the G groups of n = N / G tokens; a token past
  it is dropped from the FFN (the residual keeps it).  Its queue position
  is the cumulative count of earlier tokens routed to the same expert; a
  second choice (top_k 2) queues after all of that expert's first choices.
- **Numerics, as the JAX package.** Routing in f32 (`argmax` takes the first
  of equal maxima, as `jnp.argmax` does).  The expert products take
  operands rounded to the compute dtype and sum in f32 (here as f32
  products of the rounded operands, as `ops/functions.py::linear` does); the
  bias and the GELU in f32, one rounding after each; the combine weights
  rounded to the compute dtype before the last product, whose result stays
  f32.

Aux losses, returned with the output:
- `balance`: E * sum_e(frac_tokens_e * mean_prob_e), 1.0 at uniform routing;
- `router_z`: mean(logsumexp(logits)^2);
- `drop_frac`: the share of (token, choice) routes that overflowed.

The JAX package's expert-parallel hook (`set_expert_constraint`,
`parallel/expert.py`) belongs to the mesh modes, which the port does not
have yet.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class SwitchFFN(nn.Module):
    """The router and E stacked expert FFNs of one encoder layer."""

    def __init__(self, hidden: int, intermediate: int, num_experts: int, device=None):
        super().__init__()
        E, H, Fd = num_experts, hidden, intermediate
        self.gate = nn.Parameter(torch.empty(H, E, device=device))
        self.w_in = nn.Parameter(torch.empty(E, H, Fd, device=device))
        self.b_in = nn.Parameter(torch.zeros(E, Fd, device=device))
        self.w_out = nn.Parameter(torch.empty(E, Fd, H, device=device))
        self.b_out = nn.Parameter(torch.zeros(E, H, device=device))

    @property
    def num_experts(self) -> int:
        return self.w_in.shape[0]

    def reset_parameters(self, generator: torch.Generator, std: float = 0.02) -> None:
        """`init_moe_ffn_params`' distributions: the gate and the expert
        kernels truncated normal (+-2 std), zero biases."""
        with torch.no_grad():
            for t in (self.gate, self.w_in, self.w_out):
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.b_in.zero_()
            self.b_out.zero_()

    def forward(self, x: torch.Tensor, **options
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return switch_ffn(self, x, **options)


def _slots(pos: torch.Tensor, C: int) -> torch.Tensor:
    """one_hot(pos, C) f32 over a last axis of C, all zeros where pos >= C
    (as `jax.nn.one_hot` gives for an index out of range); a comparison, not
    `F.one_hot`'s scatter."""
    return (pos[..., None] == torch.arange(C, device=pos.device)).float()


def _dispatch(onehot: torch.Tensor, pos: torch.Tensor, C: int) -> torch.Tensor:
    """(G, n, E) one-hot choice and queue positions -> (G, n, E, C) one-hot
    dispatch; a token over capacity gets an all-zero row."""
    keep = onehot * (pos < C)
    return keep[..., None] * _slots((pos * onehot).sum(-1).long(), C)[:, :, None, :]


class Routes(NamedTuple):
    """A routing of G groups of n tokens to E experts of C slots each."""
    dispatch: torch.Tensor      # (G, n, E, C) one-hot: token -> (expert, slot), 0 if dropped
    combine: torch.Tensor       # (G, n, E, C) the gate weight of each kept route
    onehot: torch.Tensor        # (G, n, E) the first choice
    probs: torch.Tensor         # (G, n, E) the router's softmax, f32
    logits: torch.Tensor        # (G, n, E) f32


def route(p: SwitchFFN, x: torch.Tensor, *, capacity_factor: float = 1.25, groups: int = 1,
          top_k: int = 1) -> Routes:
    """The routing of `switch_ffn` (module docstring) for tokens x (N, H)."""
    N, H = x.shape
    E = p.num_experts
    G = groups
    if N % G:
        raise ValueError(f"groups={G} must divide token count N={N}")
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 (Switch) or 2 (GShard), got {top_k}")
    n = N // G
    C = max(int(math.ceil(capacity_factor * top_k * n / E)), 1)
    logits = torch.matmul(x.reshape(G, n, H).float(), p.gate.float())
    probs = torch.softmax(logits, dim=-1)
    gate_p = probs.amax(dim=-1)
    onehot = _slots(torch.argmax(probs, dim=-1), E)
    pos1 = torch.cumsum(onehot, dim=1) * onehot - onehot
    dispatch = _dispatch(onehot, pos1, C)
    if top_k == 1:
        return Routes(dispatch, dispatch * gate_p[..., None, None], onehot, probs, logits)
    probs2 = probs * (1.0 - onehot)
    gate_p2 = probs2.amax(dim=-1)
    onehot2 = _slots(torch.argmax(probs2, dim=-1), E)
    count1 = onehot.sum(dim=1, keepdim=True)                            # (G, 1, E)
    pos2 = torch.cumsum(onehot2, dim=1) * onehot2 - onehot2 + count1 * onehot2
    dispatch2 = _dispatch(onehot2, pos2, C)
    denom = gate_p + gate_p2 + 1e-9
    combine = (dispatch * (gate_p / denom)[..., None, None]
               + dispatch2 * (gate_p2 / denom)[..., None, None])
    return Routes(dispatch + dispatch2, combine, onehot, probs, logits)


def switch_ffn(p: SwitchFFN, x: torch.Tensor, *, capacity_factor: float = 1.25,
               gelu_exact: bool = True, compute_dtype: torch.dtype = torch.bfloat16,
               groups: int = 1, top_k: int = 1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k MoE FFN over N tokens x (N, H).  Returns y (N, H) f32 and the
    aux losses {"balance", "router_z", "drop_frac"} (f32 scalars).

    groups: route G independent groups of n = N / G tokens, each with its
    own capacity (bert_layer groups by example, G = batch)."""
    N, H = x.shape
    E = p.num_experts
    r = route(p, x, capacity_factor=capacity_factor, groups=groups, top_k=top_k)
    G, n, _, C = r.dispatch.shape
    cd = compute_dtype

    def rounded(t):             # an operand in the compute dtype, for an f32 product
        return t.to(cd).float()

    xe = torch.einsum("gnec,gnh->gech", r.dispatch, rounded(x.reshape(G, n, H))).to(cd)
    xe = xe.transpose(0, 1).reshape(E, G * C, H)
    h = torch.matmul(xe.float(), rounded(p.w_in)) + p.b_in.float()[:, None]
    h = F.gelu(h, approximate="none" if gelu_exact else "tanh").to(cd)
    ye = torch.matmul(h.float(), rounded(p.w_out)) + p.b_out.float()[:, None]
    yg = ye.to(cd).reshape(E, G, C, H).transpose(0, 1)                   # (G, E, C, H)
    y = torch.einsum("gnec,gech->gnh", rounded(r.combine), yg.float())

    frac_tokens = r.onehot.mean(dim=(0, 1))
    mean_prob = r.probs.mean(dim=(0, 1))
    balance = E * torch.sum(frac_tokens * mean_prob)
    router_z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    drop_frac = 1.0 - r.dispatch.sum() / (N * top_k)
    return y.reshape(N, H), {"balance": balance, "router_z": router_z,
                             "drop_frac": drop_frac}
