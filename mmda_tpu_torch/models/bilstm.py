"""Masked bidirectional LSTM / GRU with packed-sequence semantics.

Counterpart of `mmda_tpu/models/bilstm.py`; the cell (`lstm`, gates i, f, g,
o, or `gru`, gates r, z, n) is chosen where the modules are built.
Fixed-length padded batches with a length mask stand in for
`pack_padded_sequence`:

* a masked step holds the carry, so the forward direction's final state is
  the state at each sequence's true length, and the reverse direction starts
  at each sequence's last valid token (its pads keep the zero carry);
* the input projection x @ W_ih^T is hoisted out of the recurrence into one
  matmul, with b_ih and, for the LSTM, b_hh folded into x_proj (the GRU's
  b_hh sits inside its r product and goes to the recurrence as it is);
* outputs are zeroed at pads, as pad_packed_sequence does;
* `extract_features`: rnn1 -> LayerNorm -> rnn2, utterance vector
  [h1_f, h2_f, h1_b, h2_b] (B, 4H).

Every directional recurrence goes through the kernels by default: when a
gradient is wanted (x_proj or a recurrent parameter needs one, so grad is
enabled) through `lstm_scan` / `gru_scan` (forward kernel with the states
saved, BPTT kernel as its backward), otherwise through `lstm_recurrence`
(without cs) / `gru_recurrence` alone.  Callers may pass `recurrence=` the
cell's plain version (`lstm_recurrence_reference`, which returns (ys, cs,
h_fin, c_fin), or `gru_recurrence_reference`, which returns (ys, h_fin)) to
run it instead, differentiated by autograd.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from mmda_tpu_torch.models.common import LayerNorm, uniform_
from mmda_tpu_torch.ops.functions import length_mask
from mmda_tpu_torch.ops.kernels.gru import gru_recurrence, gru_scan
from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence, lstm_scan

Recurrence = Callable[..., tuple]
GATES = {"lstm": 4, "gru": 3}


class LSTMDirection(nn.Module):
    """One direction in the torch nn.LSTM / nn.GRU layout: w_ih (G, F), w_hh
    (G, H), G = 4H with gates i, f, g, o (lstm) or 3H with r, z, n (gru)."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 cell: str = "lstm"):
        super().__init__()
        if cell not in GATES:
            raise ValueError(f"cell must be lstm|gru, got {cell!r}")
        self.cell = cell
        G = GATES[cell] * hidden_size
        self.w_ih = nn.Parameter(torch.empty(G, input_size, device=device))
        self.w_hh = nn.Parameter(torch.empty(G, hidden_size, device=device))
        self.b_ih = nn.Parameter(torch.empty(G, device=device))
        self.b_hh = nn.Parameter(torch.empty(G, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch nn.LSTM / nn.GRU default (uniform +-1/sqrt(H)), then w_hh
        orthogonal as the reference solver re-initializes it."""
        k = 1.0 / math.sqrt(self.w_hh.shape[1])
        uniform_(self.w_ih, k, generator)
        uniform_(self.b_ih, k, generator)
        uniform_(self.b_hh, k, generator)
        with torch.no_grad():
            nn.init.orthogonal_(self.w_hh, generator=generator)


def scan_direction(p: LSTMDirection, x: torch.Tensor, mask: torch.Tensor,
                   reverse: bool, recurrence: Optional[Recurrence] = None):
    """One direction over (B, T, F) input with (B, T) mask.
    Returns (outputs (B, T, H), final h (B, H))."""
    B, T, F = x.shape
    # x_bf16 @ w_ih.astype(bf16) with f32 accumulation: both operands are
    # upcast exactly, then multiplied in f32
    x_proj = torch.matmul(x.reshape(B * T, F).float(),
                          p.w_ih.to(x.dtype).float().t()).reshape(B, T, -1)
    x_proj = x_proj + p.b_ih.float()
    if p.cell == "lstm":
        x_proj = x_proj + p.b_hh.float()
    x_proj = x_proj.transpose(0, 1).contiguous()
    w_hh_t = p.w_hh.float().t().contiguous()
    mask_t = mask.t().contiguous().float()
    if p.cell == "gru":
        args = (x_proj, w_hh_t, p.b_hh.float(), mask_t, reverse)
        if recurrence is not None:
            ys, h_fin = recurrence(*args)
        elif any(a.requires_grad for a in args[:3]):        # a gradient is wanted
            ys, h_fin = gru_scan(*args)
        else:
            ys, h_fin = gru_recurrence(*args)
        return ys.transpose(0, 1), h_fin
    args = (x_proj, w_hh_t, mask_t, reverse)
    if recurrence is not None:
        ys, _, h_fin, _ = recurrence(*args)
    elif x_proj.requires_grad or w_hh_t.requires_grad:      # a gradient is wanted
        ys, h_fin = lstm_scan(*args)
    else:
        ys, _, h_fin, _ = lstm_recurrence(*args)
    return ys.transpose(0, 1), h_fin


class BiLSTM(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, device=None,
                 cell: str = "lstm"):
        super().__init__()
        self.fwd = LSTMDirection(input_size, hidden_size, device, cell)
        self.bwd = LSTMDirection(input_size, hidden_size, device, cell)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fwd.reset_parameters(generator)
        self.bwd.reset_parameters(generator)


def birnn(p: BiLSTM, x: torch.Tensor, lengths: torch.Tensor,
          recurrence: Optional[Recurrence] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional masked LSTM or GRU over (B, T, F) with (B,) lengths.
    Returns outputs (B, T, 2H) [fwd; bwd], zero at pads, and the final
    states (B, 2H) [fwd_final; bwd_final]."""
    T = x.shape[1]
    mask = length_mask(lengths, T)
    ys_f, h_f = scan_direction(p.fwd, x, mask, False, recurrence)
    ys_b, h_b = scan_direction(p.bwd, x, mask, True, recurrence)
    ys = torch.cat([ys_f, ys_b], dim=-1) * mask[..., None]
    return ys, torch.cat([h_f, h_b], dim=-1)


class LSTMExtractor(nn.Module):
    """Two stacked bi-LSTMs (or bi-GRUs) with a LayerNorm between them."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 cell: str = "lstm"):
        super().__init__()
        self.rnn1 = BiLSTM(input_size, hidden_size, device, cell)
        self.rnn2 = BiLSTM(2 * hidden_size, hidden_size, device, cell)
        self.ln = LayerNorm(2 * hidden_size, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.rnn1.reset_parameters(generator)
        self.rnn2.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                recurrence: Optional[Recurrence] = None) -> torch.Tensor:
        return extract_features(self, x, lengths, recurrence)


def extract_features(p: LSTMExtractor, x: torch.Tensor, lengths: torch.Tensor,
                     recurrence: Optional[Recurrence] = None) -> torch.Tensor:
    """rnn1 -> LayerNorm(padded outputs) -> rnn2; returns the utterance
    vector [h1_f, h2_f, h1_b, h2_b] (B, 4H).  The LayerNorm turns the zeroed
    pad rows into its bias; rnn2 still ignores them through the mask."""
    ys1, h1 = birnn(p.rnn1, x, lengths, recurrence)
    ys1 = p.ln(ys1)
    _, h2 = birnn(p.rnn2, ys1, lengths, recurrence)
    H = h1.shape[-1] // 2
    return torch.cat([h1[:, :H], h2[:, :H], h1[:, H:], h2[:, H:]], dim=-1)
