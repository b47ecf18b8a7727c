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
  [h1_f, h2_f, h1_b, h2_b] (B, 4H);
* `extract_features_pair`: the visual and acoustic towers together; with
  `use_pallas_multi` (LSTM cells, the same batch and length) all four
  directional recurrences of a stacked layer run in one launch of the
  multi-direction kernels (`ops/kernels/lstm_multi.py`), otherwise two
  `extract_features` calls.

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
from mmda_tpu_torch.ops.kernels.lstm_multi import (lstm_multi_recurrence,
                                                   lstm_multi_recurrence_reference,
                                                   lstm_scan_multi, pack_directions,
                                                   project_inputs, unpack_outputs)

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
    x_proj = project_inputs(p.w_ih, p.b_ih, x, p.b_hh if p.cell == "lstm" else None)
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


def extract_features_pair(pv: LSTMExtractor, pa: LSTMExtractor, xv: torch.Tensor,
                          xa: torch.Tensor, lengths_v: torch.Tensor, lengths_a: torch.Tensor,
                          cell: str = "lstm", use_pallas_multi: Optional[bool] = None,
                          recurrence: Optional[Recurrence] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The visual and acoustic utterance vectors, (B, 4H_v) and (B, 4H_a)
    (`mmda_tpu.models.bilstm.extract_features_pair`).

    With use_pallas_multi (off by default, as in the JAX package), an LSTM
    cell and the same (B, T) for both towers, each stacked layer runs its
    four directional recurrences (visual forward and reverse, acoustic
    forward and reverse) through one launch of each multi-direction kernel
    (`lstm_scan_multi`, or `lstm_multi_recurrence` where no gradient is
    wanted); a `recurrence` then selects their plain version
    (`lstm_multi_recurrence_reference`, differentiated by autograd).  Else
    two `extract_features` calls."""
    if not use_pallas_multi or cell != "lstm" or xv.shape[:2] != xa.shape[:2]:
        return (extract_features(pv, xv, lengths_v, recurrence),
                extract_features(pa, xa, lengths_a, recurrence))
    T = xv.shape[1]
    mv, ma = length_mask(lengths_v, T), length_mask(lengths_a, T)

    def run_layer(rv: BiLSTM, ra: BiLSTM, inp_v, inp_a):
        x_proj, w_hh_t, masks, reverse = pack_directions([
            (rv.fwd, inp_v, mv, False), (rv.bwd, inp_v, mv, True),
            (ra.fwd, inp_a, ma, False), (ra.bwd, inp_a, ma, True)])
        if recurrence is not None:
            ys, _, h_fin = lstm_multi_recurrence_reference(x_proj, w_hh_t, masks, reverse)
        elif any(t.requires_grad for t in x_proj + w_hh_t):    # a gradient is wanted
            ys, h_fin = lstm_scan_multi(x_proj, w_hh_t, masks, reverse)
        else:
            ys, _, h_fin = lstm_multi_recurrence(x_proj, w_hh_t, masks, reverse)
        outs, finals = unpack_outputs(ys, h_fin)
        ys_v = torch.cat(outs[:2], dim=-1) * mv[..., None]
        ys_a = torch.cat(outs[2:], dim=-1) * ma[..., None]
        return ys_v, ys_a, torch.cat(finals[:2], dim=-1), torch.cat(finals[2:], dim=-1)

    ys1_v, ys1_a, h1_v, h1_a = run_layer(pv.rnn1, pa.rnn1, xv, xa)
    _, _, h2_v, h2_a = run_layer(pv.rnn2, pa.rnn2, pv.ln(ys1_v), pa.ln(ys1_a))

    def utterance(h1, h2):
        H = h1.shape[-1] // 2
        return torch.cat([h1[:, :H], h2[:, :H], h1[:, H:], h2[:, H:]], dim=-1)

    return utterance(h1_v, h2_v), utterance(h1_a, h2_a)
