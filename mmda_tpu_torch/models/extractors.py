"""Tower feature extractors: RNN (lstm / gru) and transformer.

Counterpart of `mmda_tpu/models/extractors.py`:

* `extractor='lstm'`: two stacked bi-RNNs (`models/bilstm.py`), the cell
  chosen by `cfg.rnncell`, hidden size = the modality's input size;
* `extractor='transformer'`: input projection -> learned positions ->
  LayerNorm -> two post-LN transformer layers with length masking (always
  deterministic, as in the JAX package) -> masked-mean pooling.  It runs no
  kernel.

Both give a (B, 4 * input_size) utterance vector, so every downstream shape
is the same.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mmda_tpu_torch.models.bilstm import LSTMExtractor
from mmda_tpu_torch.models.common import LayerNorm, Linear, TransformerLayer
from mmda_tpu_torch.ops.functions import length_mask, masked_mean

MAX_POS = 512


class TransformerExtractor(nn.Module):
    def __init__(self, input_size: int, num_layers: int = 2, device=None):
        super().__init__()
        d = 4 * input_size                      # the bi-RNN utterance width
        self.in_proj = Linear(input_size, d, device)
        self.pos = nn.Parameter(torch.empty(MAX_POS, d, device=device))
        self.ln = LayerNorm(d, device=device)
        self.layers = nn.ModuleList(TransformerLayer(d, dim_feedforward=2 * d, device=device)
                                    for _ in range(num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.in_proj.reset_parameters(generator)
        with torch.no_grad():
            self.pos.normal_(0.0, 0.02, generator=generator)
        self.ln.reset_parameters()
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, recurrence=None,
                num_heads: int = 4) -> torch.Tensor:
        """(B, T, F) + lengths -> (B, 4F); `recurrence` is the RNN towers'
        argument and is not used here."""
        T = x.shape[1]
        mask = length_mask(lengths, T)
        h = self.ln(self.in_proj(x.float()) + self.pos[:T][None])
        bias = (1.0 - mask) * -1e9
        for layer in self.layers:
            h, _ = layer(h, num_heads=num_heads, attn_bias=bias, training=False)
        return masked_mean(h, mask)


def make_tower(cfg, input_size: int, device=None) -> nn.Module:
    if cfg.extractor == "transformer":
        return TransformerExtractor(input_size, device=device)
    return LSTMExtractor(input_size, input_size, device, cfg.rnncell)


def tower_extract(tower: nn.Module, x: torch.Tensor, lengths: torch.Tensor,
                  recurrence=None) -> torch.Tensor:
    return tower(x, lengths, recurrence)
