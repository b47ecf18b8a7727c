"""LMF: Low-rank Multimodal Fusion (counterpart of `mmda_tpu/models/lmf.py`).

Liu et al., ACL 2018: the tensor fusion of TFN with its weight factorized
into rank-R factors per modality,

    y = sum_{i=1..R} (W_t^i [h_t; 1]) * (W_v^i [h_v; 1]) * (W_a^i [h_a; 1]) + b,

over the pooled encodings (`models/pooled.py`): one (B, H+1) x (R, H+1, H)
product per modality in f32, their elementwise product summed over the
rank, then dropout, the output head (`out`) and the ConfidNet head.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mmda_tpu_torch.models.common import Linear, dropout
from mmda_tpu_torch.models.misa import MISAOutput, classifier_output
from mmda_tpu_torch.models.pooled import PooledModel


class LMF(PooledModel):
    def __init__(self, cfg, visual_size=None, acoustic_size=None, vocab_size=None,
                 bert_cfg=None, device=None):
        super().__init__(cfg, visual_size, acoustic_size, vocab_size, bert_cfg, device)
        H, R, C = cfg.hidden_size, cfg.lmf_rank, cfg.num_classes
        for name in ("factor_t", "factor_v", "factor_a"):
            setattr(self, name, nn.Parameter(torch.empty(R, H + 1, H, device=device)))
        self.fusion_bias = nn.Parameter(torch.zeros(H, device=device))
        self.out = Linear(H, C, device)
        self.confidence = Linear(H, C, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The pooled stack, then the factors N(0, 1) / sqrt(H + 1) and a
        zero fusion bias, as the JAX package draws them."""
        super().reset_parameters(generator)
        H = self.cfg.hidden_size
        with torch.no_grad():
            for f in (self.factor_t, self.factor_v, self.factor_a):
                f.normal_(generator=generator).div_(math.sqrt(H + 1))
            self.fusion_bias.zero_()

    def forward(self, batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        cfg = self.cfg
        ht, hv, ha, moe_aux = self.encodings(batch, modality_keep, generator)
        ones = ht.new_ones(ht.shape[0], 1)

        def project(z, w):                    # (B, H+1) x (R, H+1, H) -> (B, R, H)
            return torch.einsum("bi,rih->brh", torch.cat([z, ones], dim=1), w)

        fused = (project(ht, self.factor_t) * project(hv, self.factor_v)
                 * project(ha, self.factor_a)).sum(dim=1) + self.fusion_bias
        fused = dropout(fused, cfg.dropout, self.training, generator)
        tcp = torch.sigmoid(self.confidence(fused))
        return classifier_output(cfg, self.out(fused).float(), tcp, moe_aux)
