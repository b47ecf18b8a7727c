"""TFN: Tensor Fusion Network (counterpart of `mmda_tpu/models/tfn.py`).

Zadeh et al., EMNLP 2017: each pooled encoding (`models/pooled.py`) is
projected to `cfg.tfn_post_dim` = D (`post_*`, then the activation) and
given a constant-1 slot; their triple outer product, (D+1)^3 coordinates
per example (every uni-, bi- and tri-modal interaction), goes through the
`fusion` linear, the activation and dropout, then the `head` MLP with
dropout, the output head (`out`) and the ConfidNet head.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmda_tpu_torch.models.common import Linear, dropout
from mmda_tpu_torch.models.misa import MISAOutput, classifier_output
from mmda_tpu_torch.models.pooled import PooledModel
from mmda_tpu_torch.ops.functions import get_activation


class TFN(PooledModel):
    def __init__(self, cfg, visual_size=None, acoustic_size=None, vocab_size=None,
                 bert_cfg=None, device=None):
        super().__init__(cfg, visual_size, acoustic_size, vocab_size, bert_cfg, device)
        H, D, C = cfg.hidden_size, cfg.tfn_post_dim, cfg.num_classes
        self.post_t = Linear(H, D, device)
        self.post_v = Linear(H, D, device)
        self.post_a = Linear(H, D, device)
        self.fusion = Linear((D + 1) ** 3, H, device)
        self.head = Linear(H, H, device)
        self.out = Linear(H, C, device)
        self.confidence = Linear(H, C, device)

    def forward(self, batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        cfg = self.cfg
        act = get_activation(cfg.activation)
        ht, hv, ha, moe_aux = self.encodings(batch, modality_keep, generator)
        B = ht.shape[0]
        ones = ht.new_ones(B, 1)

        def post(z, lin):
            return torch.cat([act(lin(z)).float(), ones], dim=1)

        zt, zv, za = post(ht, self.post_t), post(hv, self.post_v), post(ha, self.post_a)
        tensor = torch.einsum("bi,bj,bk->bijk", zt, zv, za)
        fused = dropout(act(self.fusion(tensor.reshape(B, -1))), cfg.dropout,
                        self.training, generator)
        h = dropout(act(self.head(fused)), cfg.dropout, self.training, generator)
        tcp = torch.sigmoid(self.confidence(h))
        return classifier_output(cfg, self.out(h).float(), tcp, moe_aux)
