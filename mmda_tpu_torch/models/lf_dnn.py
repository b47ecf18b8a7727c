"""LF_DNN: late-fusion DNN (counterpart of `mmda_tpu/models/lf_dnn.py`).

The three pooled encodings (`models/pooled.py`) side by side, then an MLP
head (`head1`, `head2`) with dropout on the logits and the ConfidNet head
(`confidence`) on the same fused vector.  No recurrence.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmda_tpu_torch.models.common import Linear, dropout
from mmda_tpu_torch.models.misa import MISAOutput, classifier_output
from mmda_tpu_torch.models.pooled import PooledModel
from mmda_tpu_torch.ops.functions import get_activation


class LF_DNN(PooledModel):
    def __init__(self, cfg, visual_size=None, acoustic_size=None, vocab_size=None,
                 bert_cfg=None, device=None):
        super().__init__(cfg, visual_size, acoustic_size, vocab_size, bert_cfg, device)
        H, C = cfg.hidden_size, cfg.num_classes
        self.head1 = Linear(3 * H, H, device)
        self.head2 = Linear(H, C, device)
        self.confidence = Linear(3 * H, C, device)

    def forward(self, batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        """`recurrence` is the RNN families' argument; there is none here."""
        cfg = self.cfg
        act = get_activation(cfg.activation)
        *h, moe_aux = self.encodings(batch, modality_keep, generator)
        fused = torch.cat(h, dim=-1)
        tcp = torch.sigmoid(self.confidence(fused))
        logits = self.head2(act(self.head1(fused)))
        logits = dropout(logits, cfg.dropout, self.training, generator)
        return classifier_output(cfg, logits, tcp, moe_aux)
