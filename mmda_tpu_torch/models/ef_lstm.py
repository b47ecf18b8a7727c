"""EF_LSTM: early-fusion LSTM (counterpart of `mmda_tpu/models/ef_lstm.py`).

Per time step the GloVe embedding, the visual and the acoustic features are
concatenated (word-aligned streams, one length), then one `LSTMExtractor`
(two stacked bi-RNNs of `cfg.hidden_size` units, the cell of `cfg.rnncell`:
4 forward recurrences, and 4 BPTTs in training, through the kernels), then
an MLP head (`head1`, `head2`, dropout on the logits) and the ConfidNet
head (`confidence`), both on the utterance vector.  GloVe text only:
`use_bert=True` raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mmda_tpu_torch.models.bilstm import LSTMExtractor
from mmda_tpu_torch.models.common import Linear, dropout
from mmda_tpu_torch.models.misa import MISAOutput, classifier_output
from mmda_tpu_torch.ops.functions import get_activation, lookup


class EF_LSTM(nn.Module):
    def __init__(self, cfg, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None, vocab_size: Optional[int] = None,
                 bert_cfg=None, device=None):
        super().__init__()
        if cfg.use_bert:
            raise ValueError("EF_LSTM is a GloVe-based early-fusion model; "
                             "run with --use_bert False")
        self.cfg = cfg
        self.bert_cfg = None
        H, C = cfg.hidden_size, cfg.num_classes
        d_in = (cfg.embedding_size + (visual_size or cfg.visual_size)
                + (acoustic_size or cfg.acoustic_size))
        self.embed = nn.Parameter(torch.empty(
            vocab_size or cfg.vocab_size, cfg.embedding_size, device=device))
        self.fused_extractor = LSTMExtractor(d_in, H, device, cfg.rnncell)
        self.head1 = Linear(4 * H, H, device)
        self.head2 = Linear(H, C, device)
        self.confidence = Linear(4 * H, C, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        for child in self.children():
            child.reset_parameters(generator)
        with torch.no_grad():
            self.embed.normal_(generator=generator)

    def forward(self, batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        """recurrence: the extractor's recurrence in place of the kernels
        (the plain version of cfg.rnncell's cell)."""
        cfg = self.cfg
        act = get_activation(cfg.activation)
        cd = getattr(torch, cfg.compute_dtype)
        emb = lookup(self.embed, batch.text).to(cd)
        visual = batch.visual.to(cd)
        acoustic = batch.acoustic.to(cd)
        if modality_keep is not None:
            mk = modality_keep.to(cd)
            emb = emb * mk[:, 0][:, None, None]
            visual = visual * mk[:, 1][:, None, None]
            acoustic = acoustic * mk[:, 2][:, None, None]
        if visual.shape[1] != emb.shape[1] or acoustic.shape[1] != emb.shape[1]:
            raise ValueError("EF_LSTM needs word-aligned modalities")
        utt = self.fused_extractor(torch.cat([emb, visual, acoustic], dim=-1),
                                   batch.lengths, recurrence).float()     # (B, 4H)
        logits = self.head2(act(self.head1(utt)))
        logits = dropout(logits, cfg.dropout, self.training, generator)
        tcp = torch.sigmoid(self.confidence(utt))
        return classifier_output(cfg, logits, tcp)
