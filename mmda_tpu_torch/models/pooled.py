"""The pooled-modality encoders shared by LF_DNN, LMF and TFN.

Counterpart of `mmda_tpu/models/pooled.py`: each modality is mean-pooled
over its valid steps (the BERT tower's last hidden state over its mask, or
the GloVe embeddings over the text length; visual and acoustic over their
own lengths where the batch has them), zeroed per example by
`modality_keep`, and encoded by a two-layer MLP and a LayerNorm in f32.
BERT runs with the attention core `cfg.resolved_attn_impl` gives, and with
dropout in `train()`, drawn from the caller's generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from mmda_tpu_torch.models.bert import BertConfig, BertEncoder, split_aux
from mmda_tpu_torch.models.common import LayerNorm, Linear
from mmda_tpu_torch.ops.functions import get_activation, length_mask, lookup, masked_mean


class Encoder(nn.Module):
    """l1 -> act -> l2 -> act -> LayerNorm."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.l1 = Linear(d_in, hidden, device)
        self.l2 = Linear(hidden, hidden, device)
        self.ln = LayerNorm(hidden, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.l1.reset_parameters(generator)
        self.l2.reset_parameters(generator)
        self.ln.reset_parameters()

    def forward(self, x: torch.Tensor, act) -> torch.Tensor:
        return self.ln(act(self.l2(act(self.l1(x)))))


class PooledModel(nn.Module):
    """The text tower (`bert` or `embed`) and `enc_t`, `enc_v`, `enc_a`; a
    family adds its fusion and heads."""

    def __init__(self, cfg, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None, vocab_size: Optional[int] = None,
                 bert_cfg: Optional[BertConfig] = None, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        if cfg.use_bert:
            self.bert_cfg = bert_cfg or BertConfig.base()
            self.bert = BertEncoder(self.bert_cfg, device)
            text_in = self.bert_cfg.hidden_size
        else:
            self.bert_cfg = None
            self.embed = nn.Parameter(torch.empty(
                vocab_size or cfg.vocab_size, cfg.embedding_size, device=device))
            text_in = cfg.embedding_size
        self.enc_t = Encoder(text_in, H, device)
        self.enc_v = Encoder(visual_size or cfg.visual_size, H, device)
        self.enc_a = Encoder(acoustic_size or cfg.acoustic_size, H, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        for child in self.children():
            child.reset_parameters(generator)
        if not self.cfg.use_bert:
            with torch.no_grad():
                self.embed.normal_(generator=generator)

    def encodings(self, batch, modality_keep: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[Dict]]:
        """(ht, hv, ha, moe_aux): each h (B, hidden_size) f32; moe_aux the
        BERT tower's router losses (None unless moe_experts > 0), as
        `mmda_tpu.models.pooled.pooled_modality_encodings`."""
        cfg = self.cfg
        act = get_activation(cfg.activation)
        v_len = batch.visual_lengths if batch.visual_lengths is not None else batch.lengths
        a_len = batch.acoustic_lengths if batch.acoustic_lengths is not None else batch.lengths
        moe_aux = None
        if cfg.use_bert:
            S = batch.bert_ids.shape[1]
            hidden, moe_aux = split_aux(self.bert(
                batch.bert_ids, batch.bert_mask, batch.bert_type,
                getattr(torch, cfg.compute_dtype), self.training, generator,
                cfg.resolved_attn_impl(training=self.training, seq_len=S)))
            pooled_t = masked_mean(hidden.float(), batch.bert_mask)
        else:
            pooled_t = masked_mean(lookup(self.embed, batch.text).float(),
                                   length_mask(batch.lengths, batch.text.shape[1]))
        pooled_v = masked_mean(batch.visual.float(), length_mask(v_len, batch.visual.shape[1]))
        pooled_a = masked_mean(batch.acoustic.float(),
                               length_mask(a_len, batch.acoustic.shape[1]))
        if modality_keep is not None:
            mk = modality_keep.float()
            pooled_t = pooled_t * mk[:, 0][:, None]
            pooled_v = pooled_v * mk[:, 1][:, None]
            pooled_a = pooled_a * mk[:, 2][:, None]
        return (self.enc_t(pooled_t, act), self.enc_v(pooled_v, act),
                self.enc_a(pooled_a, act), moe_aux)
