"""MAG-BERT: the Multimodal Adaptation Gate inside BERT (counterpart of
`mmda_tpu/models/mag_bert.py`).

Rahman et al., ACL 2020: the hidden states entering encoder layer
`cfg.mag_inject_layer` (0: the embedding output; num_layers: after the
last layer) are shifted by a gated nonverbal displacement,

    g_v = ReLU(W_gv [h; v]),  g_a = ReLU(W_ga [h; a])      per token
    H_m = g_v * (W_v v) + g_a * (W_a a)
    alpha = min(beta * ||h|| / (||H_m|| + 1e-6), 1)
    h' = LayerNorm(h + dropout(alpha * H_m)),

then the [CLS] state goes through a pooler (`pooler`, tanh, dropout at
`cfg.dropout`) to the classifier and ConfidNet heads.  The gate (`mag`) is
a closure passed through `bert_encode`'s `inject_layer` / `inject_fn` hook,
so it composes with every attention core and with `fused_ln_dropout`; it
computes in f32 (its dropout at `cfg.mag_dropout`, a plain LayerNorm, not
the fused kernel, as in the JAX gate), and the encoder rounds its output
to the compute dtype once.  Under the mosei freeze rule the gate's
gradient flows back through the frozen layers after it.

The word-aligned visual and acoustic streams are laid onto the WordPiece
grid by a shift of one past [CLS], cut or zero-padded to S, and zeroed at
padded positions (`to_token_grid`).  `modality_keep` zeroes the visual and
acoustic streams per example, never the text.  BERT only: `use_bert=False`
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmda_tpu_torch.models.bert import BertConfig, BertEncoder
from mmda_tpu_torch.models.common import LayerNorm, Linear, dropout
from mmda_tpu_torch.models.misa import MISAOutput, classifier_output


def to_token_grid(seq: torch.Tensor, S: int, mask: torch.Tensor) -> torch.Tensor:
    """A word-aligned (B, T, D) stream on the (B, S) WordPiece grid:
    position 1 + t holds step t (t < S - 1), the rest zeros; then the
    padded positions of `mask` are zeroed."""
    n = min(seq.shape[1], S - 1)
    grid = F.pad(seq[:, :n], (0, 0, 1, S - 1 - n))
    return grid * mask.to(seq.dtype)[:, :, None]


class MAGGate(nn.Module):
    def __init__(self, Hb: int, dv: int, da: int, device=None):
        super().__init__()
        self.gate_v = Linear(Hb + dv, Hb, device)
        self.gate_a = Linear(Hb + da, Hb, device)
        self.proj_v = Linear(dv, Hb, device)
        self.proj_a = Linear(da, Hb, device)
        self.ln = LayerNorm(Hb, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)


def mag_gate(p: MAGGate, h: torch.Tensor, vis: torch.Tensor, aco: torch.Tensor,
             beta: float, rate: float, training: bool,
             generator: Optional[torch.Generator] = None, eps: float = 1e-6
             ) -> torch.Tensor:
    """The adaptation gate (module docstring), in f32: h (B, S, H) hidden
    states, vis / aco (B, S, D) f32 streams on the token grid."""
    hf = h.float()
    gv = F.relu(p.gate_v(torch.cat([hf, vis], dim=-1)))
    ga = F.relu(p.gate_a(torch.cat([hf, aco], dim=-1)))
    h_m = gv * p.proj_v(vis) + ga * p.proj_a(aco)
    norm_h = torch.linalg.vector_norm(hf, dim=-1, keepdim=True)
    norm_m = torch.linalg.vector_norm(h_m, dim=-1, keepdim=True)
    alpha = torch.clamp(beta * norm_h / (norm_m + eps), max=1.0)
    return p.ln(hf + dropout(alpha * h_m, rate, training, generator))


class MAG_BERT(nn.Module):
    def __init__(self, cfg, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None, vocab_size: Optional[int] = None,
                 bert_cfg: Optional[BertConfig] = None, device=None):
        super().__init__()
        if not cfg.use_bert:
            raise ValueError("MAG_BERT requires use_bert=True (the gate shifts BERT "
                             "hidden states; there is no GloVe variant)")
        self.cfg = cfg
        self.bert_cfg = bert_cfg or BertConfig.base()
        Hb, C = self.bert_cfg.hidden_size, cfg.num_classes
        self.bert = BertEncoder(self.bert_cfg, device)
        self.mag = MAGGate(Hb, visual_size or cfg.visual_size,
                           acoustic_size or cfg.acoustic_size, device)
        self.pooler = Linear(Hb, Hb, device)
        self.classifier = Linear(Hb, C, device)
        self.confidence = Linear(Hb, C, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        """`recurrence` is the RNN families' argument; there is none here."""
        cfg = self.cfg
        cd = getattr(torch, cfg.compute_dtype)
        training = self.training
        visual = batch.visual.float()
        acoustic = batch.acoustic.float()
        if modality_keep is not None:
            mk = modality_keep.float()
            visual = visual * mk[:, 1][:, None, None]
            acoustic = acoustic * mk[:, 2][:, None, None]
        S = batch.bert_ids.shape[1]
        vis = to_token_grid(visual, S, batch.bert_mask)
        aco = to_token_grid(acoustic, S, batch.bert_mask)

        def inject(h):
            return mag_gate(self.mag, h, vis, aco, cfg.mag_beta, cfg.mag_dropout, training,
                            generator)

        hidden = self.bert(batch.bert_ids, batch.bert_mask, batch.bert_type, cd, training,
                           generator, cfg.resolved_attn_impl(training=training, seq_len=S),
                           inject_layer=cfg.mag_inject_layer, inject_fn=inject)
        pooled = torch.tanh(self.pooler(hidden[:, 0].float()))
        pooled = dropout(pooled, cfg.dropout, training, generator)
        tcp = torch.sigmoid(self.confidence(pooled))
        return classifier_output(cfg, self.classifier(pooled).float(), tcp)
