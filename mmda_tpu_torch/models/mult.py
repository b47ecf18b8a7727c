"""MulT: the Multimodal Transformer (counterpart of `mmda_tpu/models/mult.py`).

Tsai et al., ACL 2019: each target modality attends to the other two
modalities' low-level features through cross-modal attention, so the
visual and acoustic streams need not be aligned to the words (the batch's
`visual_lengths` / `acoustic_lengths` give their own time axes):

1. per modality a temporal convolution to a common width d (`proj_t`,
   `proj_v`, `proj_a`: SAME padding, no bias, in f32, the input masked
   before it), times sqrt(d), plus sinusoidal positions, padding zeroed,
   then dropout;
2. six cross-modal stacks of `mult_layers` pre-LN blocks (`cross_tv` ...
   `cross_av`): the target stream's queries attend, at every layer, to the
   source modality's conv features as keys and values;
3. per target modality its two cross-modal streams side by side (2d), a
   self-attention stack of max(mult_layers - 1, 1) blocks (`self_t`,
   `self_v`, `self_a`), then the state at each sequence's true last valid
   step (with BERT, `sum(bert_mask) - 1`), clipped into [0, T - 1];
4. the three utterance vectors (6d) through a residual MLP head (`proj1`,
   `proj2`; no dropout on the logits), the output head (`out`) and the
   ConfidNet head (`confidence`).

Every attention masks the source's padding with a -1e9 key bias.  The
attention at d = 40 and 5 heads is plain `torch.matmul` and softmax, as the
JAX package computes it with einsums outside any Pallas kernel, at its
rounding points: the logits and probs in f32, dropout on the probs, the
probs rounded to the stream's dtype for the product with v.  As in the JAX
package, the conv output (rounded to the compute dtype) is scaled by a
numpy scalar, so the streams from there on are f32 even under bf16; only
the text tower (BERT or the GloVe table) and the raw visual and acoustic
features run in the compute dtype.  `modality_keep` zeroes the text (the
BERT output or the embeddings), visual and acoustic features per example.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmda_tpu_torch.models.bert import BertConfig, BertEncoder, split_aux
from mmda_tpu_torch.models.common import Conv1d, LayerNorm, Linear, dropout
from mmda_tpu_torch.models.misa import MISAOutput, classifier_output
from mmda_tpu_torch.ops.functions import length_mask, lookup

_NEG = -1e9
CROSS = ("tv", "ta", "vt", "va", "at", "av")     # target, source


def sinusoid(T: int, d: int, device=None) -> torch.Tensor:
    """(T, d) f32 positions, sin on the even columns and cos on the odd,
    computed in float64 on `device` (no host copy inside a captured step)
    and rounded once, as the JAX package's numpy table is."""
    pos = torch.arange(T, device=device, dtype=torch.float64)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float64)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * i / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(T, d).float()


class CrossLayer(nn.Module):
    """Pre-LN block: x + MHA(LN(x), LN(src)); x + FFN(LN(x))."""

    def __init__(self, d: int, device=None):
        super().__init__()
        for name in ("q", "k", "v", "out"):
            setattr(self, name, Linear(d, d, device))
        self.ln_q = LayerNorm(d, device=device)
        self.ln_kv = LayerNorm(d, device=device)
        self.ln_ffn = LayerNorm(d, device=device)
        self.ffn1 = Linear(d, 4 * d, device)
        self.ffn2 = Linear(4 * d, d, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, x: torch.Tensor, src: torch.Tensor, src_bias: torch.Tensor,
                num_heads: int, rate: float, training: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """x (B, Tq, d) target stream, src (B, Tk, d) source features,
        src_bias (B, Tk) additive key bias."""
        def drop(t):
            return dropout(t, rate, training, generator)

        B, Tq, D = x.shape
        Tk = src.shape[1]
        hd = D // num_heads
        xq = self.ln_q(x)
        xk = self.ln_kv(src)
        q = self.q(xq).reshape(B, Tq, num_heads, hd).transpose(1, 2)
        k = self.k(xk).reshape(B, Tk, num_heads, hd).transpose(1, 2)
        v = self.v(xk).reshape(B, Tk, num_heads, hd).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = drop(torch.softmax(logits + src_bias[:, None, None, :], dim=-1))
        ctx = torch.matmul(probs.to(x.dtype).float(), v.float()).to(x.dtype)
        x = x + drop(self.out(ctx.transpose(1, 2).reshape(B, Tq, D)))
        h = drop(F.relu(self.ffn1(self.ln_ffn(x))))
        return x + drop(self.ffn2(h))


class Stack(nn.Module):
    def __init__(self, d: int, layers: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(CrossLayer(d, device) for _ in range(layers))
        self.ln_final = LayerNorm(d, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.ln_final.reset_parameters()

    def forward(self, x, src, src_bias, num_heads, rate, training, generator):
        """A cross-modal stack attends to the same low-level `src` at every
        layer; a self-attention stack passes src=None (its own stream)."""
        for layer in self.layers:
            x = layer(x, x if src is None else src, src_bias, num_heads, rate, training,
                      generator)
        return self.ln_final(x)


class MULT(nn.Module):
    def __init__(self, cfg, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None, vocab_size: Optional[int] = None,
                 bert_cfg: Optional[BertConfig] = None, device=None):
        super().__init__()
        self.cfg = cfg
        d, L, w = cfg.mult_d, cfg.mult_layers, cfg.mult_conv_kernel
        if cfg.use_bert:
            self.bert_cfg = bert_cfg or BertConfig.base()
            self.bert = BertEncoder(self.bert_cfg, device)
            text_in = self.bert_cfg.hidden_size
        else:
            self.bert_cfg = None
            self.embed = nn.Parameter(torch.empty(
                vocab_size or cfg.vocab_size, cfg.embedding_size, device=device))
            text_in = cfg.embedding_size
        self.proj_t = Conv1d(text_in, d, w, device)
        self.proj_v = Conv1d(visual_size or cfg.visual_size, d, w, device)
        self.proj_a = Conv1d(acoustic_size or cfg.acoustic_size, d, w, device)
        for name in CROSS:
            setattr(self, f"cross_{name}", Stack(d, L, device))
        for name in ("t", "v", "a"):
            setattr(self, f"self_{name}", Stack(2 * d, max(L - 1, 1), device))
        D6 = 6 * d
        self.proj1 = Linear(D6, D6, device)
        self.proj2 = Linear(D6, D6, device)
        self.out = Linear(D6, cfg.num_classes, device)
        self.confidence = Linear(D6, cfg.num_classes, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        for child in self.children():
            child.reset_parameters(generator)
        if not self.cfg.use_bert:
            with torch.no_grad():
                self.embed.normal_(generator=generator)

    def forward(self, batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        """`recurrence` is the RNN families' argument; there is none here."""
        cfg = self.cfg
        cd = getattr(torch, cfg.compute_dtype)
        d, heads = cfg.mult_d, cfg.mult_heads
        training = self.training
        rate = cfg.dropout if training else 0.0
        v_len = batch.visual_lengths if batch.visual_lengths is not None else batch.lengths
        a_len = batch.acoustic_lengths if batch.acoustic_lengths is not None else batch.lengths

        moe_aux = None
        if cfg.use_bert:
            S = batch.bert_ids.shape[1]
            feat_t, moe_aux = split_aux(self.bert(
                batch.bert_ids, batch.bert_mask, batch.bert_type, cd, training, generator,
                cfg.resolved_attn_impl(training=training, seq_len=S)))
            mask_t = batch.bert_mask.float()
            len_t = batch.bert_mask.sum(-1)
        else:
            feat_t = lookup(self.embed, batch.text).to(cd)
            mask_t = length_mask(batch.lengths, batch.text.shape[1])
            len_t = batch.lengths
        feat_v = batch.visual.to(cd)
        feat_a = batch.acoustic.to(cd)
        mask_v = length_mask(v_len, feat_v.shape[1])
        mask_a = length_mask(a_len, feat_a.shape[1])
        if modality_keep is not None:
            mk = modality_keep.to(cd)
            feat_t = feat_t * mk[:, 0][:, None, None]
            feat_v = feat_v * mk[:, 1][:, None, None]
            feat_a = feat_a * mk[:, 2][:, None, None]

        def project(conv, x, mask):
            # masked BEFORE the conv: a width > 1 reaches into the padding
            x = x * mask[..., None].to(x.dtype)
            h = conv(x).float() * math.sqrt(d)           # f32 from here (docstring)
            h = h + sinusoid(x.shape[1], d, h.device)[None]
            h = h * mask[..., None]
            return dropout(h, rate, training, generator)

        ht = project(self.proj_t, feat_t, mask_t)
        hv = project(self.proj_v, feat_v, mask_v)
        ha = project(self.proj_a, feat_a, mask_a)
        streams = {"t": ht, "v": hv, "a": ha}
        bias = {"t": (1.0 - mask_t) * _NEG, "v": (1.0 - mask_v) * _NEG,
                "a": (1.0 - mask_a) * _NEG}

        z = {name: getattr(self, f"cross_{name}")(streams[name[0]], streams[name[1]],
                                                  bias[name[1]], heads, rate, training,
                                                  generator)
             for name in CROSS}

        def fuse(m, lengths):
            h = torch.cat([z[m + o] for o in "tva" if o != m], dim=-1)
            h = getattr(self, f"self_{m}")(h, None, bias[m], heads, rate, training,
                                           generator)
            idx = (lengths.long() - 1).clamp(0, h.shape[1] - 1)
            return h[torch.arange(h.shape[0], device=h.device), idx]

        fused = torch.cat([fuse("t", len_t), fuse("v", v_len), fuse("a", a_len)],
                          dim=-1).float()
        h = dropout(F.relu(self.proj1(fused)), rate, training, generator)
        h = self.proj2(h) + fused
        tcp = torch.sigmoid(self.confidence(fused))
        return classifier_output(cfg, self.out(h).float(), tcp, moe_aux)
