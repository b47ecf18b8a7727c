"""MISA model (shared/private multimodal factorization).

Counterpart of `mmda_tpu/models/misa.py::misa_forward`: the same graph and
the same `MISAOutput` fields, as an `nn.Module` whose parameter names follow
the JAX tree (see `mmda_tpu_torch.convert`).  `modality_keep` (B, 3) zeroes
the text/visual/acoustic streams per example.

Dropout follows the module's mode: off under `eval()` (the JAX package's
deterministic=True), on under `train()`, drawn from the `generator` the
caller passes (the trainer's, on the device, seeded from cfg.seed).  Its
sites are the JAX package's: BERT (its config's rates), the fusion layer
(a fixed 0.1), the discriminator's hidden layer and the logits
(cfg.dropout).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from mmda_tpu_torch.models.bert import BertConfig, BertEncoder
from mmda_tpu_torch.models.bilstm import extract_features_pair
from mmda_tpu_torch.models.common import LayerNorm, Linear, TransformerLayer, dropout
from mmda_tpu_torch.models.extractors import make_tower
from mmda_tpu_torch.ops.functions import (binarize, get_activation, lookup, masked_mean,
                                          reverse_grad)


class MISAOutput(NamedTuple):
    scores: torch.Tensor          # (B, C) sigmoid scores
    labels: torch.Tensor          # (B, C) binarized at threshold
    tcp: torch.Tensor             # (B, C) ConfidNet confidence
    shared_t: torch.Tensor
    shared_v: torch.Tensor
    shared_a: torch.Tensor
    private_t: torch.Tensor
    private_v: torch.Tensor
    private_a: torch.Tensor
    orig_t: torch.Tensor
    orig_v: torch.Tensor
    orig_a: torch.Tensor
    recon_t: torch.Tensor
    recon_v: torch.Tensor
    recon_a: torch.Tensor
    domain_t: Optional[torch.Tensor]   # (B, 3), None when use_cmd_sim
    domain_v: Optional[torch.Tensor]
    domain_a: Optional[torch.Tensor]
    sp_p_t: torch.Tensor
    sp_p_v: torch.Tensor
    sp_p_a: torch.Tensor
    sp_s: torch.Tensor
    fusion_attn: Optional[torch.Tensor] = None   # (B, nh, 6, 6)
    moe_aux: Optional[Dict] = None
    model_aux: Optional[Dict] = None


def classifier_output(cfg, logits: torch.Tensor, tcp: torch.Tensor) -> MISAOutput:
    """The `MISAOutput` of a family without MISA's shared/private
    factorization (EF_LSTM, LF_DNN, LMF, TFN): scores, labels and tcp, every
    other field None (the objective then drops diff, sim and recon)."""
    if cfg.resolved_task() == "regression":
        scores = logits.float()
        labels = scores
    else:
        scores = torch.sigmoid(logits)
        labels = binarize(scores, cfg.threshold)
    return MISAOutput(scores, labels, tcp, *[None] * 19)


class Batch(NamedTuple):
    text: torch.Tensor            # (B, T) int GloVe vocab ids
    visual: torch.Tensor          # (B, Tv, Dv) float
    acoustic: torch.Tensor        # (B, Ta, Da) float
    lengths: torch.Tensor         # (B,) text lengths
    bert_ids: torch.Tensor        # (B, S)
    bert_type: torch.Tensor       # (B, S)
    bert_mask: torch.Tensor       # (B, S)
    sentiment: torch.Tensor       # (B,)
    emo_label: torch.Tensor       # (B, C)
    sample_weight: torch.Tensor   # (B,) 1.0 real / 0.0 padding row
    visual_lengths: Optional[torch.Tensor] = None
    acoustic_lengths: Optional[torch.Tensor] = None

    def to(self, device) -> "Batch":
        """The batch with every tensor (numpy arrays too) on `device`."""
        def move(a):
            if a is None:
                return None
            return torch.as_tensor(a).to(device, non_blocking=True)
        return Batch(*(move(a) for a in self))


class Projection(nn.Module):
    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.linear = Linear(d_in, d_out, device)
        self.ln = LayerNorm(d_out, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.linear.reset_parameters(generator)
        self.ln.reset_parameters()


class Discriminator(nn.Module):
    def __init__(self, H: int, device=None):
        super().__init__()
        self.l1 = Linear(H, H, device)
        self.l2 = Linear(H, 3, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.l1.reset_parameters(generator)
        self.l2.reset_parameters(generator)


class LabelDecoder(nn.Module):
    def __init__(self, C: int, H: int, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(C, H, device=device))
        self.out_w = nn.Parameter(torch.empty(C, H, device=device))
        self.out_b = nn.Parameter(torch.zeros(C, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.normal_(0.0, 0.02, generator=generator)
            self.out_w.normal_(0.0, 0.02, generator=generator)
            self.out_b.zero_()


class MISA(nn.Module):
    def __init__(self, cfg, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 bert_cfg: Optional[BertConfig] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dv = visual_size or cfg.visual_size
        da = acoustic_size or cfg.acoustic_size
        H, C = cfg.hidden_size, cfg.num_classes
        if cfg.use_bert:
            self.bert_cfg = bert_cfg or BertConfig.base()
            self.bert = BertEncoder(self.bert_cfg, device)
            text_feat = self.bert_cfg.hidden_size
        else:
            self.bert_cfg = None
            self.embed = nn.Parameter(torch.empty(
                vocab_size or cfg.vocab_size, cfg.embedding_size, device=device))
            self.text_extractor = make_tower(cfg, cfg.embedding_size, device)
            text_feat = 4 * cfg.embedding_size
        self.visual_extractor = make_tower(cfg, dv, device)
        self.acoustic_extractor = make_tower(cfg, da, device)
        self.project_t = Projection(text_feat, H, device)
        self.project_v = Projection(4 * dv, H, device)
        self.project_a = Projection(4 * da, H, device)
        for name in ("private_t", "private_v", "private_a", "shared",
                     "recon_t", "recon_v", "recon_a"):
            setattr(self, name, Linear(H, H, device))
        if not cfg.use_cmd_sim:
            self.discriminator = Discriminator(H, device)
        self.sp_discriminator = Linear(H, 4, device)
        self.confidence = Linear(6 * H, C, device)
        self.classifier = Linear(6 * H, C, device)
        self.fusion = TransformerLayer(H, device=device)
        if cfg.use_label_decoder:
            self.label_decoder = LabelDecoder(C, H, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions."""
        for child in self.children():
            child.reset_parameters(generator)
        if not self.cfg.use_bert:
            with torch.no_grad():
                self.embed.normal_(generator=generator)

    def forward(self, batch: Batch, modality_keep: Optional[torch.Tensor] = None,
                recurrence=None, generator: Optional[torch.Generator] = None
                ) -> MISAOutput:
        """recurrence: the recurrence the RNN towers use in place of the
        kernels (the plain version of cfg.rnncell's cell); generator: the
        dropout draws' source in train()."""
        cfg = self.cfg
        act = get_activation(cfg.activation)
        cd = getattr(torch, cfg.compute_dtype)
        H = cfg.hidden_size
        training = self.training

        def drop(x, rate):
            return dropout(x, rate, training, generator)

        visual = batch.visual.to(cd)
        acoustic = batch.acoustic.to(cd)
        if modality_keep is not None:
            mk = modality_keep.to(cd)
            visual = visual * mk[:, 1][:, None, None]
            acoustic = acoustic * mk[:, 2][:, None, None]

        if cfg.use_bert:
            hidden = self.bert(batch.bert_ids, batch.bert_mask, batch.bert_type, cd,
                               training, generator,
                               cfg.resolved_attn_impl(training=training,
                                                      seq_len=batch.bert_ids.shape[1]))
            utt_text = masked_mean(hidden.float(), batch.bert_mask)
        else:
            emb = lookup(self.embed, batch.text).to(cd)
            if modality_keep is not None:
                emb = emb * modality_keep.to(cd)[:, 0][:, None, None]
            utt_text = self.text_extractor(emb, batch.lengths, recurrence)

        v_len = batch.visual_lengths if batch.visual_lengths is not None else batch.lengths
        a_len = batch.acoustic_lengths if batch.acoustic_lengths is not None else batch.lengths
        if cfg.extractor == "transformer":
            utt_video = self.visual_extractor(visual, v_len, recurrence)
            utt_audio = self.acoustic_extractor(acoustic, a_len, recurrence)
        else:
            utt_video, utt_audio = extract_features_pair(
                self.visual_extractor, self.acoustic_extractor, visual, acoustic, v_len,
                a_len, cfg.rnncell, recurrence=recurrence)

        def project(p, x):
            return p.ln(act(p.linear(x.float())))

        orig_t = project(self.project_t, utt_text)
        orig_v = project(self.project_v, utt_video)
        orig_a = project(self.project_a, utt_audio)

        private_t = torch.sigmoid(self.private_t(orig_t))
        private_v = torch.sigmoid(self.private_v(orig_v))
        private_a = torch.sigmoid(self.private_a(orig_a))
        shared_t = torch.sigmoid(self.shared(orig_t))
        shared_v = torch.sigmoid(self.shared(orig_v))
        shared_a = torch.sigmoid(self.shared(orig_a))

        if not cfg.use_cmd_sim:
            def disc(x):
                d = self.discriminator
                h = act(d.l1(reverse_grad(x, cfg.reverse_grad_weight)))
                return d.l2(drop(h, cfg.dropout))

            domain_t, domain_v, domain_a = disc(shared_t), disc(shared_v), disc(shared_a)
        else:
            domain_t = domain_v = domain_a = None

        sp = self.sp_discriminator
        sp_p_t, sp_p_v, sp_p_a = sp(private_t), sp(private_v), sp(private_a)
        sp_s = sp((shared_t + shared_v + shared_a) / 3.0)

        recon_t = self.recon_t(private_t + shared_t)
        recon_v = self.recon_v(private_v + shared_v)
        recon_a = self.recon_a(private_a + shared_a)

        h = torch.stack([private_t, private_v, private_a,
                         shared_t, shared_v, shared_a], dim=1)     # (B, 6, H)
        h_tokens, fusion_attn = self.fusion(h, num_heads=2, dropout_rate=0.1,
                                            training=training, generator=generator)
        h = h_tokens.reshape(h_tokens.shape[0], 6 * H)

        tcp = torch.sigmoid(self.confidence(h))
        if cfg.use_label_decoder:
            ld = self.label_decoder
            tok = h_tokens.float()
            att = torch.einsum("ch,bsh->bcs", ld.embed.float(), tok) / math.sqrt(float(H))
            ctx = torch.einsum("bcs,bsh->bch", torch.softmax(att, dim=-1), tok)
            logits = (ctx * ld.out_w).sum(-1) + ld.out_b
        else:
            logits = self.classifier(h)
        logits = drop(logits, cfg.dropout)
        if cfg.resolved_task() == "regression":
            scores = logits.float()
            labels = scores
        else:
            scores = torch.sigmoid(logits)
            labels = binarize(scores, cfg.threshold)

        return MISAOutput(
            scores=scores, labels=labels, tcp=tcp,
            shared_t=shared_t, shared_v=shared_v, shared_a=shared_a,
            private_t=private_t, private_v=private_v, private_a=private_a,
            orig_t=orig_t, orig_v=orig_v, orig_a=orig_a,
            recon_t=recon_t, recon_v=recon_v, recon_a=recon_a,
            domain_t=domain_t, domain_v=domain_v, domain_a=domain_a,
            sp_p_t=sp_p_t, sp_p_v=sp_p_v, sp_p_a=sp_p_a, sp_s=sp_s,
            fusion_attn=fusion_attn,
        )


def init_misa(cfg, seed: int, device="cpu", **sizes) -> MISA:
    """A MISA model with seeded random weights on `device`.  The weights are
    drawn on the CPU from one `torch.Generator`, so a seed gives the same
    model on every device."""
    model = MISA(cfg, device="cpu", **sizes)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def misa_forward(model: MISA, batch: Batch,
                 modality_keep: Optional[torch.Tensor] = None,
                 recurrence=None, generator: Optional[torch.Generator] = None
                 ) -> MISAOutput:
    """`mmda_tpu.models.misa.misa_forward`; deterministic=True is the
    model's eval() mode."""
    return model(batch, modality_keep, recurrence, generator)
