"""MMIM: hierarchical mutual-information maximization (counterpart of
`mmda_tpu/models/mmim.py`).

Han, Chen and Poria, EMNLP 2021:

1. unimodal features: the text as BERT's masked mean (no `modality_keep`
   on it) or the GloVe text tower (`modality_keep[:, 0]` on the
   embeddings); the visual and acoustic towers of `cfg.extractor` (the RNN
   pair through `extract_features_pair`, `use_pallas_multi` off as in the
   JAX package, so eight `lstm_fwd` a forward and eight `lstm_bwd` a step;
   or the transformer towers), each projected to H with the activation and
   a LayerNorm (`proj_t`, `proj_v`, `proj_a`);
2. low-level MI between the text and each nonverbal modality: a diagonal
   Gaussian q(h_m | h_t) (`lld_tv`, `lld_ta`: MLPs for the mean and the
   log-variance, bounded by tanh x 3) trained by its NLL against the
   detached target h_m (the Barber-Agakov bound);
3. fusion: [h_t; h_v; h_a] through an MLP (`fusion`), dropout on z;
4. high-level MI between z and each unimodal feature: InfoNCE with
   in-batch negatives (`cpc_t`, `cpc_v`, `cpc_a`);
5. the output head (`out`) and the ConfidNet head on z.

`model_aux = {"total": mmim_alpha * nll + mmim_beta * nce, "nll", "nce"}`,
which the objective adds to the task loss.  Everything after the towers
runs in f32.  A `Predictor`'s padded rows enter the InfoNCE batch, as in the
JAX package; the scores do not depend on them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mmda_tpu_torch.models.bert import BertConfig, BertEncoder
from mmda_tpu_torch.models.bilstm import extract_features_pair
from mmda_tpu_torch.models.common import Linear, dropout
from mmda_tpu_torch.models.extractors import make_tower
from mmda_tpu_torch.models.misa import MISAOutput, Projection, classifier_output
from mmda_tpu_torch.ops.functions import get_activation, lookup, masked_mean


def gaussian_nll(mu: torch.Tensor, logvar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean diagonal-Gaussian negative log-likelihood, constant dropped."""
    return 0.5 * torch.mean(logvar + (x - mu) ** 2 / torch.exp(logvar))


def infonce(h: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """InfoNCE with in-batch negatives: h (B, D) the targets, pred (B, D)
    the predictions; scores s[i, j] = h_i . pred_j, the log-softmax over i,
    the diagonal the positives."""
    scores = h @ pred.t()
    return -torch.mean(torch.diagonal(torch.log_softmax(scores, dim=0)))


class MLP(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, d_out: int, device=None):
        super().__init__()
        self.l1 = Linear(d_in, d_hidden, device)
        self.l2 = Linear(d_hidden, d_out, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.l1.reset_parameters(generator)
        self.l2.reset_parameters(generator)

    def forward(self, x: torch.Tensor, act) -> torch.Tensor:
        return self.l2(act(self.l1(x)))


class GaussianPredictor(nn.Module):
    def __init__(self, H: int, device=None):
        super().__init__()
        self.mu = MLP(H, H, H, device)
        self.logvar = MLP(H, H, H, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mu.reset_parameters(generator)
        self.logvar.reset_parameters(generator)

    def nll(self, h_t: torch.Tensor, target: torch.Tensor, act) -> torch.Tensor:
        """-E[log q(target | h_t)]; the target is detached (estimator role)."""
        mu = self.mu(h_t, act)
        logvar = torch.tanh(self.logvar(h_t, act)) * 3.0
        return gaussian_nll(mu, logvar, target.detach())


class MMIM(nn.Module):
    def __init__(self, cfg, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None, vocab_size: Optional[int] = None,
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
        self.proj_t = Projection(text_feat, H, device)
        self.proj_v = Projection(4 * dv, H, device)
        self.proj_a = Projection(4 * da, H, device)
        self.lld_tv = GaussianPredictor(H, device)
        self.lld_ta = GaussianPredictor(H, device)
        self.fusion = MLP(3 * H, 2 * H, H, device)
        self.cpc_t = Linear(H, H, device)
        self.cpc_v = Linear(H, H, device)
        self.cpc_a = Linear(H, H, device)
        self.out = Linear(H, C, device)
        self.confidence = Linear(H, C, device)

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
        """recurrence: the recurrence the RNN towers use in place of the
        kernels (the plain version of cfg.rnncell's cell)."""
        cfg = self.cfg
        act = get_activation(cfg.activation)
        cd = getattr(torch, cfg.compute_dtype)
        training = self.training
        visual = batch.visual.to(cd)
        acoustic = batch.acoustic.to(cd)
        if modality_keep is not None:
            mk = modality_keep.to(cd)
            visual = visual * mk[:, 1][:, None, None]
            acoustic = acoustic * mk[:, 2][:, None, None]

        if cfg.use_bert:
            S = batch.bert_ids.shape[1]
            hidden = self.bert(batch.bert_ids, batch.bert_mask, batch.bert_type, cd, training,
                               generator, cfg.resolved_attn_impl(training=training, seq_len=S))
            utt_t = masked_mean(hidden.float(), batch.bert_mask)
        else:
            emb = lookup(self.embed, batch.text).to(cd)
            if modality_keep is not None:
                emb = emb * modality_keep.to(cd)[:, 0][:, None, None]
            utt_t = self.text_extractor(emb, batch.lengths, recurrence)

        v_len = batch.visual_lengths if batch.visual_lengths is not None else batch.lengths
        a_len = batch.acoustic_lengths if batch.acoustic_lengths is not None else batch.lengths
        if cfg.extractor == "transformer":
            utt_v = self.visual_extractor(visual, v_len, recurrence)
            utt_a = self.acoustic_extractor(acoustic, a_len, recurrence)
        else:
            utt_v, utt_a = extract_features_pair(
                self.visual_extractor, self.acoustic_extractor, visual, acoustic, v_len,
                a_len, cfg.rnncell, recurrence=recurrence)

        def project(p, x):
            return p.ln(act(p.linear(x.float())))

        h_t = project(self.proj_t, utt_t)
        h_v = project(self.proj_v, utt_v)
        h_a = project(self.proj_a, utt_a)
        nll = self.lld_tv.nll(h_t, h_v, act) + self.lld_ta.nll(h_t, h_a, act)

        z = self.fusion(torch.cat([h_t, h_v, h_a], dim=1), act)
        z = dropout(z, cfg.dropout, training, generator)
        nce = (infonce(h_t, self.cpc_t(z)) + infonce(h_v, self.cpc_v(z))
               + infonce(h_a, self.cpc_a(z)))

        tcp = torch.sigmoid(self.confidence(z))
        out = classifier_output(cfg, self.out(z).float(), tcp)
        return out._replace(model_aux={"total": cfg.mmim_alpha * nll + cfg.mmim_beta * nce,
                                       "nll": nll, "nce": nce})
