"""BERT encoder (bert-base-uncased architecture).

Counterpart of `mmda_tpu/models/bert.py` (`bert_encode` with its plain and
its flash attention core).  The parameter layout follows the JAX tree
(separate q/k/v denses, HF-compatible names) with PyTorch (out, in) weights;
the forward fuses q/k/v into one product per layer.  Rounding points as in the JAX
package:

* `apply_dense`: f32 accumulation, cast to the compute dtype, then the bias
  added in the compute dtype;
* LayerNorm (eps 1e-12) with f32 statistics, cast back to the input dtype;
* attention logits and softmax in f32 with an additive -1e9 key bias,
  probs cast to the compute dtype for the product with v;
* erf GELU in f32.

Training dropout sits where the JAX package's plain path has it: the
embedding output and both residual branches (`hidden_dropout`), and the f32
attention probs (`attention_dropout`).  `freeze_layers` is `frozen_mask`
(encoder layers <= 8 stop training; embeddings and pooler train, so the
backward still runs through every layer).  With
`BertConfig.fused_ln_dropout` the two per-layer `LN(x + dropout(h))` sites
run as one kernel each when training (`ops/kernels/layernorm.py`: the keep
mask drawn in the kernel from a positional hash under a seed drawn on the
device, regenerated in the backward); the embedding site (dropout after its
LayerNorm) is not one of them.

`attn_impl="flash"` runs the attention core of every layer through the
blockwise kernels of `ops/kernels/attention.py` (q, k, v in the compute
dtype, the key bias per (batch, head), the probs dropout drawn in the kernel
under a per-layer seed drawn on the device, the f32 result rounded to the
compute dtype); `attn_impl="fused"` through the short-sequence kernels of
`ops/kernels/short_attention.py` (all of one (batch item, head) at once, q,
k, v in the compute dtype, the (B, S) key bias, the probs dropout drawn in
the kernel under a per-layer seed drawn on the device, the result in the
compute dtype); "xla" (the default) is the dense S x S core.  MoE FFNs and
int8 weights are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmda_tpu_torch.models.common import LayerNorm, dropout, layer_norm
from mmda_tpu_torch.ops.kernels.attention import flash_attention
from mmda_tpu_torch.ops.kernels.layernorm import residual_dropout_layernorm
from mmda_tpu_torch.ops.kernels.short_attention import short_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    gelu_exact: bool = True       # erf GELU (HF parity); False = tanh approx
    fused_ln_dropout: bool = False  # the 24 per-layer LN(x + dropout(h)) sites
                                    # through the fused kernel when training

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(vocab_size: int = 128) -> "BertConfig":
        """Small config for unit tests."""
        return BertConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64,
                          max_position_embeddings=64)


def bert_config_for(cfg) -> Optional[BertConfig]:
    """BertConfig.base() with the main config's BERT-tower options applied
    (`fused_ln_dropout`), for a config that uses the BERT tower."""
    if not cfg.use_bert:
        return None
    if getattr(cfg, "moe_experts", 0) > 0:
        raise NotImplementedError("moe_experts > 0 is not ported yet")
    return BertConfig(fused_ln_dropout=bool(getattr(cfg, "fused_ln_dropout", False)))


def apply_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """x @ weight.T accumulated in f32 and rounded to compute_dtype, then
    + bias in compute_dtype.  A matmul whose operands are both in
    compute_dtype accumulates in f32 and rounds its output once."""
    y = torch.matmul(x, weight.to(compute_dtype).t())
    return y + bias.to(compute_dtype)


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def reset_parameters(self, std: float, generator: torch.Generator) -> None:
        _trunc_normal_(self.weight, std, generator)
        with torch.no_grad():
            self.bias.zero_()


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H = cfg.hidden_size
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, H, device=device))
        self.position = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, H, device=device))
        self.token_type = nn.Parameter(
            torch.empty(cfg.type_vocab_size, H, device=device))
        self.ln = LayerNorm(H, cfg.layer_norm_eps, device)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.q = Dense(H, H, device)
        self.k = Dense(H, H, device)
        self.v = Dense(H, H, device)
        self.attn_out = Dense(H, H, device)
        self.ffn_in = Dense(H, I, device)
        self.ffn_out = Dense(I, H, device)
        self.attn_ln = LayerNorm(H, cfg.layer_norm_eps, device)
        self.ffn_ln = LayerNorm(H, cfg.layer_norm_eps, device)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """BERT initializer: truncated normal (+-2 std, std 0.02) for the
        tables and dense weights, zero biases, unit LayerNorms."""
        std = self.cfg.initializer_range
        emb = self.embeddings
        for t in (emb.word, emb.position, emb.token_type):
            _trunc_normal_(t, std, generator)
        emb.ln.reset_parameters()
        self.pooler.reset_parameters(std, generator)
        for lp in self.layers:
            for d in (lp.q, lp.k, lp.v, lp.attn_out, lp.ffn_in, lp.ffn_out):
                d.reset_parameters(std, generator)
            lp.attn_ln.reset_parameters()
            lp.ffn_ln.reset_parameters()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16, training: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "xla") -> torch.Tensor:
        return bert_encode(self, input_ids, attention_mask, token_type_ids,
                           compute_dtype, training, generator, attn_impl)


def freeze_layers(p: BertEncoder, max_frozen_layer: int = 8) -> None:
    """Stop training encoder layers 0..max_frozen_layer (the reference's
    freeze rule; `mmda_tpu.models.bert.frozen_mask`)."""
    for i, lp in enumerate(p.layers):
        if i <= max_frozen_layer:
            lp.requires_grad_(False)


def bert_embed(p: BertEmbeddings, input_ids: torch.Tensor,
               token_type_ids: torch.Tensor, eps: float,
               compute_dtype: torch.dtype) -> torch.Tensor:
    # positions beyond the table read its last row, as the JAX package's
    # gather (which clamps an out-of-range index) does at S > max_position
    positions = torch.arange(input_ids.shape[1], device=input_ids.device).clamp(
        max=p.position.shape[0] - 1)
    emb = p.word[input_ids] + p.position[positions][None] + p.token_type[token_type_ids]
    return layer_norm(emb, p.ln.weight, p.ln.bias, eps).to(compute_dtype)


def bert_layer(x: torch.Tensor, lp: BertLayer, cfg: BertConfig,
               key_bias: torch.Tensor, compute_dtype: torch.dtype,
               training: bool = False,
               generator: Optional[torch.Generator] = None,
               attn_impl: str = "xla") -> torch.Tensor:
    """One post-norm encoder layer; key_bias (B * nh, 1, S) additive;
    attn_impl "xla" (the dense core), "flash" (the blockwise kernels) or
    "fused" (the short-sequence kernels)."""
    B, S, H = x.shape
    nh = cfg.num_heads
    hd = H // nh
    cd = compute_dtype
    eps = cfg.layer_norm_eps

    def drop(t, rate):
        return dropout(t, rate, training, generator)

    def device_seed():
        """A kernel's dropout seed, drawn on the device: no host sync."""
        return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=x.device, dtype=torch.int32)

    def residual_ln(x, h, ln):
        """LN(x + dropout(h)): the fused kernel site under fused_ln_dropout
        when training with hidden dropout (LayerNorm statistics are always
        f32 here), else dropout then layer_norm."""
        if cfg.fused_ln_dropout and training and cfg.hidden_dropout > 0.0:
            out = residual_dropout_layernorm(
                x.reshape(B * S, H), h.reshape(B * S, H), ln.weight, ln.bias, device_seed(),
                cfg.hidden_dropout, eps)
            return out.reshape(B, S, H).to(cd)
        return layer_norm(x + drop(h, cfg.hidden_dropout), ln.weight, ln.bias, eps).to(cd)

    qkv_w = torch.cat([lp.q.weight, lp.k.weight, lp.v.weight], dim=0)
    qkv_b = torch.cat([lp.q.bias, lp.k.bias, lp.v.bias])
    q, k, v = apply_dense(x, qkv_w, qkv_b, cd).split(H, dim=-1)

    def heads(t):
        return t.reshape(B, S, nh, hd).transpose(1, 2).reshape(B * nh, S, hd)

    q, k, v = heads(q), heads(k), heads(v)
    if attn_impl == "flash":
        rate = cfg.attention_dropout if training else 0.0
        ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              key_bias[:, 0].contiguous(),
                              device_seed() if rate > 0.0 else None, rate).to(cd)
    elif attn_impl == "xla":
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (1.0 / math.sqrt(hd))
        probs = drop(torch.softmax(logits + key_bias, dim=-1), cfg.attention_dropout)
        ctx = torch.matmul(probs.to(cd), v)
    elif attn_impl == "fused":
        rate = cfg.attention_dropout if training else 0.0
        q, k, v = (t.reshape(B, nh, S, hd).contiguous() for t in (q, k, v))
        ctx = short_attention(q, k, v, key_bias[::nh, 0].contiguous(),
                              device_seed() if rate > 0.0 else None, rate)
    else:
        raise ValueError(f"attn_impl must be xla|flash|fused, got {attn_impl!r}")
    ctx = ctx.reshape(B, nh, S, hd).transpose(1, 2).reshape(B, S, H)
    x = residual_ln(x, apply_dense(ctx, lp.attn_out.weight, lp.attn_out.bias, cd),
                    lp.attn_ln)

    h = apply_dense(x, lp.ffn_in.weight, lp.ffn_in.bias, cd)
    if cfg.gelu_exact:
        h = F.gelu(h.float(), approximate="none")
    else:
        h = F.gelu(h, approximate="tanh")
    return residual_ln(x, apply_dense(h.to(cd), lp.ffn_out.weight, lp.ffn_out.bias, cd),
                       lp.ffn_ln)


def bert_encode(p: BertEncoder, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16, training: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "xla") -> torch.Tensor:
    """Last hidden state (B, S, H) of the encoder; dropout when training.
    attn_impl: "xla", "flash" or "fused", what `Config.resolved_attn_impl`
    gave for this call."""
    cfg = p.cfg
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = bert_embed(p.embeddings, input_ids, token_type_ids, cfg.layer_norm_eps,
                   compute_dtype)
    x = dropout(x, cfg.hidden_dropout, training, generator)
    key_bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, :]     # (B, 1, S)
    key_bias = key_bias.repeat_interleave(cfg.num_heads, dim=0)       # (B*nh, 1, S)
    for lp in p.layers:
        x = bert_layer(x, lp, cfg, key_bias, compute_dtype, training, generator, attn_impl)
    return x
