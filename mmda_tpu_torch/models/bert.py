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
compute dtype); "xla" (the default) is the dense S x S core.  The
injection hook (`inject_layer`, `inject_fn`) sits between layers, outside
the attention core, so it composes with every core and with
`fused_ln_dropout`.

`load_hf_weights` reads a HuggingFace bert checkpoint directory
(`model.safetensors`, read by `utils/safetensors_io.py`, or
`pytorch_model.bin`) into the encoder's state dict: HF's (out, in) dense
weights are already the port's layout, so nothing is transposed (the JAX
package stores their transpose).  `quantize_bert_int8` turns the six encoder
denses of every layer into `QuantizedDense` (weight-only int8, one f32 scale
per output channel) for serving.

`moe_experts > 0` replaces every layer's FFN by a Switch / GShard MoE
(`ops/moe.py::SwitchFFN`, the JAX layout: `moe.gate` (H, E) and E-leading
expert weights), routed per example under `moe_group_by_example`; the layer
then returns its router's aux losses and `bert_encode` returns (hidden, aux)
with each averaged over the layers.  The freeze rule covers a layer's `moe`
with the rest of it; int8 leaves the experts as loaded; `load_hf_weights`
upcycles a dense checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmda_tpu_torch.models.common import LayerNorm, dropout, layer_norm
from mmda_tpu_torch.ops.kernels.attention import flash_attention
from mmda_tpu_torch.ops.kernels.layernorm import residual_dropout_layernorm
from mmda_tpu_torch.ops.kernels.short_attention import short_attention
from mmda_tpu_torch.ops.moe import SwitchFFN, switch_ffn
from mmda_tpu_torch.utils import safetensors_io


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
    moe_experts: int = 0          # > 0: every layer's FFN is a Switch MoE of
                                  # this many experts (ops/moe.py), and
                                  # bert_encode returns (hidden, aux)
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1            # 1 Switch, 2 GShard
    moe_group_by_example: bool = True   # route each example's tokens as a group

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
    (`fused_ln_dropout`; `moe_experts`, `moe_capacity_factor`, `moe_top_k`
    as `mmda_tpu.models.bert.bert_config_for` carries them), for a config
    that uses the BERT tower."""
    if not cfg.use_bert:
        return None
    bc = BertConfig(fused_ln_dropout=bool(getattr(cfg, "fused_ln_dropout", False)))
    if getattr(cfg, "moe_experts", 0) > 0:
        bc = dataclasses.replace(bc, moe_experts=cfg.moe_experts,
                                 moe_capacity_factor=cfg.moe_capacity_factor,
                                 moe_top_k=getattr(cfg, "moe_top_k", 1))
    return bc


def split_aux(out):
    """(hidden, MoE aux losses or None) from what `bert_encode` returned."""
    return out if isinstance(out, tuple) else (out, None)


def apply_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """x @ weight.T accumulated in f32 and rounded to compute_dtype, then
    + bias in compute_dtype.  A matmul whose operands are both in
    compute_dtype accumulates in f32 and rounds its output once."""
    y = torch.matmul(x, weight.to(compute_dtype).t())
    return y + bias.to(compute_dtype)


def apply_quantized_dense(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """The int8 dense, as the JAX package's `_apply_dense` computes it:
    x @ weight_q.T with the int8 values in compute_dtype (exact) and f32
    accumulation, kept in f32; times the per-output-channel scale in f32;
    one rounding to compute_dtype; + bias in compute_dtype.  On the card a
    16-bit product keeps its f32 result (`out_dtype`); elsewhere the f32
    product of the same operands (exact in f32) is the same sum."""
    if x.is_cuda and compute_dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), weight_q.to(compute_dtype).t(),
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = torch.matmul(x.float(), weight_q.float().t())
    return (y * scale.float()).to(compute_dtype) + bias.to(compute_dtype)


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


class QuantizedDense(nn.Module):
    """A `Dense` with weight-only int8 storage (`quantize_dense`): buffers
    `weight_q` (out, in) int8 and `scale` (out,) f32, the bias as loaded."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.bias = nn.Parameter(bias, requires_grad=False)


def quantize_dense(d: Dense) -> QuantizedDense:
    """Per output channel, symmetric: s = max(max |w| over the inputs / 127,
    1e-8), w_q = clip(round(w / s), -127, 127) (round half to even, as
    `jnp.round`), in f32 from the loaded weight."""
    w = d.weight.detach().float()
    s = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-8)
    wq = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return QuantizedDense(wq, s, d.bias.detach().clone())


def dense(x: torch.Tensor, d: nn.Module, compute_dtype: torch.dtype) -> torch.Tensor:
    if isinstance(d, QuantizedDense):
        return apply_quantized_dense(x, d.weight_q, d.scale, d.bias, compute_dtype)
    return apply_dense(x, d.weight, d.bias, compute_dtype)


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
    """q, k, v, attn_out, the two LayerNorms, and the FFN: `ffn_in` and
    `ffn_out`, or with cfg.moe_experts > 0 a `SwitchFFN` `moe`."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.q = Dense(H, H, device)
        self.k = Dense(H, H, device)
        self.v = Dense(H, H, device)
        self.attn_out = Dense(H, H, device)
        if cfg.moe_experts > 0:
            self.moe = SwitchFFN(H, I, cfg.moe_experts, device)
        else:
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
            for name in _QUANT_DENSE_NAMES:
                if hasattr(lp, name):
                    getattr(lp, name).reset_parameters(std, generator)
            if hasattr(lp, "moe"):
                lp.moe.reset_parameters(generator, std)
            lp.attn_ln.reset_parameters()
            lp.ffn_ln.reset_parameters()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16, training: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "xla", inject_layer: Optional[int] = None,
                inject_fn=None):
        return bert_encode(self, input_ids, attention_mask, token_type_ids,
                           compute_dtype, training, generator, attn_impl,
                           inject_layer, inject_fn)


_QUANT_DENSE_NAMES = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")


def quantize_bert_int8(p: BertEncoder) -> BertEncoder:
    """Weight-only int8 for serving (`mmda_tpu.models.bert.quantize_bert_int8`):
    the six denses of every encoder layer become `QuantizedDense`, in place
    (a MoE layer's four: its experts stay as loaded); the embeddings,
    LayerNorms and pooler stay as loaded.  Returns `p`."""
    for lp in p.layers:
        for name in _QUANT_DENSE_NAMES:
            d = getattr(lp, name, None)
            if isinstance(d, Dense):
                setattr(lp, name, quantize_dense(d))
    return p


_HF_LAYER_MAP = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
}


def load_hf_weights(model_dir: str, cfg: Optional[BertConfig] = None
                    ) -> Dict[str, torch.Tensor]:
    """The state dict of a `BertEncoder(cfg)` from a local HuggingFace bert
    checkpoint: `model_dir` holds `model.safetensors` or `pytorch_model.bin`
    (read with `weights_only=True`: the file is a pickle), its names with or
    without the `bert.` prefix.  The tensors keep the file's dtype.  Raises
    FileNotFoundError without either file and KeyError for a missing
    tensor.

    With cfg.moe_experts > 0 the dense FFNs are upcycled (Komatsuzaki et
    al., as the JAX loader does): every expert of layer i is an exact copy
    of the file's FFN, and the router is drawn truncated normal (std 0.02)
    from a `torch.Generator` seeded with i, so loading is reproducible (the
    JAX loader draws it from `fold_in(PRNGKey(0), i)`, which has no torch
    counterpart)."""
    cfg = cfg or BertConfig.base()
    st_path = os.path.join(model_dir, "model.safetensors")
    pt_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        sd = safetensors_io.load_file(st_path)
    elif os.path.exists(pt_path):
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no bert weights under {model_dir}")

    def g(name):
        for prefix in ("bert.", ""):
            if prefix + name in sd:
                return sd[prefix + name]
        raise KeyError(name)

    out = {"embeddings.word": g("embeddings.word_embeddings.weight"),
           "embeddings.position": g("embeddings.position_embeddings.weight"),
           "embeddings.token_type": g("embeddings.token_type_embeddings.weight"),
           "embeddings.ln.weight": g("embeddings.LayerNorm.weight"),
           "embeddings.ln.bias": g("embeddings.LayerNorm.bias"),
           "pooler.weight": g("pooler.dense.weight"),
           "pooler.bias": g("pooler.dense.bias")}
    for i in range(cfg.num_layers):
        base = f"encoder.layer.{i}."
        for ours, theirs in _HF_LAYER_MAP.items():
            out[f"layers.{i}.{ours}.weight"] = g(base + theirs + ".weight")
            out[f"layers.{i}.{ours}.bias"] = g(base + theirs + ".bias")
        for ours, theirs in (("attn_ln", "attention.output.LayerNorm"),
                             ("ffn_ln", "output.LayerNorm")):
            out[f"layers.{i}.{ours}.weight"] = g(base + theirs + ".weight")
            out[f"layers.{i}.{ours}.bias"] = g(base + theirs + ".bias")
        if cfg.moe_experts > 0:
            out.update(_upcycle(out, f"layers.{i}.", i, cfg))
    return out


def _upcycle(sd: Dict[str, torch.Tensor], prefix: str, layer: int, cfg: BertConfig
             ) -> Dict[str, torch.Tensor]:
    """Layer `prefix`'s dense FFN in `sd` (removed from it) as a `SwitchFFN`
    state: each expert a copy of it, the router seeded with the layer index."""
    E = cfg.moe_experts
    w_in, b_in = sd.pop(prefix + "ffn_in.weight"), sd.pop(prefix + "ffn_in.bias")
    w_out, b_out = sd.pop(prefix + "ffn_out.weight"), sd.pop(prefix + "ffn_out.bias")
    gate = torch.empty(cfg.hidden_size, E)
    _trunc_normal_(gate, 0.02, torch.Generator().manual_seed(layer))
    return {prefix + "moe.gate": gate,
            prefix + "moe.w_in": w_in.t().expand(E, -1, -1).contiguous(),
            prefix + "moe.b_in": b_in.expand(E, -1).contiguous(),
            prefix + "moe.w_out": w_out.t().expand(E, -1, -1).contiguous(),
            prefix + "moe.b_out": b_out.expand(E, -1).contiguous()}


def load_hf_encoder(p: BertEncoder, model_dir: str) -> BertEncoder:
    """Copy the checkpoint in `model_dir` into `p` (cast to its dtypes); a
    tensor of the wrong shape, or one missing, raises.  Returns `p`."""
    with torch.no_grad():
        p.load_state_dict(load_hf_weights(model_dir, p.cfg), strict=True)
    return p


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
               attn_impl: str = "xla"):
    """One post-norm encoder layer; key_bias (B * nh, 1, S) additive;
    attn_impl "xla" (the dense core), "flash" (the blockwise kernels) or
    "fused" (the short-sequence kernels).  A MoE layer (cfg.moe_experts > 0)
    returns (x, its router's aux losses), as the JAX layer does."""
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

    qkv_b = torch.cat([lp.q.bias, lp.k.bias, lp.v.bias])
    if isinstance(lp.q, QuantizedDense):      # the per-channel scales concatenate too
        qkv = apply_quantized_dense(
            x, torch.cat([lp.q.weight_q, lp.k.weight_q, lp.v.weight_q], dim=0),
            torch.cat([lp.q.scale, lp.k.scale, lp.v.scale]), qkv_b, cd)
    else:
        qkv = apply_dense(x, torch.cat([lp.q.weight, lp.k.weight, lp.v.weight], dim=0),
                          qkv_b, cd)
    q, k, v = qkv.split(H, dim=-1)

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
    x = residual_ln(x, dense(ctx, lp.attn_out, cd), lp.attn_ln)

    if cfg.moe_experts > 0:
        y, aux = switch_ffn(lp.moe, x.reshape(B * S, H),
                            capacity_factor=cfg.moe_capacity_factor, gelu_exact=cfg.gelu_exact,
                            compute_dtype=cd, groups=B if cfg.moe_group_by_example else 1,
                            top_k=cfg.moe_top_k)
        return residual_ln(x, y.reshape(B, S, H).to(cd), lp.ffn_ln), aux
    h = dense(x, lp.ffn_in, cd)
    if cfg.gelu_exact:
        h = F.gelu(h.float(), approximate="none")
    else:
        h = F.gelu(h, approximate="tanh")
    return residual_ln(x, dense(h.to(cd), lp.ffn_out, cd), lp.ffn_ln)


def bert_encode(p: BertEncoder, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16, training: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "xla", inject_layer: Optional[int] = None,
                inject_fn=None):
    """Last hidden state (B, S, H) of the encoder; dropout when training.
    With cfg.moe_experts > 0, (hidden, aux): each router aux loss averaged
    over the layers (`mmda_tpu.models.bert.bert_encode`).
    attn_impl: "xla", "flash" or "fused", what `Config.resolved_attn_impl`
    gave for this call.  inject_fn, when given, maps the hidden states
    entering layer `inject_layer` (0: the embedding output, after its
    dropout; >= num_layers: the last layer's output), and its result is
    rounded once to compute_dtype (models/mag_bert.py's gate)."""
    cfg = p.cfg
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = bert_embed(p.embeddings, input_ids, token_type_ids, cfg.layer_norm_eps,
                   compute_dtype)
    x = dropout(x, cfg.hidden_dropout, training, generator)
    key_bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, :]     # (B, 1, S)
    key_bias = key_bias.repeat_interleave(cfg.num_heads, dim=0)       # (B*nh, 1, S)
    auxes = []
    for i, lp in enumerate(p.layers):
        if inject_layer is not None and i == inject_layer:
            x = inject_fn(x).to(compute_dtype)
        x = bert_layer(x, lp, cfg, key_bias, compute_dtype, training, generator, attn_impl)
        if cfg.moe_experts > 0:
            x, aux = x
            auxes.append(aux)
    if inject_layer is not None and inject_layer >= cfg.num_layers:
        x = inject_fn(x).to(compute_dtype)
    if cfg.moe_experts > 0:
        return x, {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    return x
