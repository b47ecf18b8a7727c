"""Short-sequence multi-head attention with dropout drawn in the kernel,
forward and backward: the CUDA kernels' wrappers and their plain versions.

Counterpart of `mmda_tpu/ops/pallas/short_attention.py`: softmax attention
over (B, nh, S, hd) with a (B, S) additive key bias, all of one (batch item,
head) at once (no online softmax, no lse), the attention-probs keep mask
drawn from the short kernels' own positional hash
(`hash_dropout.short_attention_keep_mask`) and regenerated by the backward.
Two kernels: `csrc/short_attn_fwd.cu` (the TPU package's `_fwd_kernel`) and
`csrc/short_attn_bwd.cu` (`_bwd_kernel`).

The rounding sites, the same in the kernels and in the plain versions: q, k,
v widened to f32 and q multiplied by f32(1 / sqrt(hd)) before the product;
every product and the softmax in f32; each output rounded once to the input
type.  Nothing is rounded in between (the flash kernels round the dropped
probabilities and ds to the operand type; these do not).  Both kernels' bf16
instantiations run their products on the tensor cores and keep that
arithmetic: q k^T and do v^T straight from the bf16 inputs (exact products,
f32 sums), `scale` after q k^T and after ds^T q instead of on q first, and
each f32 intermediate (pd, ds) as three bf16 terms (hi, mid, lo: all its 24
bits) times the bf16 input; `expf` and IEEE division as in f32.  They stay
within one bf16 ulp of the plain versions
(`tests/test_torch_short_attention.py` models them on the CPU).  The f32
instantiations are f32 FMAs.

A CUDA tensor goes to the kernels and a CPU tensor to the plain versions.
There is no other route: a CUDA input that a kernel cannot take raises (the
kernels hold one (batch item, head) in a block's shared memory, so they take
S <= 128; longer sequences are `attn_impl="flash"`'s).  The seed is a
one-element int32 tensor on the inputs' device; no wrapper reads it on the
host.  The forward is the op `torch.ops.mmda_tpu_torch.short_attention_fwd`
(`short_attention_fwd_op`, a `torch.library.custom_op` with a fake
implementation): one node in a `torch.export` graph.  Launch counts:
`launch_count("short_attn_fwd")`, `("short_attn_bwd")`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmda_tpu_torch.ops.kernels._launch import (check_tensor, device_of, launch,
                                                launch_count, lib, reset_launch_count)
from mmda_tpu_torch.ops.kernels.hash_dropout import keep_scale, short_attention_keep_mask

SOURCES = ("short_attn_fwd", "short_attn_bwd")
__all__ = ["SOURCES", "launch_count", "reset_launch_count", "MAX_S", "kernel_takes",
           "short_attention_fwd_reference", "short_attention_bwd_reference",
           "short_attention_fwd", "short_attention_fwd_op", "short_attention_bwd",
           "ShortAttention", "short_attention"]
DTYPES = (torch.float32, torch.bfloat16)
MAX_S, MAX_HD = 128, 128          # 4 keys and 4 columns per lane of a row's warp
SMEM_LIMIT = 232448               # bytes of shared memory a block may opt into (H100)
WARPS = 8                         # csrc/short_attn_*.cu kWarps


def softmax_scale(hd: int) -> float:
    """float32(1 / sqrt(hd)), what q is multiplied by before q k^T."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def kernel_takes(S: int, hd: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether both kernels take (S, hd) in `dtype`: S and hd up to 128, and
    in f32 the backward's shared memory (k, v or do or q, pd, ds and the
    warps' rows; csrc/short_attn_bwd.cu smem_bytes), the larger of the two,
    within the card's opt-in limit.  The bf16 kernels hold four padded bf16
    operand tiles at most (141,312 bytes at S = hd = 128), which always fit."""
    if not (1 <= S <= MAX_S and 1 <= hd <= MAX_HD):
        return False
    if dtype == torch.bfloat16:
        return True
    return 4 * (2 * S * (hd + 1) + 2 * S * S + WARPS * 2 * hd) <= SMEM_LIMIT


# ------------------------------------------------------------ plain versions


def _probs(q, k, bias, seed, rate: float):
    """(p, keep): the pre-dropout probabilities (B, nh, S, S) f32 and the
    scaled keep mask (None at rate 0); q * scale f32 as the third."""
    B, nh, S, hd = q.shape
    qs = q.float() * softmax_scale(hd)
    s = torch.matmul(qs, k.float().transpose(-1, -2)) + bias[:, None, None, :]
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    p = p / p.sum(-1, keepdim=True)
    keep = None
    if rate > 0.0:
        b = torch.arange(B, device=q.device).reshape(B, 1, 1, 1)
        h = torch.arange(nh, device=q.device).reshape(1, nh, 1, 1)
        keep = short_attention_keep_mask(S, rate, seed, b, h, device=q.device) * keep_scale(rate)
    return p, keep, qs


def short_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: torch.Tensor, seed: Optional[torch.Tensor],
                                  rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: o in q's dtype."""
    p, keep, _ = _probs(q, k, bias, seed, rate)
    if keep is not None:
        p = p * keep
    return torch.matmul(p, v.float()).to(q.dtype)


def short_attention_bwd_reference(q, k, v, bias, seed, d_out,
                                  rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in q's
    dtype, from the saved inputs and the incoming gradient d_out."""
    p, keep, qs = _probs(q, k, bias, seed, rate)
    do = d_out.float()
    pd = p if keep is None else p * keep
    dv = torch.matmul(pd.transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * softmax_scale(q.shape[-1])
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers


def _check(q, k, v, bias, seed, rate: float, d_out=None) -> torch.device:
    """Raises on what the kernels do not take."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a tensor, got {type(q).__name__}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"q must be (B, nh, S, hd) with every size >= 1, got {tuple(q.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    B, nh, S, hd = q.shape
    dev = device_of(q)
    tensors = [("q", q, q.dtype, q.shape), ("k", k, q.dtype, q.shape),
               ("v", v, q.dtype, q.shape), ("bias", bias, torch.float32, (B, S))]
    if d_out is not None:
        tensors.append(("d_out", d_out, q.dtype, q.shape))
    for name, t, dtype, shape in tensors:
        check_tensor(name, t, q.device, dtype, shape)
    if rate > 0.0:
        if seed is None:
            raise ValueError("rate > 0 needs a seed")
        check_tensor("seed", seed, q.device, torch.int32, (1,))
    if dev.type == "cuda" and not kernel_takes(S, hd, q.dtype):
        raise ValueError(f"the short attention kernels take S <= {MAX_S} and hd <= {MAX_HD} "
                         f"within one block's shared memory, got S={S}, hd={hd} in "
                         f"{q.dtype}: use "
                         'attn_impl="flash" for longer sequences')
    return dev


def _launch_args(q, rate: float):
    B, nh, S, hd = q.shape
    return (B, nh, S, hd, int(q.dtype == torch.bfloat16), softmax_scale(hd),
            float(np.float32(rate)), keep_scale(rate))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
             seed: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """The `short_attention_fwd` op's implementation: the plain version for
    a CPU tensor, the kernel for a CUDA one."""
    dev = _check(q, k, v, bias, seed, rate)
    if dev.type == "cpu":
        return short_attention_fwd_reference(q, k, v, bias, seed, rate)
    so = lib("short_attn_fwd", 6, 5, 3)
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("short_attn_fwd", so.mmda_short_attn_fwd,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
               seed.data_ptr() if rate > 0.0 else None, o.data_ptr(),
               *_launch_args(q, rate), stream)
    return o


@torch.library.custom_op("mmda_tpu_torch::short_attention_fwd", mutates_args=())
def short_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, seed: Optional[torch.Tensor],
                           rate: float) -> torch.Tensor:
    """`torch.ops.mmda_tpu_torch.short_attention_fwd`: one node in a
    `torch.export` graph that runs `_forward` on the real tensors."""
    return _forward(q, k, v, bias, seed, rate)


@short_attention_fwd_op.register_fake
def _(q, k, v, bias, seed, rate):
    return torch.empty_like(q)


def short_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, seed: Optional[torch.Tensor],
                        rate: float = 0.0) -> torch.Tensor:
    """softmax((q / sqrt(hd)) k^T + bias) with dropout, times v, through the
    `mmda_tpu_torch::short_attention_fwd` op.  q, k, v (B, nh, S, hd) f32 or
    bf16 (the same), bias (B, S) f32 additive on keys, seed (1,) int32 on
    the same device (unused at rate 0, may be None).  Returns o (B, nh, S,
    hd) in q's dtype."""
    # here too: with a meta tensor among the arguments the op runs its fake, not _forward
    _check(q, k, v, bias, seed, rate)
    return short_attention_fwd_op(q, k, v, bias, seed, float(rate))


def short_attention_bwd(q, k, v, bias, seed, d_out, rate: float = 0.0):
    """Gradient of `short_attention_fwd`'s o from the saved (q, k, v, bias,
    seed) and d_out (B, nh, S, hd) in q's dtype: (dq, dk, dv) in q's
    dtype."""
    dev = _check(q, k, v, bias, seed, rate, d_out)
    if dev.type == "cpu":
        return short_attention_bwd_reference(q, k, v, bias, seed, d_out, rate)
    so = lib("short_attn_bwd", 9, 5, 3)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("short_attn_bwd", so.mmda_short_attn_bwd,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
               seed.data_ptr() if rate > 0.0 else None, d_out.data_ptr(), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), *_launch_args(q, rate), stream)
    return dq, dk, dv


class ShortAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its backward
    (`short_attention`'s custom_vjp): saves only q, k, v, bias and seed, as
    the TPU kernel does (no S x S tensor is kept); gradients for q, k and v,
    none for the bias and the seed.  It calls the module's
    `short_attention_fwd` and `short_attention_bwd` by name, so a check can
    put their plain versions in their place."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate: float):
        o = short_attention_fwd(q, k, v, bias, seed, rate)
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, seed = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, bias, seed,
                                         d_out.to(q.dtype).contiguous(), ctx.rate)
        return dq, dk, dv, None, None, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    seed: Optional[torch.Tensor] = None, rate: float = 0.0) -> torch.Tensor:
    """Multi-head attention for short sequences with an additive key bias
    and attention-probs dropout drawn in the kernel, differentiable through
    the kernels (`mmda_tpu.ops.pallas.short_attention.short_attention`).
    q, k, v (B, nh, S, hd); bias (B, S).  Returns (B, nh, S, hd) in q's
    dtype."""
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int32, device=q.device)
    return ShortAttention.apply(q, k, v, bias, seed, rate)
