"""Blockwise (flash) attention with dropout drawn in the kernel, forward and
backward: the CUDA kernels' wrappers and their plain versions.

Counterpart of `mmda_tpu/ops/pallas/attention.py`: non-causal attention over
(BH, S, D) with an additive key bias, an online softmax over key tiles so the
S x S probabilities never exist in device memory, the attention-probs keep
mask drawn from the positional hash of `hash_dropout` (regenerated by the
backward), and a blockwise backward from the saved logsumexp.  Three kernels:
`csrc/flash_fwd.cu` (the TPU package's `_flash_kernel` and its ragged twin),
`csrc/flash_bwd_dq.cu` (`_bwd_dq_kernel`), `csrc/flash_bwd_dkv.cu`
(`_bwd_dkv_kernel`); one kernel each serves any S.  All three run their bf16
products on the tensor cores (`mma.sync`, bf16 operands, f32 accumulators,
exp as `ex2.approx` in log2 units) and their f32 products as f32 FMAs (with
`expf`).  The backward kernels take do in the operand type: their wrappers
round the f32 d_out to it once.

The rounding sites, the same in the kernels and in the plain versions:
products of operands in the input type (f32 or bf16) accumulated in f32;
`scale` applied after q k^T; the softmax denominator from the raw
probabilities and the numerator from the dropped ones; the dropped
probabilities rounded to the operand type before `p v` and `pd^T do`; `ds`
rounded before `ds k` and `ds^T q`; `do` rounded to the operand type for the
products but not for `dsum = rowsum(do * o)`; `o` and `lse` f32; dq, dk, dv
in the type of q, k, v.

A CUDA tensor goes to the kernels and a CPU tensor to the plain versions
(which form the whole S x S matrix).  There is no other route: a CUDA input
that a kernel cannot take raises.  The kernels are instantiated at D = 16,
32, 64 and 128; any other D up to 128 runs the next one up on q, k, v (and
do) with zero columns appended and the true `softmax_scale(D)`: a zero
column adds an exact 0 to every product, so no score, probability or kept
column changes, and the pad columns of o, dq, dk and dv are cut off.  The
seed is a one-element int32 tensor on the inputs' device; no wrapper reads
it on the host.  The forward is the op
`torch.ops.mmda_tpu_torch.flash_attention_fwd` (`flash_attention_fwd_op`, a
`torch.library.custom_op` with a fake implementation): one node in a
`torch.export` graph.  `heads` = (heads_local, heads_total, head0): the BH
axis holds heads head0 .. head0 + heads_local - 1 of heads_total for each
batch item (a rank's heads under tensor parallelism), and the keep mask of
local index bh is the one of `hash_dropout.global_bh(bh, heads)`; the
default (1, 1, 0) gives every kernel the bits it gave without it.  Launch
counts:
`launch_count("flash_fwd")`, `("flash_bwd_dq")`, `("flash_bwd_dkv")`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmda_tpu_torch.ops.kernels._launch import (check_tensor, device_of, launch,
                                                launch_count, lib, reset_launch_count)
from mmda_tpu_torch.ops.kernels.hash_dropout import (ALL_HEADS, HeadLayout,
                                                    attention_keep_mask, keep_scale)

SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
__all__ = ["SOURCES", "launch_count", "reset_launch_count",
           "flash_attention_fwd_reference", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "flash_attention_bwd_reference",
           "flash_attention_fwd", "flash_attention_fwd_op", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd", "FlashAttention", "flash_attention"]
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)     # the kernels' instantiations (csrc/flash_common.cuh)
MAX_D = HEAD_DIMS[-1]


def softmax_scale(D: int) -> float:
    """float32(1 / sqrt(D)), what q k^T is multiplied by."""
    return float(np.float32(1.0 / np.sqrt(D)))


# ------------------------------------------------------------ plain versions


def _scores(q, k, bias) -> torch.Tensor:
    """(q k^T) * scale + bias, (BH, S, S) f32."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * softmax_scale(q.shape[-1])
    return s + bias[:, None, :]


def _keep(q, seed, rate: float, heads: HeadLayout = ALL_HEADS) -> Optional[torch.Tensor]:
    """keep * 1 / (1 - rate) over (BH, S, S), None at rate 0."""
    if rate <= 0.0:
        return None
    BH, S, _ = q.shape
    return (attention_keep_mask((BH, S, S), rate, seed, device=q.device, heads=heads)
            * keep_scale(rate))


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: torch.Tensor, seed: Optional[torch.Tensor],
                                  rate: float = 0.0, heads: HeadLayout = ALL_HEADS
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (o f32, lse f32)."""
    s = _scores(q, k, bias)
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    keep = _keep(q, seed, rate, heads)
    pd = p if keep is None else p * keep
    acc = torch.matmul(pd.to(q.dtype).float(), v.float())
    return acc / l, (m + torch.log(l))[..., 0]


def _bwd_tiles(q, k, v, bias, seed, d_out, lse, dsum, rate: float, heads: HeadLayout):
    """What both backward kernels recompute: the true probabilities p, the
    scaled keep mask (None at rate 0), ds rounded to the operand type and do
    rounded to it, all f32."""
    p = torch.exp(_scores(q, k, bias) - lse[:, :, None])
    keep = _keep(q, seed, rate, heads)
    do_t = d_out.to(q.dtype).float()
    dp = torch.matmul(do_t, v.float().transpose(1, 2))
    if keep is not None:
        dp = dp * keep
    ds = (p * (dp - dsum[:, :, None])).to(q.dtype).float()
    return p, keep, ds, do_t


def flash_attention_bwd_dq_reference(q, k, v, bias, seed, d_out, lse, dsum,
                                     rate: float = 0.0,
                                     heads: HeadLayout = ALL_HEADS) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel."""
    _, _, ds, _ = _bwd_tiles(q, k, v, bias, seed, d_out, lse, dsum, rate, heads)
    return (torch.matmul(ds, k.float()) * softmax_scale(q.shape[-1])).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, bias, seed, d_out, lse, dsum,
                                      rate: float = 0.0, heads: HeadLayout = ALL_HEADS
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: (dk, dv)."""
    p, keep, ds, do_t = _bwd_tiles(q, k, v, bias, seed, d_out, lse, dsum, rate, heads)
    pd = (p if keep is None else p * keep).to(q.dtype).float()
    dv = torch.matmul(pd.transpose(1, 2), do_t)
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * softmax_scale(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


def row_dsum(d_out: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """D_i = rowsum(do * o) in f32, from the f32 do (before it is rounded to
    the operand type): an elementwise pass outside the kernels, as in the TPU
    package."""
    return (d_out.float() * o).sum(-1)


def flash_attention_bwd_reference(q, k, v, bias, seed, lse, o, d_out, rate: float = 0.0,
                                  heads: HeadLayout = ALL_HEADS):
    """Plain PyTorch version of the whole backward: (dq, dk, dv)."""
    dsum = row_dsum(d_out, o)
    dq = flash_attention_bwd_dq_reference(q, k, v, bias, seed, d_out, lse, dsum, rate, heads)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, bias, seed, d_out, lse, dsum, rate,
                                               heads)
    return dq, dk, dv


# ------------------------------------------------------------------ wrappers


def _check(q, k, v, bias, seed, rate: float, f32_like=(), vectors=(),
           pointers: bool = True, heads: HeadLayout = ALL_HEADS) -> torch.device:
    """Raises on what the kernels do not take.  f32_like: (name, tensor) that
    must be (BH, S, D) f32; vectors: (name, tensor) that must be (BH, S) f32.
    pointers=False leaves out the alignment of the data (which a tensor being
    traced by `torch.export` has not got)."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a tensor, got {type(q).__name__}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or min(q.shape) < 1:
        raise ValueError(f"q must be (BH, S, D) with BH, S, D >= 1, got {tuple(q.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    BH, S, D = q.shape
    heads_local, heads_total, head0 = heads
    if not (1 <= heads_local and 0 <= head0 and head0 + heads_local <= heads_total
            and BH % heads_local == 0 and BH // heads_local * heads_total < 2 ** 31):
        raise ValueError(f"heads=(heads_local, heads_total, head0) must have heads_local "
                         f"dividing BH={BH} and head0 + heads_local <= heads_total, got "
                         f"{tuple(heads)}")
    dev = device_of(q)
    tensors = [("q", q, q.dtype, (BH, S, D)), ("k", k, q.dtype, (BH, S, D)),
               ("v", v, q.dtype, (BH, S, D)), ("bias", bias, torch.float32, (BH, S))]
    tensors += [(name, t, torch.float32, (BH, S, D)) for name, t in f32_like]
    tensors += [(name, t, torch.float32, (BH, S)) for name, t in vectors]
    for name, t, dtype, shape in tensors:
        check_tensor(name, t, q.device, dtype, shape)
    if rate > 0.0:
        if seed is None:
            raise ValueError("rate > 0 needs a seed")
        check_tensor("seed", seed, q.device, torch.int32, (1,))
    if dev.type == "cuda":
        if not 1 <= D <= MAX_D:
            raise ValueError(f"the attention kernels take D <= {MAX_D}, got {D}")
        if BH * -(-S // 64) >= 2 ** 31:
            raise ValueError(f"(BH, S) = {(BH, S)} needs more blocks than a grid has")
        for name, t, _, _ in (tensors if pointers else ()):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    return dev


def kernel_head_dim(D: int) -> int:
    """The instantiation a head dim D runs: the least of HEAD_DIMS >= D."""
    return next(d for d in HEAD_DIMS if d >= D)


def _pad_heads(D: int, *tensors):
    """(BH, S, D) tensors with zero columns appended up to the kernels'
    instantiation for D (the tensors themselves where D is one)."""
    pad = kernel_head_dim(D) - D
    return tuple(torch.nn.functional.pad(t, (0, pad)) if pad else t for t in tensors)


def _launch_args(q, rate: float, D: int, heads: HeadLayout):
    """The C entries' shape and scalars for q (BH, S, kernel D) holding a
    head dim D: the scale is the true one; the head layout."""
    BH, S, DK = q.shape
    return (BH, S, DK, int(q.dtype == torch.bfloat16), *heads, softmax_scale(D),
            float(np.float32(rate)), keep_scale(rate))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
             seed: Optional[torch.Tensor], rate: float,
             heads: HeadLayout = ALL_HEADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `flash_attention_fwd` op's implementation: the plain version for
    a CPU tensor, the kernel for a CUDA one."""
    dev = _check(q, k, v, bias, seed, rate, heads=heads)
    if dev.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, bias, seed, rate, heads)
    so = lib("flash_fwd", 7, 7, 3)
    BH, S, D = q.shape
    qp, kp, vp = _pad_heads(D, q, k, v)
    o = torch.empty(BH, S, qp.shape[-1], device=dev, dtype=torch.float32)
    lse = torch.empty(BH, S, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("flash_fwd", so.mmda_flash_fwd,
               qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), bias.data_ptr(),
               seed.data_ptr() if rate > 0.0 else None, o.data_ptr(), lse.data_ptr(),
               *_launch_args(qp, rate, D, heads), stream)
    return (o if o.shape[-1] == D else o[..., :D].contiguous()), lse


@torch.library.custom_op("mmda_tpu_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, seed: Optional[torch.Tensor],
                           rate: float, heads_local: int = 1, heads_total: int = 1,
                           head0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """`torch.ops.mmda_tpu_torch.flash_attention_fwd`: one node in a
    `torch.export` graph that runs `_forward` on the real tensors."""
    return _forward(q, k, v, bias, seed, rate, (heads_local, heads_total, head0))


@flash_attention_fwd_op.register_fake
def _(q, k, v, bias, seed, rate, heads_local=1, heads_total=1, head0=0):
    BH, S, D = q.shape
    return (q.new_empty(BH, S, D, dtype=torch.float32),
            q.new_empty(BH, S, dtype=torch.float32))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, seed: Optional[torch.Tensor],
                        rate: float = 0.0, heads: HeadLayout = ALL_HEADS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax((q k^T) / sqrt(D) + bias) with dropout, times v, through the
    `mmda_tpu_torch::flash_attention_fwd` op.  q, k, v (BH, S, D) f32 or
    bf16 (the same), bias (BH, S) f32 additive on keys, seed (1,) int32 on
    the same device (unused at rate 0, may be None), `heads` the head
    layout (module docstring).  Returns (o (BH, S, D) f32, lse (BH, S)
    f32)."""
    # here too: with a meta tensor among the arguments the op runs its fake, not _forward
    heads = tuple(int(h) for h in heads)
    _check(q, k, v, bias, seed, rate, pointers=False, heads=heads)
    if heads != ALL_HEADS:
        return flash_attention_fwd_op(q, k, v, bias, seed, float(rate), *heads)
    return flash_attention_fwd_op(q, k, v, bias, seed, float(rate))


def _bwd_launch(name: str, n_outs: int, q, k, v, bias, seed, do_t, lse, dsum, rate: float,
                heads: HeadLayout):
    """Launch the backward kernel `name` on d_out already rounded to the
    operand type (`do_t`); returns its n_outs outputs, each in q's shape.
    q, k, v and do_t get the kernels' zero columns where D needs them."""
    D = q.shape[-1]
    q, k, v, do_t = _pad_heads(D, q, k, v, do_t)
    padded = [torch.empty_like(q) for _ in range(n_outs)]
    so = lib(name, 8 + n_outs, 7, 3)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch(name, getattr(so, f"mmda_{name}"),
               q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
               seed.data_ptr() if rate > 0.0 else None, do_t.data_ptr(), lse.data_ptr(),
               dsum.data_ptr(), *(t.data_ptr() for t in padded),
               *_launch_args(q, rate, D, heads), stream)
    return tuple(t if t.shape[-1] == D else t[..., :D].contiguous() for t in padded)


def _check_bwd(q, k, v, bias, seed, d_out, lse, dsum, rate: float,
               heads: HeadLayout = ALL_HEADS) -> torch.device:
    return _check(q, k, v, bias, seed, rate, f32_like=(("d_out", d_out),),
                  vectors=(("lse", lse), ("dsum", dsum)), heads=heads)


def flash_attention_bwd_dq(q, k, v, bias, seed, d_out, lse, dsum, rate: float = 0.0,
                           heads: HeadLayout = ALL_HEADS) -> torch.Tensor:
    """dq from the saved lse and dsum = rowsum(do * o); d_out (BH, S, D) f32,
    lse and dsum (BH, S) f32.  Returns dq in q's dtype.  The kernel takes do
    in the operand type: d_out is rounded to it once here."""
    args = (q, k, v, bias, seed, d_out, lse, dsum, rate, tuple(heads))
    if _check_bwd(*args).type == "cpu":
        return flash_attention_bwd_dq_reference(*args)
    return _bwd_launch("flash_bwd_dq", 1, q, k, v, bias, seed,
                       d_out.to(q.dtype), lse, dsum, rate, tuple(heads))[0]


def flash_attention_bwd_dkv(q, k, v, bias, seed, d_out, lse, dsum, rate: float = 0.0,
                            heads: HeadLayout = ALL_HEADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the saved lse and dsum, in the dtype of k and v; d_out
    f32, rounded to the operand type once here."""
    args = (q, k, v, bias, seed, d_out, lse, dsum, rate, tuple(heads))
    if _check_bwd(*args).type == "cpu":
        return flash_attention_bwd_dkv_reference(*args)
    return _bwd_launch("flash_bwd_dkv", 2, q, k, v,
                       bias, seed, d_out.to(q.dtype), lse, dsum, rate, tuple(heads))


def flash_attention_bwd(q, k, v, bias, seed, lse, o, d_out, rate: float = 0.0,
                        heads: HeadLayout = ALL_HEADS):
    """Gradient of `flash_attention_fwd`'s o from the saved (q, k, v, bias,
    seed, lse, o) and the f32 d_out: (dq, dk, dv).  dsum comes from the f32
    d_out; on the card d_out is rounded to the operand type once and both
    kernels read that copy."""
    dsum = row_dsum(d_out, o)
    heads = tuple(heads)
    args = (q, k, v, bias, seed, d_out, lse, dsum, rate, heads)
    if _check_bwd(*args).type == "cpu":
        return (flash_attention_bwd_dq_reference(*args),
                *flash_attention_bwd_dkv_reference(*args))
    do_t = d_out.to(q.dtype)
    rest = (q, k, v, bias, seed, do_t, lse, dsum, rate, heads)
    dq, = _bwd_launch("flash_bwd_dq", 1, *rest)
    dk, dv = _bwd_launch("flash_bwd_dkv", 2, *rest)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the dq and dk/dv kernels as its backward
    (`flash_attention`'s custom_vjp): saves q, k, v, bias, seed, lse and o;
    gradients for q, k and v, none for the bias and the seed.  It calls the
    module's `flash_attention_fwd` and `flash_attention_bwd` by name, so a
    check can put their plain versions in their place."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate: float, heads: HeadLayout = ALL_HEADS):
        # the layout is passed where it is not the default (a check may stand in
        # for the functions with positional arguments alone)
        layout = {"heads": heads} if tuple(heads) != ALL_HEADS else {}
        o, lse = flash_attention_fwd(q, k, v, bias, seed, rate, **layout)
        ctx.save_for_backward(q, k, v, bias, seed, lse, o)
        ctx.rate, ctx.layout = rate, layout
        return o

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, seed, lse, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, seed, lse, o,
                                         d_out.float().contiguous(), ctx.rate, **ctx.layout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    seed: Optional[torch.Tensor] = None, rate: float = 0.0,
                    heads: HeadLayout = ALL_HEADS) -> torch.Tensor:
    """Non-causal attention with an additive key bias and attention-probs
    dropout drawn in the kernel, differentiable through the kernels
    (`mmda_tpu.ops.pallas.attention.flash_attention`); `heads` the head
    layout of the BH axis (module docstring).  Returns o (BH, S, D) f32."""
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int32, device=q.device)
    return FlashAttention.apply(q, k, v, bias, seed, rate, tuple(heads))
