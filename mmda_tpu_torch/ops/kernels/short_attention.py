"""Short-sequence multi-head attention with dropout drawn in the kernel,
forward and backward: the CUDA kernels' wrappers and their plain versions.

Counterpart of `mmda_tpu/ops/pallas/short_attention.py`: softmax attention
over (B, nh, S, hd) with a (B, S) additive key bias and the exact softmax of
each row, the attention-probs keep mask drawn from the short kernels' own
positional hash (`hash_dropout.short_attention_keep_mask`) and regenerated
by the backward.  The TPU package's `_fwd_kernel` and `_bwd_kernel` are
`csrc/short_attn_fwd.cu` and `short_attn_bwd.cu`, and beyond what one block
holds `csrc/short_attn_tiled_fwd.cu` and `short_attn_tiled_bwd.cu`.

The rounding sites, the same in the kernels and in the plain versions: q, k,
v widened to f32 and q multiplied by f32(1 / sqrt(hd)) before the product;
every product and the softmax in f32; each output rounded once to the input
type.  Nothing is rounded in between (the flash kernels round the dropped
probabilities and ds to the operand type; these do not).  Both kernels' bf16
instantiations run their products on the tensor cores and keep that
arithmetic: q k^T and do v^T straight from the bf16 inputs (exact products,
f32 sums), `scale` after q k^T and after ds^T q instead of on q first, and
each f32 intermediate (pd, ds) as three bf16 terms (hi, mid, lo: all its 24
bits) times the bf16 input.  They stay within one bf16 ulp of the plain
versions (`tests/test_torch_short_attention.py` and, for the tiled kernels,
`tests/test_torch_kernel_domain.py` model them on the CPU).  The f32
instantiations of both routes run on the tensor cores with every f32
operand (q * scale, k, v, do, and the intermediates pd and ds) as three bf16
terms and each product as six term products (hi hi, hi mid, mid hi, hi lo,
lo hi, mid mid: the terms left out weigh 2^-24 and less), q * scale and k
split on each row's grid so that the scores' hi hi sums are exact; the
block kernels sum each product over all S in one fresh f32 accumulator, the
tiled ones sum a tile's products fresh and add them to the running sum in
f32 (`tests/test_torch_f32_terms.py` models both); their sums run in the
tensor cores' order, within the f32 gate of the plain versions.  Each f32
route keeps its f32 FMA design beside it (`_BLOCK_IMPL`, `_TILED_IMPL`).

A CUDA tensor goes to the kernels and a CPU tensor to the plain versions.
There is no other route.  Two pairs of kernels, by shape (`kernel_route`):
one block per (batch item, head) holding all of it in shared memory
(`csrc/short_attn_fwd.cu`, `short_attn_bwd.cu`: S <= 128; the exact
softmax, expf and IEEE division), and over query and key tiles for every
longer S (`csrc/short_attn_tiled_fwd.cu`, `short_attn_tiled_bwd.cu`).  The
tiled forward makes one pass over the key tiles with an online max and sum
(the accumulator rescaled when a tile raises a row's max, times 1 / l once at the
end: within f32 rounding of the exact softmax); its training entry
`short_attention_fwd_train` also returns each query's (m, l) and, in bf16,
o in f32 before its rounding (o32).  The tiled backward takes p = exp(s - m)
(1 / l) from those and r = rowsum(do o32), then a dq kernel and a dk/dv
kernel, each one pass, no atomics; called without them, it forms them first
with the forward's kernel.  The bf16 tiled kernels run on `wgmma` fed by TMA
where hd is a multiple of 8 above 32 (`_TILED_IMPL`), on `mma.sync` fed by
cp.async at the other head dims; the f32 kernels of both routes on `wgmma`
at every head dim (zero-padded to 64 or 128 columns).  Both routes take hd
<= 128; a CUDA input with a wider head raises.  The seed is a one-element
int32 tensor on the inputs' device; no wrapper reads it on the host.  The
forward is the op `torch.ops.mmda_tpu_torch.short_attention_fwd`
(`short_attention_fwd_op`, a
`torch.library.custom_op` with a fake implementation): one node in a
`torch.export` graph, whichever kernel it launches, o alone.  `head0`: q, k
and v hold heads head0 .. head0 + nh - 1 of a larger set (a rank's heads
under tensor parallelism), and each head's keep mask is the one of its
index in that set, h = head0 + the local head; 0, the default, gives every
kernel the bits it gave without it.  Launch counts:
`launch_count("short_attn_fwd")`, `("short_attn_bwd")`,
`("short_attn_tiled_fwd")`, `("short_attn_tiled_bwd")` (a tiled backward
call launches its kernels and counts once).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmda_tpu_torch.ops.kernels._launch import (check_tensor, device_of, launch,
                                                launch_count, lib, reset_launch_count)
from mmda_tpu_torch.ops.kernels.hash_dropout import keep_scale, short_attention_keep_mask

# (forward, backward) of each route: one block per (b, h), or query and key tiles
ROUTE_SOURCES = {"block": ("short_attn_fwd", "short_attn_bwd"),
                 "tiled": ("short_attn_tiled_fwd", "short_attn_tiled_bwd")}
SOURCES = ROUTE_SOURCES["block"] + ROUTE_SOURCES["tiled"]
__all__ = ["SOURCES", "ROUTE_SOURCES", "launch_count", "reset_launch_count", "MAX_S",
           "MAX_HD", "kernel_route", "kernel_takes", "block_smem_bytes",
           "short_attention_fwd_reference", "short_attention_bwd_reference",
           "short_attention_fwd_train_reference", "short_attention_fwd_train",
           "short_attention_fwd", "short_attention_fwd_op", "short_attention_bwd",
           "ShortAttention", "short_attention"]
DTYPES = (torch.float32, torch.bfloat16)
# The tiled kernels' design.  bf16: 0 by shape (wgmma fed by TMA where hd is
# a multiple of 8 above 32, a head's row then a multiple of 16 bytes, and the
# inputs 16-byte aligned; else mma.sync fed by cp.async), 1 mma.sync and
# cp.async at every shape.  f32: 0 six bf16 term products on wgmma at every
# hd, 1 f32 FMAs.  Only a timing or a check that compares the designs sets 1.
_TILED_IMPL = 0
# The f32 block kernels' design: 0 six bf16 term products on wgmma, 1 f32
# FMAs (the bf16 block kernels have one design).  Only a timing or a check
# that compares the designs sets 1.
_BLOCK_IMPL = 0
MAX_S, MAX_HD = 128, 128          # the block kernels
TILED_ROWS = 32                   # the tiled f32 kernels' query and key tiles (the smallest)
SMEM_LIMIT = 232448               # bytes of shared memory a block may opt into (H100)
WARPS = 8                         # csrc/short_attn_*.cu kWarps (the f32 FMA design)


def softmax_scale(hd: int) -> float:
    """float32(1 / sqrt(hd)), what q is multiplied by before q k^T."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def kernel_route(S: int, hd: int, dtype: torch.dtype = torch.float32) -> Optional[str]:
    """Which kernels a CUDA input of (S, hd) in `dtype` goes to: "block" (S
    up to 128 where the block kernels' shared memory fits the card's opt-in
    limit, `block_smem_bytes`), "tiled" for every other S, None where hd is
    outside 1 .. 128.  The bf16 block kernels hold four padded bf16 operand
    tiles at most (141,312 bytes at S = hd = 128) and the f32 ones on the
    tensor cores four slots of three bf16 term tiles at hd <= 64, two above
    it (199,680 bytes at most), so both take every S <= 128; the f32 FMA
    design (`_BLOCK_IMPL` = 1) takes the shapes where its backward's two f32
    S x S tiles and two operand tiles fit, and sends the rest (S = hd = 128)
    to the tiled kernels."""
    if not (S >= 1 and 1 <= hd <= MAX_HD):
        return None
    if S > MAX_S:
        return "tiled"
    return "block" if block_smem_bytes(S, hd, dtype) <= SMEM_LIMIT else "tiled"


def block_smem_bytes(S: int, hd: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of the block backward at (S, hd), the larger of the two
    block kernels' (csrc/short_attn_bwd.cu `mma_smem_bytes` (bf16),
    `f32_wgmma_smem_bytes` (f32 design 0), `smem_bytes` (design 1)), with
    the 1024 bytes the wgmma kernels take to align it."""
    if dtype == torch.bfloat16:
        SP, DP = -(-S // 16) * 16, -(-hd // 16) * 16
        return 4 * SP * (DP + 8) * 2 + 4 * SP * 4
    if _BLOCK_IMPL == 0:
        rows, DP = -(-S // 64) * 64, (64 if hd <= 64 else 128)
        slots = 4 if DP == 64 else 2
        return slots * 3 * rows * DP * 2 + 4 * rows * 4 + 1024
    return 4 * (2 * S * (hd + 1) + 2 * S * S + WARPS * 2 * hd)


def kernel_takes(S: int, hd: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernels take (S, hd) in `dtype`: any S, hd up to 128."""
    return kernel_route(S, hd, dtype) is not None


# ------------------------------------------------------------ plain versions


def _scores(q, k, bias):
    """s = (q * scale) k^T + bias (B, nh, S, S) f32, and q * scale f32."""
    qs = q.float() * softmax_scale(q.shape[-1])
    return torch.matmul(qs, k.float().transpose(-1, -2)) + bias[:, None, None, :], qs


def _keep(q, seed, rate: float, head0: int = 0):
    """The scaled keep mask (B, nh, S, S) f32 of heads head0 .. head0 + nh
    - 1, None at rate 0."""
    if rate == 0.0:
        return None
    B, nh, S, _ = q.shape
    b = torch.arange(B, device=q.device).reshape(B, 1, 1, 1)
    h = torch.arange(head0, head0 + nh, device=q.device).reshape(1, nh, 1, 1)
    return short_attention_keep_mask(S, rate, seed, b, h, device=q.device) * keep_scale(rate)


def _probs(q, k, bias, seed, rate: float, head0: int = 0):
    """(p, keep, qs, m, l): the pre-dropout probabilities (B, nh, S, S) f32,
    the scaled keep mask (None at rate 0), q * scale f32, and each row's max
    m and sum l = sum exp(s - m) (B, nh, S, 1)."""
    s, qs = _scores(q, k, bias)
    m = s.max(-1, keepdim=True).values
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    return e / l, _keep(q, seed, rate, head0), qs, m, l


def short_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: torch.Tensor, seed: Optional[torch.Tensor],
                                  rate: float = 0.0, head0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: o in q's dtype."""
    return short_attention_fwd_train_reference(q, k, v, bias, seed, rate, head0)[0]


def short_attention_fwd_train_reference(q, k, v, bias, seed, rate: float = 0.0,
                                        head0: int = 0):
    """Plain PyTorch version of the training forward: (o in q's dtype, the
    row statistics (B, nh, S, 2) f32 (each query's max m and sum l =
    sum exp(s - m)), o in f32 before its rounding (o itself in f32))."""
    p, keep, _, m, l = _probs(q, k, bias, seed, rate, head0)
    if keep is not None:
        p = p * keep
    o32 = torch.matmul(p, v.float())
    o = o32.to(q.dtype)
    return o, torch.cat((m, l), -1), (o if q.dtype == torch.float32 else o32)


def short_attention_bwd_reference(q, k, v, bias, seed, d_out, rate: float = 0.0,
                                  stats: Optional[torch.Tensor] = None,
                                  o32: Optional[torch.Tensor] = None,
                                  head0: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in q's
    dtype, from the saved inputs and the incoming gradient d_out.  Without
    `stats` it forms p from the exact softmax and r = rowsum(dp p); with the
    training forward's `stats` and `o32` (both or neither) it takes p =
    exp(s - m) (1 / l) and r = rowsum(do o32), as the tiled kernels do."""
    do = d_out.float()
    if stats is None:
        p, keep, qs, _, _ = _probs(q, k, bias, seed, rate, head0)
    else:
        s, qs = _scores(q, k, bias)
        p = torch.exp(s - stats[..., :1]) * (1.0 / stats[..., 1:])
        keep = _keep(q, seed, rate, head0)
    pd = p if keep is None else p * keep
    dv = torch.matmul(pd.transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    if keep is not None:
        dp = dp * keep
    r = (dp * p).sum(-1, keepdim=True) if stats is None else (do * o32).sum(-1, keepdim=True)
    ds = p * (dp - r)
    dq = torch.matmul(ds, k.float()) * softmax_scale(q.shape[-1])
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers


def _check(q, k, v, bias, seed, rate: float, d_out=None, head0: int = 0) -> torch.device:
    """Raises on what the kernels do not take."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a tensor, got {type(q).__name__}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"q must be (B, nh, S, hd) with every size >= 1, got {tuple(q.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if not 0 <= head0 < 2 ** 31 - q.shape[1]:
        raise ValueError(f"head0 must be >= 0 (and head0 + nh an int32), got {head0}")
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
    if dev.type == "cuda":
        if not kernel_takes(S, hd, q.dtype):
            raise ValueError(f"the short attention kernels take hd <= {MAX_HD}, got hd={hd}")
        if B * nh * -(-S // TILED_ROWS) >= 2 ** 31:
            raise ValueError(f"(B, nh, S) = {(B, nh, S)} needs more blocks than a grid has")
    return dev


def _launch_args(q, rate: float, impl: int, head0: int):
    """The C entries' sizes and scalars: B, nh, S, hd, is_bf16, the design
    (`_BLOCK_IMPL` or `_TILED_IMPL`), head0, scale, rate, keep_scale."""
    B, nh, S, hd = q.shape
    return (B, nh, S, hd, int(q.dtype == torch.bfloat16), impl, head0, softmax_scale(hd),
            float(np.float32(rate)), keep_scale(rate))


def _tiled_fwd(q, k, v, bias, seed, rate: float, head0: int, o, stats=None, o32=None):
    """(the tiled forward's C entry, its arguments): o, and the row
    statistics and o32 where given (NULL: not written)."""
    fn = lib("short_attn_tiled_fwd", 8, 7, 3).mmda_short_attn_tiled_fwd
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr() if rate > 0.0 else None, o.data_ptr(),
            None if stats is None else stats.data_ptr(),
            None if o32 is None or o32 is o else o32.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return fn, (*ptrs, *_launch_args(q, rate, _TILED_IMPL, head0), stream)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
             seed: Optional[torch.Tensor], rate: float, head0: int = 0) -> torch.Tensor:
    """The `short_attention_fwd` op's implementation: the plain version for
    a CPU tensor, the kernel for a CUDA one."""
    dev = _check(q, k, v, bias, seed, rate, head0=head0)
    if dev.type == "cpu":
        return short_attention_fwd_reference(q, k, v, bias, seed, rate, head0)
    name = ROUTE_SOURCES[kernel_route(q.shape[2], q.shape[3], q.dtype)][0]
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        if name == "short_attn_tiled_fwd":
            fn, args = _tiled_fwd(q, k, v, bias, seed, rate, head0, o)
            launch(name, fn, *args)
        else:
            stream = torch.cuda.current_stream(dev).cuda_stream
            launch(name, lib(name, 6, 7, 3).mmda_short_attn_fwd,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                   seed.data_ptr() if rate > 0.0 else None, o.data_ptr(),
                   *_launch_args(q, rate, _BLOCK_IMPL, head0), stream)
    return o


@torch.library.custom_op("mmda_tpu_torch::short_attention_fwd", mutates_args=())
def short_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, seed: Optional[torch.Tensor],
                           rate: float, head0: int = 0) -> torch.Tensor:
    """`torch.ops.mmda_tpu_torch.short_attention_fwd`: one node in a
    `torch.export` graph that runs `_forward` on the real tensors."""
    return _forward(q, k, v, bias, seed, rate, head0)


@short_attention_fwd_op.register_fake
def _(q, k, v, bias, seed, rate, head0=0):
    return torch.empty_like(q)


def short_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, seed: Optional[torch.Tensor],
                        rate: float = 0.0, head0: int = 0) -> torch.Tensor:
    """softmax((q / sqrt(hd)) k^T + bias) with dropout, times v, through the
    `mmda_tpu_torch::short_attention_fwd` op.  q, k, v (B, nh, S, hd) f32 or
    bf16 (the same), bias (B, S) f32 additive on keys, seed (1,) int32 on
    the same device (unused at rate 0, may be None), head0 the first
    head's index (module docstring).  Returns o (B, nh, S, hd) in q's
    dtype."""
    # here too: with a meta tensor among the arguments the op runs its fake, not _forward
    _check(q, k, v, bias, seed, rate, head0=head0)
    if head0:
        return short_attention_fwd_op(q, k, v, bias, seed, float(rate), int(head0))
    return short_attention_fwd_op(q, k, v, bias, seed, float(rate))


def short_attention_fwd_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, seed: Optional[torch.Tensor],
                              rate: float = 0.0, head0: int = 0):
    """`short_attention_fwd` that also returns what the tiled backward reads:
    (o, stats, o32) with stats (B, nh, S, 2) f32 each query's row max m and
    sum l = sum exp(s - m) over every key, and o32 (B, nh, S, hd) f32 o before
    its rounding (o itself in f32).  A CUDA input must be on the tiled route
    (`kernel_route`); one `short_attn_tiled_fwd` launch."""
    dev = _check(q, k, v, bias, seed, rate, head0=head0)
    if dev.type == "cpu":
        return short_attention_fwd_train_reference(q, k, v, bias, seed, rate, head0)
    B, nh, S, hd = q.shape
    if kernel_route(S, hd, q.dtype) != "tiled":
        raise ValueError(f"the training forward is the tiled kernels' (S > {MAX_S}), got "
                         f"S={S}, hd={hd}, {q.dtype}")
    o = torch.empty_like(q)
    stats = torch.empty(B, nh, S, 2, device=dev)
    o32 = o if q.dtype == torch.float32 else torch.empty(q.shape, device=dev)
    with torch.cuda.device(dev):
        fn, args = _tiled_fwd(q, k, v, bias, seed, rate, head0, o, stats, o32)
        launch("short_attn_tiled_fwd", fn, *args)
    return o, stats, o32


def short_attention_bwd(q, k, v, bias, seed, d_out, rate: float = 0.0,
                        stats: Optional[torch.Tensor] = None,
                        o32: Optional[torch.Tensor] = None, head0: int = 0):
    """Gradient of `short_attention_fwd`'s o from the saved (q, k, v, bias,
    seed) and d_out (B, nh, S, hd) in q's dtype: (dq, dk, dv) in q's dtype.
    On the tiled route it reads the training forward's `stats` and `o32`
    where given (both or neither), else forms them first in the same call
    (with the forward's kernel: the same bits, one launch counted here)."""
    dev = _check(q, k, v, bias, seed, rate, d_out, head0)
    B, nh, S, hd = q.shape
    if (stats is None) != (o32 is None):
        raise ValueError("stats and o32 go together")
    if stats is not None:
        check_tensor("stats", stats, q.device, torch.float32, (B, nh, S, 2))
        check_tensor("o32", o32, q.device, torch.float32, q.shape)
    if dev.type == "cpu":
        return short_attention_bwd_reference(q, k, v, bias, seed, d_out, rate, stats, o32,
                                             head0)
    route = kernel_route(S, hd, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr() if rate > 0.0 else None, d_out.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr()]
    name = ROUTE_SOURCES[route][1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "block":
            if stats is not None:
                raise ValueError(f"the block kernels (S <= {MAX_S}) take no saved statistics")
            launch(name, lib(name, len(ptrs), 7, 3).mmda_short_attn_bwd, *ptrs,
                   *_launch_args(q, rate, _BLOCK_IMPL, head0), stream)
            return dq, dk, dv
        if stats is None:       # the forward's statistics, within this call
            stats = torch.empty(B, nh, S, 2, device=dev)
            o32 = torch.empty(q.shape, device=dev)
            fwd, args = _tiled_fwd(q, k, v, bias, seed, rate, head0,
                                   o32 if q.dtype == torch.float32 else torch.empty_like(q),
                                   stats, o32)
            err = fwd(*args)
            if err != 0:
                raise RuntimeError(f"short_attn_tiled_fwd kernel launch failed: cudaError {err}")
        r = torch.empty(B, nh, S, device=dev)    # rowsum(do o32) per query
        ptrs += [stats.data_ptr(), o32.data_ptr(), r.data_ptr()]
        launch(name, lib(name, len(ptrs), 7, 3).mmda_short_attn_tiled_bwd, *ptrs,
               *_launch_args(q, rate, _TILED_IMPL, head0), stream)
    return dq, dk, dv


class ShortAttention(torch.autograd.Function):
    """The forward kernel with the backward kernels as its backward
    (`short_attention`'s custom_vjp); gradients for q, k and v, none for the
    bias and the seed.  It saves q, k, v, bias and seed, as the TPU kernel
    does (no S x S tensor is kept), and on the tiled route, when a gradient
    is needed (`train`), also the training forward's row statistics and o32
    (2 f32 a query, and in bf16 hd more), which spare the backward a pass
    over the keys.  It calls the module's `short_attention_fwd`,
    `short_attention_fwd_train` and `short_attention_bwd` by name, so a check
    can put their plain versions in their place."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate: float, train: bool, head0: int = 0):
        # the head offset is passed where there is one (a check may stand in for
        # the functions with positional arguments alone)
        offset = {"head0": head0} if head0 else {}
        if train and kernel_route(*q.shape[2:], q.dtype) == "tiled":
            o, stats, o32 = short_attention_fwd_train(q, k, v, bias, seed, rate, **offset)
            ctx.save_for_backward(q, k, v, bias, seed, stats, o32)
        else:
            o = short_attention_fwd(q, k, v, bias, seed, rate, **offset)
            ctx.save_for_backward(q, k, v, bias, seed)
        ctx.rate, ctx.offset = rate, offset
        return o

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, seed, *saved = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, bias, seed, d_out.to(q.dtype).contiguous(),
                                         ctx.rate, *saved, **ctx.offset)
        return dq, dk, dv, None, None, None, None, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    seed: Optional[torch.Tensor] = None, rate: float = 0.0,
                    head0: int = 0) -> torch.Tensor:
    """Multi-head attention for short sequences with an additive key bias
    and attention-probs dropout drawn in the kernel, differentiable through
    the kernels (`mmda_tpu.ops.pallas.short_attention.short_attention`).
    q, k, v (B, nh, S, hd) heads head0 .. head0 + nh - 1; bias (B, S).
    Returns (B, nh, S, hd) in q's dtype."""
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int32, device=q.device)
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return ShortAttention.apply(q, k, v, bias, seed, rate, train, head0)
