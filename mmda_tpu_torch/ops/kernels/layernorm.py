"""Fused residual + dropout + LayerNorm, forward and backward: the CUDA
kernels' wrappers and their plain versions.

Counterpart of `mmda_tpu/ops/pallas/layernorm.py`: `LN(x + dropout(y)) *
scale + bias` in one kernel (`_fwd_kernel` -> `csrc/ln_dropout_fwd.cu`) with
the keep mask drawn in the kernel from the positional hash of
`hash_dropout`, and a backward (`_bwd_kernel` -> `csrc/ln_dropout_bwd.cu`)
that regenerates the mask and recomputes the statistics from the saved
(x, y), so the mask, the dropout output and the normalised intermediate
never exist in device memory.  Statistics and arithmetic in f32 whatever the
inputs' dtype (f32 or bf16); the output is rounded once to x's dtype.

`residual_dropout_layernorm_fwd` / `_bwd` take a CUDA tensor to the kernel
and a CPU tensor to the plain version (`residual_dropout_layernorm_reference`
/ `_bwd_reference`).  There is no other route: a CUDA input that a kernel
cannot take raises.  The seed is a one-element int32 tensor on the inputs'
device; no wrapper reads it on the host.  A row layout (s_local, s_total,
s0) places the launch's rows among those the mask is drawn over
(`hash_dropout.layout_rows`: each batch item's rows s0 .. s0 + s_local - 1
of s_total, a rank's S-shard under sequence parallelism); the default is
the launch's own rows.  Launch counts:
`launch_count("ln_dropout_fwd")`, `launch_count("ln_dropout_bwd")` (a
backward call launches the rows' pass and the dg/db sum and counts once).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmda_tpu_torch.ops.kernels._launch import (check_tensor, device_of, launch,
                                                launch_count, lib, reset_launch_count,
                                                sm_count)
from mmda_tpu_torch.ops.kernels.hash_dropout import RowLayout, keep_mask, keep_scale

SOURCES = ("ln_dropout_fwd", "ln_dropout_bwd")
__all__ = ["SOURCES", "launch_count", "reset_launch_count",
           "residual_dropout_layernorm_reference", "residual_dropout_layernorm_bwd_reference",
           "residual_dropout_layernorm_fwd", "residual_dropout_layernorm_bwd",
           "ResidualDropoutLayerNorm", "residual_dropout_layernorm"]
WARPS_PER_BLOCK = 4               # csrc/ln_dropout.cuh kWarpsPerBlock: the forward's rows a block
BWD_WARPS = 8                     # csrc/ln_dropout_bwd.cu kWarps: rows a backward block holds
BWD_WARP_MAX_H = 1024             # the widest row the backward holds in a warp's registers;
                                  # wider rows take a block each (csrc/ln_dropout_bwd.cu)
SMEM_OPTIN = 232448               # bytes of shared memory a Hopper block can opt in to
DTYPES = (torch.float32, torch.bfloat16)

BwdResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _z_stats(x, y, seed, rate: float, eps: float, layout: Optional[RowLayout] = None):
    """keep * scale (None at rate 0), zhat and rstd of z = x + dropout(y)."""
    xf, yf = x.float(), y.float()
    keep = None
    if rate > 0.0:
        keep = keep_mask(tuple(y.shape), rate, seed, 0, device=y.device,
                         layout=layout) * keep_scale(rate)
        yf = yf * keep
    z = xf + yf
    mu = z.mean(-1, keepdim=True)
    var = ((z - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return keep, (z - mu) * rstd, rstd


def residual_dropout_layernorm_reference(x: torch.Tensor, y: torch.Tensor,
                                         scale: torch.Tensor, bias: torch.Tensor,
                                         seed: Optional[torch.Tensor], rate: float = 0.0,
                                         eps: float = 1e-12,
                                         layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (mmda_tpu/ops/pallas/
    layernorm.py::_fwd_kernel with the absolute-row hash mask, the rows
    placed by `layout`)."""
    _, zhat, _ = _z_stats(x, y, seed, rate, eps, layout)
    return (zhat * scale.float() + bias.float()).to(x.dtype)


def residual_dropout_layernorm_bwd_reference(x: torch.Tensor, y: torch.Tensor,
                                             scale: torch.Tensor, dout: torch.Tensor,
                                             seed: Optional[torch.Tensor], rate: float = 0.0,
                                             eps: float = 1e-12,
                                             layout: Optional[RowLayout] = None) -> BwdResult:
    """Plain PyTorch version of the backward kernel (::_bwd_kernel).
    Returns (dx, dy, dscale, dbias); the two column sums are taken in f64
    and rounded once."""
    keep, zhat, rstd = _z_stats(x, y, seed, rate, eps, layout)
    do = dout.float()
    dzhat = do * scale.float()
    m1 = dzhat.mean(-1, keepdim=True)
    m2 = (dzhat * zhat).mean(-1, keepdim=True)
    dz = rstd * (dzhat - m1 - zhat * m2)
    dy = dz * keep if keep is not None else dz
    dg = (do * zhat).double().sum(0).float()
    db = do.double().sum(0).float()
    return dz.to(x.dtype), dy.to(y.dtype), dg, db


def _layout(N: int, layout: Optional[RowLayout]) -> RowLayout:
    """The kernels' (s_local, s_total, s0) for `layout` over N rows."""
    if layout is None:
        return (N, N, 0)
    s_local, s_total, s0 = (int(v) for v in layout)
    if s_local < 1 or N % s_local or s_total < 1 or s0 < 0:
        raise ValueError(f"row layout {tuple(layout)} does not place {N} rows: s_local must "
                         "divide them, s_total >= 1, s0 >= 0")
    return s_local, s_total, s0


def _check(x, y, scale, seed, rate: float, extra=()) -> torch.device:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a tensor, got {type(x).__name__}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (N, H) with N, H >= 1, got {tuple(x.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    N, H = x.shape
    check_tensor("y", y, x.device, x.dtype, (N, H))
    for name, t in extra:
        check_tensor(name, t, x.device, x.dtype, (N, H))
    check_tensor("x", x, x.device, x.dtype)
    check_tensor("scale", scale, x.device, torch.float32, (H,))
    if rate > 0.0:
        if seed is None:
            raise ValueError("rate > 0 needs a seed")
        check_tensor("seed", seed, x.device, torch.int32, (1,))
    return device_of(x)


def _vec(H: int, *tensors) -> int:
    """4 values per access when H and every pointer allow 16-byte accesses."""
    return 4 if H % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check_smem(H: int) -> None:
    """The forward keeps each of its rows' z in shared memory (the backward
    takes every H the forward takes)."""
    if WARPS_PER_BLOCK * H * 4 > SMEM_OPTIN:
        raise ValueError(f"row width {H} does not fit the kernel's shared memory")


def residual_dropout_layernorm_fwd(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor, seed: Optional[torch.Tensor],
                                   rate: float = 0.0, eps: float = 1e-12,
                                   layout: Optional[RowLayout] = None) -> torch.Tensor:
    """LN(x + dropout(y)) * scale + bias.  x, y (N, H) f32 or bf16 (the
    same), scale, bias (H,) f32, seed (1,) int32 on the same device (unused
    at rate 0, may be None), the rows placed by `layout` (module docstring).
    Returns (N, H) in x's dtype."""
    dev = _check(x, y, scale, seed, rate)
    check_tensor("bias", bias, x.device, torch.float32, scale.shape)
    N, H = x.shape
    rows = _layout(N, layout)
    if dev.type == "cpu":
        return residual_dropout_layernorm_reference(x, y, scale, bias, seed, rate, eps, layout)
    _check_smem(H)
    so = lib("ln_dropout_fwd", 6, 7, 3)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("ln_dropout_fwd", so.mmda_ln_dropout_fwd,
               x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               seed.data_ptr() if rate > 0.0 else None, out.data_ptr(),
               N, H, *rows, int(x.dtype == torch.bfloat16), _vec(H, x, y, scale, bias, out),
               float(np.float32(rate)), keep_scale(rate), eps, stream)
    return out


def bwd_blocks(N: int, n_sm: int, two_per_sm: bool) -> int:
    """Blocks of the backward's rows pass for rows up to BWD_WARP_MAX_H: as
    many as the SMs hold at once (two of BWD_WARPS warps each where the
    kernel's registers allow it: bf16 rows read 4 values at a time; else
    one), no more than the rows need.  Each block's warps walk the rows
    block * BWD_WARPS + warp + k * blocks * BWD_WARPS, and its dg/db partial
    covers them."""
    return max(1, min(-(-N // BWD_WARPS), (2 if two_per_sm else 1) * n_sm))


def bwd_wide_blocks(N: int, n_sm: int) -> int:
    """Blocks of the backward's rows pass for wider rows: a block a row, two
    an SM, no more than the rows; block i walks the rows i + k * blocks."""
    return max(1, min(N, 2 * n_sm))


def residual_dropout_layernorm_bwd(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                                   dout: torch.Tensor, seed: Optional[torch.Tensor],
                                   rate: float = 0.0, eps: float = 1e-12,
                                   layout: Optional[RowLayout] = None) -> BwdResult:
    """Gradient of `residual_dropout_layernorm_fwd` from the saved (x, y,
    scale, seed) and its row layout: (dx, dy) in x's dtype, (dscale, dbias)
    (H,) f32, summed over this launch's rows."""
    dev = _check(x, y, scale, seed, rate, extra=(("dout", dout),))
    N, H = x.shape
    rows = _layout(N, layout)
    if dev.type == "cpu":
        return residual_dropout_layernorm_bwd_reference(x, y, scale, dout, seed, rate, eps,
                                                        layout)
    _check_smem(H)
    so = lib("ln_dropout_bwd", 10, 8, 3)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    vec = _vec(H, x, y, scale, dout, dx, dy)
    bf16 = x.dtype == torch.bfloat16
    blocks = (bwd_wide_blocks(N, sm_count(dev)) if H > BWD_WARP_MAX_H
              else bwd_blocks(N, sm_count(dev), bf16 and vec == 4))
    dg = torch.empty(H, device=dev)
    db = torch.empty(H, device=dev)
    partial = torch.empty(blocks, 2, H, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("ln_dropout_bwd", so.mmda_ln_dropout_bwd,
               x.data_ptr(), y.data_ptr(), scale.data_ptr(), dout.data_ptr(),
               seed.data_ptr() if rate > 0.0 else None,
               dx.data_ptr(), dy.data_ptr(), dg.data_ptr(), db.data_ptr(),
               partial.data_ptr(),
               N, H, *rows, int(bf16), vec, blocks, float(np.float32(rate)), keep_scale(rate),
               eps,
               stream)
    return dx, dy, dg, db


class ResidualDropoutLayerNorm(torch.autograd.Function):
    """The fused site with the backward kernel as its backward
    (`residual_dropout_layernorm`'s custom_vjp): saves x, y, scale, the
    seed and the row layout; gradients for x, y, scale and bias, none for
    the seed or the layout."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, seed, rate: float, eps: float,
                layout: Optional[RowLayout] = None):
        out = residual_dropout_layernorm_fwd(x, y, scale, bias, seed, rate, eps, layout)
        ctx.save_for_backward(x, y, scale, seed)
        ctx.rate, ctx.eps, ctx.layout = rate, eps, layout
        return out

    @staticmethod
    def backward(ctx, dout):
        x, y, scale, seed = ctx.saved_tensors
        dx, dy, dg, db = residual_dropout_layernorm_bwd(x, y, scale, dout.contiguous(), seed,
                                                        ctx.rate, ctx.eps, ctx.layout)
        return dx, dy, dg, db, None, None, None, None


def residual_dropout_layernorm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, seed: Optional[torch.Tensor] = None,
                               rate: float = 0.0, eps: float = 1e-12,
                               layout: Optional[RowLayout] = None) -> torch.Tensor:
    """LN(x + dropout(y)) * scale + bias, differentiable through the kernels
    (`mmda_tpu.ops.pallas.layernorm.residual_dropout_layernorm`); `layout`
    places the rows among those the mask is drawn over (module docstring)."""
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int32, device=x.device)
    return ResidualDropoutLayerNorm.apply(x, y, scale, bias, seed, rate, eps, layout)
