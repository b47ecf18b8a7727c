"""Several masked LSTM recurrences in one launch, forward and backward: the
CUDA kernels' wrappers, their plain versions, and the packing of a tower
pair's directions.

Counterpart of `mmda_tpu/ops/pallas/lstm_multi.py`: D independent
directions (the two towers' forward and reverse scans of one stacked
layer) in one forward launch (`csrc/lstm_multi_fwd.cu`, the TPU package's
`_fwd_kernel`) and one backward launch (`csrc/lstm_multi_bwd.cu`,
`_bwd_kernel`: BPTT and dW_hh for all D).  Each direction keeps its true
hidden size: the TPU kernel pads every direction to 128 lanes (its matrix
unit's tile) and time-flips the reverse ones; here a direction is a list
entry at its own H with a reverse flag, as `lstm.py`'s kernels take it, and
the numbers are the same.

`lstm_multi_recurrence` and `lstm_multi_recurrence_bwd` take CUDA tensors to
the kernels and CPU tensors to the plain versions (each direction through
`lstm.py`'s plain version).  There is no other route: a CUDA input that a
kernel cannot take raises.  Launch counts: `launch_count("lstm_multi_fwd")`,
`("lstm_multi_bwd")`, one per wrapper call for all D directions.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from mmda_tpu_torch.ops.kernels._launch import (MAX_THREADS, check_tensor, device_of,
                                                launch, launch_count, lib,
                                                reset_launch_count, rows_per_block,
                                                sm_count)
from mmda_tpu_torch.ops.kernels.lstm import (dw_splits, lstm_recurrence_bwd_reference,
                                             lstm_recurrence_reference)

SOURCES = ("lstm_multi_fwd", "lstm_multi_bwd")
__all__ = ["SOURCES", "launch_count", "reset_launch_count", "MAX_DIRS",
           "lstm_multi_recurrence", "lstm_multi_recurrence_reference",
           "lstm_multi_recurrence_bwd", "lstm_multi_recurrence_bwd_reference",
           "LSTMMultiRecurrence", "lstm_scan_multi", "project_inputs", "pack_directions",
           "unpack_outputs"]
MAX_DIRS = 8                      # csrc/lstm_multi_*.cu kMaxDirs

Tensors = List[torch.Tensor]


def _check(x_proj: Sequence, w_hh_t: Sequence, mask: Sequence,
           reverse: Sequence) -> torch.device:
    """Raises on what the kernels do not take: D in 1..MAX_DIRS directions
    of (T, B, 4H_d) x_proj, (H_d, 4H_d) w_hh_t and (T, B) mask, f32,
    contiguous, on one device, with the same T and B."""
    D = len(x_proj)
    if not 1 <= D <= MAX_DIRS:
        raise ValueError(f"1 to {MAX_DIRS} directions, got {D}")
    if not len(w_hh_t) == len(mask) == len(reverse) == D:
        raise ValueError("x_proj, w_hh_t, mask and reverse must have one entry per direction")
    if not isinstance(x_proj[0], torch.Tensor):
        raise TypeError(f"x_proj must hold tensors, got {type(x_proj[0]).__name__}")
    dev = x_proj[0].device
    for d in range(D):
        check_tensor(f"x_proj[{d}]", x_proj[d], dev)
        if x_proj[d].dim() != 3 or x_proj[d].shape[-1] % 4 or min(x_proj[d].shape) < 1:
            raise ValueError(f"x_proj[{d}] must be (T, B, 4H), got {tuple(x_proj[d].shape)}")
        T, B, G = x_proj[d].shape
        if (T, B) != tuple(x_proj[0].shape[:2]):
            raise ValueError(f"x_proj[{d}] has (T, B) = {(T, B)}, direction 0 "
                             f"{tuple(x_proj[0].shape[:2])}")
        check_tensor(f"w_hh_t[{d}]", w_hh_t[d], dev, shape=(G // 4, G))
        check_tensor(f"mask[{d}]", mask[d], dev, shape=(T, B))
    return device_of(x_proj[0])


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (None: null)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def _geometry(x_proj, dev) -> Tuple[List[int], int, int]:
    """(H per direction, rows per block, h_max): the block is sized for the
    largest H, and the B rows are spread over the SMs the directions share."""
    hs = [x.shape[-1] // 4 for x in x_proj]
    h_max = max(hs)
    if h_max > MAX_THREADS:
        raise ValueError(f"hidden size {h_max} > {MAX_THREADS} is not supported by the kernel")
    B = x_proj[0].shape[1]
    rows = rows_per_block(B, h_max, max(1, sm_count(dev) // len(x_proj)))
    return hs, rows, h_max


# ------------------------------------------------------------------ forward


def lstm_multi_recurrence_reference(x_proj: Sequence[torch.Tensor],
                                    w_hh_t: Sequence[torch.Tensor],
                                    mask: Sequence[torch.Tensor], reverse: Sequence[bool],
                                    need_cs: bool = False):
    """Plain PyTorch version of the forward kernel: `lstm.py`'s plain
    recurrence per direction.  Returns (ys, cs or None, h_fin), lists."""
    outs = [lstm_recurrence_reference(x, w, m, bool(r), need_cs)
            for x, w, m, r in zip(x_proj, w_hh_t, mask, reverse)]
    return ([o[0] for o in outs], [o[1] for o in outs] if need_cs else None,
            [o[2] for o in outs])


def lstm_multi_recurrence(x_proj: Sequence[torch.Tensor], w_hh_t: Sequence[torch.Tensor],
                          mask: Sequence[torch.Tensor], reverse: Sequence[bool],
                          need_cs: bool = False):
    """D masked LSTM recurrences over time-major inputs in one launch.

    Per direction d: x_proj[d] (T, B, 4H_d) f32 = x @ W_ih^T + b_ih + b_hh,
    gates i, f, g, o; w_hh_t[d] (H_d, 4H_d) f32; mask[d] (T, B) f32 in
    {0, 1}; reverse[d] walks t = T-1..0.  T and B are shared, H_d not.
    Returns lists ys (T, B, H_d) (carry held at masked steps), cs (when
    need_cs, else None) and h_fin (B, H_d)."""
    dev = _check(x_proj, w_hh_t, mask, reverse)
    if dev.type == "cpu":
        return lstm_multi_recurrence_reference(x_proj, w_hh_t, mask, reverse, need_cs)
    T, B, _ = x_proj[0].shape
    hs, rows, _ = _geometry(x_proj, dev)
    ys = [torch.empty(T, B, H, device=dev) for H in hs]
    cs = [torch.empty(T, B, H, device=dev) for H in hs] if need_cs else None
    h_fin = [torch.empty(B, H, device=dev) for H in hs]
    arrays = [_ptrs(x_proj), _ptrs(w_hh_t), _ptrs(mask), _ptrs(ys),
              _ptrs(cs if need_cs else [None] * len(hs)), _ptrs(h_fin), _ints(hs),
              _ints(reverse)]
    so = lib("lstm_multi_fwd", 8, 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("lstm_multi_fwd", so.mmda_lstm_multi_fwd,
               *[ctypes.addressof(a) for a in arrays], len(hs), T, B, rows, stream)
    return ys, cs, h_fin


# ----------------------------------------------------------------- backward


def lstm_multi_recurrence_bwd_reference(x_proj, w_hh_t, mask, reverse, ys, cs, dys, dh_fin):
    """Plain PyTorch version of the backward kernel: `lstm.py`'s plain BPTT
    per direction (dc_fin = 0, dW_hh summed in f64).  Returns lists
    (dx_proj, dw_hh_t)."""
    outs = [lstm_recurrence_bwd_reference(x, w, m, y, c, dy, dh, None, bool(r))
            for x, w, m, r, y, c, dy, dh in zip(x_proj, w_hh_t, mask, reverse, ys, cs, dys,
                                                dh_fin)]
    return [o[0] for o in outs], [o[1] for o in outs]


def lstm_multi_recurrence_bwd(x_proj: Sequence[torch.Tensor], w_hh_t: Sequence[torch.Tensor],
                              mask: Sequence[torch.Tensor], reverse: Sequence[bool],
                              ys: Sequence[torch.Tensor], cs: Sequence[torch.Tensor],
                              dys: Sequence[torch.Tensor], dh_fin: Sequence[torch.Tensor]):
    """Gradient of `lstm_multi_recurrence` (BPTT with the gates recomputed
    from the saved ys, cs) for all D directions in one launch.  dys[d]
    (T, B, H_d) and dh_fin[d] (B, H_d) are the incoming gradients.  Returns
    lists dx_proj (T, B, 4H_d) and dw_hh_t (H_d, 4H_d), f32."""
    dev = _check(x_proj, w_hh_t, mask, reverse)
    T, B, _ = x_proj[0].shape
    for d, x in enumerate(x_proj):
        H = x.shape[-1] // 4
        for name, t, shape in (("ys", ys, (T, B, H)), ("cs", cs, (T, B, H)),
                               ("dys", dys, (T, B, H)), ("dh_fin", dh_fin, (B, H))):
            check_tensor(f"{name}[{d}]", t[d], dev, shape=shape)
    if dev.type == "cpu":
        return lstm_multi_recurrence_bwd_reference(x_proj, w_hh_t, mask, reverse, ys, cs,
                                                   dys, dh_fin)
    hs, rows, h_max = _geometry(x_proj, dev)
    splits = dw_splits(T, h_max, max(1, sm_count(dev) // len(hs)))
    dx = [torch.empty(T, B, 4 * H, device=dev) for H in hs]
    dw = [torch.empty(H, 4 * H, device=dev) for H in hs]
    dw_partial = torch.empty(len(hs) * splits, h_max, 4 * h_max, dtype=torch.float64,
                             device=dev)
    arrays = [_ptrs(x_proj), _ptrs(w_hh_t), _ptrs(mask), _ptrs(ys), _ptrs(cs), _ptrs(dys),
              _ptrs(dh_fin), _ptrs(dx), _ptrs(dw)]
    ints = [_ints(hs), _ints(reverse)]
    so = lib("lstm_multi_bwd", 12, 5)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("lstm_multi_bwd", so.mmda_lstm_multi_bwd,
               *[ctypes.addressof(a) for a in arrays], dw_partial.data_ptr(),
               *[ctypes.addressof(a) for a in ints], len(hs), T, B, rows, splits, stream)
    return dx, dw


class LSTMMultiRecurrence(torch.autograd.Function):
    """(ys..., h_fin...) of D recurrences with the multi BPTT kernel as
    their backward (`lstm_scan_multi`'s custom_vjp): the forward saves ys and
    cs, the backward feeds dc_fin = 0.  Arguments: the reverse flags, then
    the D x_proj, the D w_hh_t and the D masks; masks get no gradient."""

    @staticmethod
    def forward(ctx, reverse, *operands):
        D = len(reverse)
        x_proj, w_hh_t, mask = operands[:D], operands[D:2 * D], operands[2 * D:]
        ys, cs, h_fin = lstm_multi_recurrence(x_proj, w_hh_t, mask, reverse, need_cs=True)
        ctx.save_for_backward(*x_proj, *w_hh_t, *mask, *ys, *cs)
        ctx.reverse = reverse
        return (*ys, *h_fin)

    @staticmethod
    def backward(ctx, *grads):
        D = len(ctx.reverse)
        saved = ctx.saved_tensors
        x_proj, w_hh_t, mask, ys, cs = (saved[i * D:(i + 1) * D] for i in range(5))
        dys = [g.contiguous() for g in grads[:D]]
        dh_fin = [g.contiguous() for g in grads[D:]]
        dx, dw = lstm_multi_recurrence_bwd(x_proj, w_hh_t, mask, ctx.reverse, ys, cs, dys,
                                           dh_fin)
        return (None, *dx, *dw, *([None] * D))


def lstm_scan_multi(x_proj: Sequence[torch.Tensor], w_hh_t: Sequence[torch.Tensor],
                    mask: Sequence[torch.Tensor], reverse: Sequence[bool]
                    ) -> Tuple[Tensors, Tensors]:
    """(ys, h_fin) lists of D recurrences, differentiable through the two
    kernels (`mmda_tpu.ops.pallas.lstm_multi.lstm_scan_multi`, at each
    direction's true H, masks (T, B), reverse a flag instead of a flip)."""
    D = len(x_proj)
    out = LSTMMultiRecurrence.apply(tuple(bool(r) for r in reverse), *x_proj, *w_hh_t, *mask)
    return list(out[:D]), list(out[D:])


# ------------------------------------------------------------------ packing


def project_inputs(w_ih: torch.Tensor, b_ih: torch.Tensor, x: torch.Tensor,
                   b_hh: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The input projection hoisted out of a recurrence: x (B, T, F) @
    w_ih^T + b_ih (+ b_hh, which the LSTM folds in), f32, time-major
    (T, B, G) and contiguous.  x in bf16 multiplies w_ih rounded to bf16
    with f32 accumulation: both operands are upcast exactly, then multiplied
    in f32."""
    B, T, F = x.shape
    x_proj = torch.matmul(x.reshape(B * T, F).float(),
                          w_ih.to(x.dtype).float().t()).reshape(B, T, -1)
    x_proj = x_proj + b_ih.float()
    if b_hh is not None:
        x_proj = x_proj + b_hh.float()
    return x_proj.transpose(0, 1).contiguous()


def pack_directions(dirs):
    """The kernels' operands for D work items (`lstm_multi.pack_directions`
    without the padding to 128 lanes and the time flip).

    dirs: (params, x, mask, reverse) per direction, params with the torch
    layout w_ih (4H, F), w_hh (4H, H), b_ih, b_hh (an `LSTMDirection`), x
    (B, T, F), mask (B, T); F and H may differ per direction.  Returns the
    lists (x_proj (T, B, 4H), w_hh_t (H, 4H), mask (T, B)) and the reverse
    flags."""
    x_proj, w_hh_t, masks, reverses = [], [], [], []
    for p, x, mask, reverse in dirs:
        x_proj.append(project_inputs(p.w_ih, p.b_ih, x, p.b_hh))
        w_hh_t.append(p.w_hh.float().t().contiguous())
        masks.append(mask.t().contiguous().float())
        reverses.append(bool(reverse))
    return x_proj, w_hh_t, masks, reverses


def unpack_outputs(ys: Sequence[torch.Tensor], h_fin: Sequence[torch.Tensor]):
    """Batch-major outputs (B, T, H_d) and the final states (B, H_d) as
    lists: the kernels write every direction at its true H and time index,
    so nothing is sliced or flipped back."""
    return [y.transpose(0, 1) for y in ys], list(h_fin)
