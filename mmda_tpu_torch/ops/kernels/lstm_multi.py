"""Several masked LSTM recurrences in one launch, forward and backward: the
CUDA kernels' wrappers, their plain versions, and the packing of a tower
pair's directions.

Counterpart of `mmda_tpu/ops/pallas/lstm_multi.py`: D independent
directions (the two towers' forward and reverse scans of one stacked
layer) in one forward launch (`csrc/lstm_multi_fwd.cu`, the TPU package's
`_fwd_kernel`) and one backward launch (`csrc/lstm_multi_bwd.cu`,
`_bwd_kernel`: gate pass, BPTT and dW_hh for all D).  Each direction keeps
its true hidden size: the TPU kernel pads every direction to 128 lanes (its
matrix unit's tile) and time-flips the reverse ones; here a direction is a
list entry at its own H with a reverse flag, as `lstm.py`'s kernels take it,
and every row runs the passes of `lstm.py`'s kernels (`csrc/lstm_passes.cuh`),
so a direction's outputs are theirs bit for bit (dW_hh where its runs are
the same).

`lstm_multi_recurrence` and `lstm_multi_recurrence_bwd` take CUDA tensors to
the kernels and CPU tensors to the plain versions (each direction through
`lstm.py`'s plain version).  There is no other route: a CUDA input that a
kernel cannot take raises.  Launch counts: `launch_count("lstm_multi_fwd")`,
`("lstm_multi_bwd")`, one per wrapper call for all D directions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from mmda_tpu_torch.ops.kernels._launch import (BPTT_REG_H, check_tensor, device_of, launch,
                                                launch_count, lib, reset_launch_count,
                                                sm_count)
from mmda_tpu_torch.ops.kernels.lstm import (bwd_dw_splits, lstm_recurrence_bwd_reference,
                                             lstm_recurrence_reference)

SOURCES = ("lstm_multi_fwd", "lstm_multi_bwd")
__all__ = ["SOURCES", "launch_count", "reset_launch_count", "MAX_DIRS", "MULTI_THREADS",
           "group_threads", "geometry", "dw_splits", "launch_geometry", "lstm_multi_recurrence",
           "lstm_multi_recurrence_reference", "lstm_multi_recurrence_bwd",
           "lstm_multi_recurrence_bwd_reference", "LSTMMultiRecurrence", "lstm_scan_multi",
           "project_inputs", "pack_directions", "unpack_outputs"]
MAX_DIRS = 8                      # csrc/lstm_multi.cuh kMaxDirs
MULTI_THREADS = 480               # csrc/lstm_multi.cuh kMultiThreads: a block's threads
MAX_UNITS = 4                     # csrc/recurrence.cuh kMaxUnits: hidden units a quad

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


def group_threads(H: int) -> Tuple[int, int]:
    """(hidden units a quad, threads of one row) of the multi kernels' serial
    passes for H: a quad a unit up to H = 80 (the weights in registers), else
    the fewest units a quad that keep a row within MULTI_THREADS (weights from
    global memory), whole warps."""
    units = 1 if H <= BPTT_REG_H else -(-4 * H // MULTI_THREADS)
    if units > MAX_UNITS:
        raise ValueError(f"hidden size {H} > {MAX_UNITS * MULTI_THREADS // 4} is not "
                         "supported by the multi-direction kernels")
    return units, -(-4 * -(-H // units) // 32) * 32


@functools.lru_cache(maxsize=None)
def geometry(hs: Tuple[int, ...], B: int, n_sm: int) -> Tuple[Tuple[int, ...], ...]:
    """Where each direction's rows run in a launch of the serial passes
    (`csrc/lstm_multi.cuh`): per direction (rows, units, first block, first
    thread, threads), one row a block.  Where a block a row of every
    direction fits on the n_sm SMs, each direction has B blocks of its own;
    else the directions are packed into slots of B blocks, the widest first,
    each beside those already in a slot while the block stays within
    MULTI_THREADS, so that the launch stays one wave where it can (the tower
    pair at B = 64: a visual row, 160 threads, beside an acoustic one, 320)."""
    sizes = [group_threads(H) for H in hs]
    pack = len(hs) * B > n_sm
    used: List[int] = []          # threads taken in each slot
    plan: List[Tuple[int, ...]] = [()] * len(hs)
    for d in sorted(range(len(hs)), key=lambda d: -sizes[d][1]):
        units, threads = sizes[d]
        slot = next((i for i, u in enumerate(used) if pack and u + threads <= MULTI_THREADS),
                    len(used))
        if slot == len(used):
            used.append(0)
        plan[d] = (1, units, slot * B, used[slot], threads)
        used[slot] += threads
    return tuple(plan)


def dw_splits(T: int, B: int, hs: Sequence[int], n_sm: int) -> List[int]:
    """Runs of (t, b) rows each direction's dW_hh reduction is cut into:
    `lstm.py`'s (`bwd_dw_splits`, the same tiles) as if each direction had
    2 n_sm / D SMs, so the D directions' blocks come in about two rounds of
    what the card holds at once: shorter runs in two rounds beat long ones
    in one (PERF.md, the kernel table's row 20)."""
    share = max(1, 2 * n_sm // len(hs))
    return [bwd_dw_splits(T, B, H, share) for H in hs]


def _plan_ints(plan) -> ctypes.Array:
    return _ints([v for group in plan for v in group])


def launch_geometry(hs: Sequence[int], B: int, dev: torch.device) -> dict:
    """The serial passes' launches for these directions and B on the card,
    without launching: per kernel (`lstm_multi_fwd`, and `lstm_multi_bwd`'s
    BPTT pass) its registers a thread, local memory bytes a thread (stack
    and spills), blocks, threads a block, shared memory bytes, resident
    blocks an SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and
    waves."""
    n_sm = sm_count(dev)
    plan = geometry(tuple(hs), B, n_sm)
    out = {}
    for name, n_ptrs, n_ints in (("lstm_multi_fwd", 9, 3), ("lstm_multi_bwd", 14, 3)):
        fn = getattr(lib(name, n_ptrs, n_ints), f"mmda_{name}_geometry")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        got = (ctypes.c_int * 6)()
        hs_c, plan_c = _ints(hs), _plan_ints(plan)
        with torch.cuda.device(dev):
            err = fn(ctypes.addressof(hs_c), ctypes.addressof(plan_c), len(hs), B,
                     ctypes.addressof(got))
        if err != 0:
            raise RuntimeError(f"{name} geometry: cudaError {err}")
        row = dict(zip(("registers", "local_bytes", "blocks", "threads", "smem_bytes",
                        "resident_per_sm"), got))
        row["waves"] = -(-row["blocks"] // (n_sm * max(1, row["resident_per_sm"])))
        out[name] = row
    out["plan"] = [list(g) for g in plan]
    return out


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
    hs = [x.shape[-1] // 4 for x in x_proj]
    plan = geometry(tuple(hs), B, sm_count(dev))
    ys = [torch.empty(T, B, H, device=dev) for H in hs]
    cs = [torch.empty(T, B, H, device=dev) for H in hs] if need_cs else None
    h_fin = [torch.empty(B, H, device=dev) for H in hs]
    arrays = [_ptrs(x_proj), _ptrs(w_hh_t), _ptrs(mask), _ptrs(ys),
              _ptrs(cs if need_cs else [None] * len(hs)), _ptrs(h_fin), _ints(hs),
              _ints(reverse), _plan_ints(plan)]
    so = lib("lstm_multi_fwd", 9, 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("lstm_multi_fwd", so.mmda_lstm_multi_fwd,
               *[ctypes.addressof(a) for a in arrays], len(hs), T, B, stream)
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
    hs = [x.shape[-1] // 4 for x in x_proj]
    n_sm = sm_count(dev)
    plan = geometry(tuple(hs), B, n_sm)
    splits = dw_splits(T, B, hs, n_sm)
    dx = [torch.empty(T, B, 4 * H, device=dev) for H in hs]
    dw = [torch.empty(H, 4 * H, device=dev) for H in hs]
    dw_partial = torch.empty(sum(s * H * 4 * H for s, H in zip(splits, hs)),
                             dtype=torch.float64, device=dev)
    arrays = [_ptrs(x_proj), _ptrs(w_hh_t), _ptrs(mask), _ptrs(ys), _ptrs(cs), _ptrs(dys),
              _ptrs(dh_fin), _ptrs(dx), _ptrs(dw)]
    ints = [_ints(hs), _ints(reverse), _ints(splits), _plan_ints(plan)]
    so = lib("lstm_multi_bwd", 14, 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("lstm_multi_bwd", so.mmda_lstm_multi_bwd,
               *[ctypes.addressof(a) for a in arrays], dw_partial.data_ptr(),
               *[ctypes.addressof(a) for a in ints], len(hs), T, B, stream)
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
