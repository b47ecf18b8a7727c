"""Masked GRU recurrence, forward and backward: the CUDA kernels' wrappers
and their plain versions.

Counterpart of `mmda_tpu/ops/pallas/gru.py`: the forward (`_fwd_kernel`,
`_stream_fwd_kernel`) is `mmda_tpu_torch/csrc/gru_fwd.cu`, the BPTT backward
(`_bwd_kernel`, `_stream_bwd_kernel`) `csrc/gru_bwd.cu`, and `GRURecurrence`
is the `autograd.Function` that joins them, as `gru_scan`'s `custom_vjp`
does.  torch GRU semantics, gate order r, z, n:

    hh = h @ w_hh_t + b_hh
    r  = sigmoid(x_r + hh_r);  z = sigmoid(x_z + hh_z)
    n  = tanh(x_n + r * hh_n)
    h' = (1 - z) * n + z * h;  h = m * h' + (1 - m) * h

b_hh sits inside the r product, so it is not folded into x_proj: the kernels
take it as (3H,) and the backward returns its gradient.

`gru_recurrence` and `gru_recurrence_bwd` take a CUDA tensor to the kernel
and a CPU tensor to the plain version (`gru_recurrence_reference`,
`gru_recurrence_bwd_reference`: `_cell_fwd` / `_cell_bwd` as a Python loop
over t).  There is no other route: a CUDA input that a kernel cannot take
raises.  The forward is the op `torch.ops.mmda_tpu_torch.gru_recurrence`
(`gru_recurrence_op`, a `torch.library.custom_op` with a fake
implementation): one node in a `torch.export` graph.  Launch counts:
`launch_count("gru_fwd")`, `launch_count("gru_bwd")` (a `gru_bwd` call
launches the gate pass, the BPTT pass and the two passes of the dW_hh /
db_hh reduction and counts once).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmda_tpu_torch.ops.kernels._launch import (MAX_THREADS, bptt_rows_per_block,
                                                check_tensor, device_of, dw_runs, launch,
                                                launch_count, lib, reset_launch_count,
                                                sm_count)

SOURCES = ("gru_fwd", "gru_bwd")
__all__ = ["SOURCES", "launch_count", "reset_launch_count", "dw_splits", "gru_recurrence",
           "gru_recurrence_op", "gru_recurrence_reference", "gru_recurrence_bwd",
           "gru_recurrence_bwd_reference", "GRURecurrence", "gru_scan"]

Result = Tuple[torch.Tensor, torch.Tensor]
BwdResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _gates(xp: torch.Tensor, h: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor):
    """r, z, n and hh_n of one step."""
    H = h.shape[-1]
    hh = torch.matmul(h, w_hh_t) + b_hh
    r = torch.sigmoid(xp[:, :H] + hh[:, :H])
    z = torch.sigmoid(xp[:, H:2 * H] + hh[:, H:2 * H])
    hn = hh[:, 2 * H:]
    n = torch.tanh(xp[:, 2 * H:] + r * hn)
    return r, z, n, hn


def gru_recurrence_reference(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                             b_hh: torch.Tensor, mask: torch.Tensor,
                             reverse: bool = False) -> Result:
    """Plain PyTorch version of the forward kernel (mmda_tpu/ops/pallas/
    gru.py::_cell_fwd over t).  Returns (ys, h_fin)."""
    T, B, G = x_proj.shape
    h = x_proj.new_zeros(B, G // 3)
    ys = []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        _, z, n, _ = _gates(x_proj[t], h, w_hh_t, b_hh)
        h_new = (1.0 - z) * n + z * h
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        ys.append(h)
    if reverse:
        ys.reverse()
    return torch.stack(ys), h


def _check(x_proj, w_hh_t, b_hh, mask) -> None:
    if not isinstance(x_proj, torch.Tensor):
        raise TypeError(f"x_proj must be a tensor, got {type(x_proj).__name__}")
    if x_proj.dim() != 3 or x_proj.shape[-1] % 3:
        raise ValueError(f"x_proj must be (T, B, 3H), got {tuple(x_proj.shape)}")
    T, B, G = x_proj.shape
    H = G // 3
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"x_proj must have T, B, H >= 1, got {tuple(x_proj.shape)}")
    for name, t, shape in (("x_proj", x_proj, (T, B, G)), ("w_hh_t", w_hh_t, (H, G)),
                           ("b_hh", b_hh, (G,)), ("mask", mask, (T, B))):
        check_tensor(name, t, x_proj.device, shape=shape)


def _forward(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
             mask: torch.Tensor, reverse: bool) -> Result:
    """The `gru_recurrence` op's implementation: the plain version for a CPU
    tensor, the kernel for a CUDA one."""
    _check(x_proj, w_hh_t, b_hh, mask)
    dev = device_of(x_proj)
    if dev.type == "cpu":
        return gru_recurrence_reference(x_proj, w_hh_t, b_hh, mask, reverse)
    T, B, G = x_proj.shape
    H = G // 3
    if H > MAX_THREADS:
        raise ValueError(f"hidden size {H} > {MAX_THREADS} is not supported by the kernel")
    so = lib("gru_fwd", 6, 5)
    ys = torch.empty(T, B, H, device=dev)
    h_fin = torch.empty(B, H, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("gru_fwd", so.mmda_gru_fwd,
               x_proj.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), mask.data_ptr(),
               ys.data_ptr(), h_fin.data_ptr(),
               T, B, H, bptt_rows_per_block(B, H, sm_count(dev)), int(reverse), stream)
    return ys, h_fin


@torch.library.custom_op("mmda_tpu_torch::gru_recurrence", mutates_args=())
def gru_recurrence_op(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
                      mask: torch.Tensor, reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """`torch.ops.mmda_tpu_torch.gru_recurrence`: one node in a
    `torch.export` graph that runs `_forward` on the real tensors."""
    return _forward(x_proj, w_hh_t, b_hh, mask, reverse)


@gru_recurrence_op.register_fake
def _(x_proj, w_hh_t, b_hh, mask, reverse):
    T, B, G = x_proj.shape
    return x_proj.new_empty(T, B, G // 3), x_proj.new_empty(B, G // 3)


def gru_recurrence(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
                   mask: torch.Tensor, reverse: bool = False) -> Result:
    """Masked GRU recurrence over time-major inputs, through the
    `mmda_tpu_torch::gru_recurrence` op.

    x_proj (T, B, 3H) f32 = x @ W_ih^T + b_ih (b_hh not folded), gates r, z,
    n; w_hh_t (H, 3H) f32; b_hh (3H,) f32; mask (T, B) f32 in {0, 1}; reverse
    walks t = T-1..0.  Returns ys (T, B, H) (carry held at masked steps) and
    the final h (B, H).
    """
    # here too: with a meta tensor among the arguments the op runs its fake, not _forward
    _check(x_proj, w_hh_t, b_hh, mask)
    device_of(x_proj)
    return gru_recurrence_op(x_proj, w_hh_t, b_hh, mask, reverse)


# ------------------------------------------------------------------ backward


def gru_recurrence_bwd_reference(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                                 b_hh: torch.Tensor, mask: torch.Tensor,
                                 ys: torch.Tensor, dys: torch.Tensor,
                                 dh_fin: torch.Tensor, reverse: bool = False) -> BwdResult:
    """Plain PyTorch version of the backward kernel (mmda_tpu/ops/pallas/
    gru.py::_cell_bwd over the steps of _bwd_kernel).  Returns (dx_proj
    (T, B, 3H), dw_hh_t (H, 3H), db_hh (3H,)).  dW_hh^T and db_hh are summed
    in f64 and rounded once, as the kernel sums them: the T * B terms then
    agree whatever the summation order."""
    T, B, G = x_proj.shape
    H = G // 3
    dh = dh_fin
    dx = x_proj.new_empty(T, B, G)
    dw = x_proj.new_zeros(H, G, dtype=torch.float64)
    db = x_proj.new_zeros(G, dtype=torch.float64)
    zero = x_proj.new_zeros(B, H)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        first = t == (T - 1 if reverse else 0)
        h_prev = zero if first else ys[t + 1 if reverse else t - 1]
        dh = dh + dys[t]
        r, z, n, hn = _gates(x_proj[t], h_prev, w_hh_t, b_hh)
        m = mask[t][:, None]
        dh_new, dh_pass = m * dh, (1.0 - m) * dh
        dz = dh_new * (h_prev - n)
        dn = dh_new * (1.0 - z)
        dpre_n = dn * (1.0 - n * n)
        dr = dpre_n * hn
        dhn = dpre_n * r
        dpre_r = dr * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dx[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        dgh = torch.cat([dpre_r, dpre_z, dhn], dim=-1)
        dh = torch.matmul(dgh, w_hh_t.t()) + dh_new * z + dh_pass
        dw = dw + torch.matmul(h_prev.t().double(), dgh.double())
        db = db + dgh.double().sum(0)
    return dx, dw.float(), db.float()


def dw_splits(T: int, B: int, H: int, n_sm: int) -> int:
    """Runs of (t, b) rows the dW_hh / db_hh reduction is cut into
    (`dw_runs`): all T B rows, over the (H + 1, 3H) result."""
    return dw_runs(T * B, H + 1, 3 * H, n_sm)


def gru_recurrence_bwd(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
                       mask: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor,
                       dh_fin: torch.Tensor, reverse: bool = False) -> BwdResult:
    """Gradient of `gru_recurrence` (BPTT with the gates recomputed from the
    saved ys; on the card in a pass of their own before the serial one).
    dys (T, B, H) and dh_fin (B, H) are the incoming gradients.
    Returns dx_proj (T, B, 3H), dw_hh_t (H, 3H) and db_hh (3H,), all f32."""
    _check(x_proj, w_hh_t, b_hh, mask)
    T, B, G = x_proj.shape
    H = G // 3
    for name, t, shape in (("ys", ys, (T, B, H)), ("dys", dys, (T, B, H)),
                           ("dh_fin", dh_fin, (B, H))):
        check_tensor(name, t, x_proj.device, shape=shape)
    dev = device_of(x_proj)
    if dev.type == "cpu":
        return gru_recurrence_bwd_reference(x_proj, w_hh_t, b_hh, mask, ys, dys,
                                            dh_fin, reverse)
    if H > MAX_THREADS:
        raise ValueError(f"hidden size {H} > {MAX_THREADS} is not supported by the kernel")
    so = lib("gru_bwd", 11, 6)
    n_sm = sm_count(dev)
    splits = dw_splits(T, B, H, n_sm)
    dx = torch.empty(T, B, G, device=dev)
    dhn = torch.empty(T, B, H, device=dev)          # the n lane of dgh, for the dW pass
    dwb = torch.empty(H + 1, G, device=dev)         # rows 0..H-1 dw_hh_t, row H db_hh
    dwb_partial = torch.empty(splits, H + 1, G, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("gru_bwd", so.mmda_gru_bwd,
               x_proj.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), mask.data_ptr(),
               ys.data_ptr(), dys.data_ptr(), dh_fin.data_ptr(),
               dx.data_ptr(), dhn.data_ptr(), dwb.data_ptr(), dwb_partial.data_ptr(),
               T, B, H, bptt_rows_per_block(B, H, n_sm), int(reverse), splits, stream)
    return dx, dwb[:H], dwb[H]


class GRURecurrence(torch.autograd.Function):
    """(ys, h_fin) of the masked recurrence with the BPTT kernel as its
    backward (`gru_scan`'s custom_vjp): the forward saves ys.  mask and
    reverse get no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, b_hh, mask, reverse: bool = False):
        ys, h_fin = gru_recurrence(x_proj, w_hh_t, b_hh, mask, reverse)
        ctx.save_for_backward(x_proj, w_hh_t, b_hh, mask, ys)
        ctx.reverse = reverse
        return ys, h_fin

    @staticmethod
    def backward(ctx, dys, dh_fin):
        x_proj, w_hh_t, b_hh, mask, ys = ctx.saved_tensors
        dx, dw, db = gru_recurrence_bwd(x_proj, w_hh_t, b_hh, mask, ys,
                                        dys.contiguous(), dh_fin.contiguous(), ctx.reverse)
        return dx, dw, db, None, None


def gru_scan(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
             mask: torch.Tensor, reverse: bool = False) -> Result:
    """(ys, h_fin), differentiable through the kernels
    (`mmda_tpu.ops.pallas.gru.gru_scan`; b_hh here is (3H,), mask (T, B))."""
    return GRURecurrence.apply(x_proj, w_hh_t, b_hh, mask, reverse)
