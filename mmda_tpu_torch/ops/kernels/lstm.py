"""Masked LSTM recurrence, forward and backward: the CUDA kernels' wrappers
and their plain versions.

Counterpart of `mmda_tpu/ops/pallas/lstm.py`: the forward (`_fwd_kernel`,
`_stream_fwd_kernel`) is `mmda_tpu_torch/csrc/lstm_fwd.cu`, the BPTT
backward (`_bwd_kernel`, `_stream_bwd_kernel`) `csrc/lstm_bwd.cu`, and
`LSTMRecurrence` is the `autograd.Function` that joins them, as `lstm_scan`'s
`custom_vjp` does.

`lstm_recurrence` and `lstm_recurrence_bwd` take a CUDA tensor to the kernel
and a CPU tensor to the plain version (`lstm_recurrence_reference`,
`lstm_recurrence_bwd_reference`: the same math as a Python loop over t).
There is no other route: a CUDA input that a kernel cannot take raises.

Launch counts (`launch_count(name)`, shared by all the package's kernels):
`lstm_fwd` by `lstm_recurrence`, `lstm_bwd` by `lstm_recurrence_bwd`, one per
wrapper call that launches; a `lstm_bwd` call launches the gate pass, the
BPTT pass and the two passes of the dW_hh reduction of that source and
counts once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmda_tpu_torch.ops.kernels._launch import (MAX_THREADS, bptt_rows_per_block,
                                                bptt_threads_per_row, check_tensor,
                                                device_of, dw_runs, launch, launch_count,
                                                lib, reset_launch_count, sm_count)

SOURCES = ("lstm_fwd", "lstm_bwd")
__all__ = ["SOURCES", "launch_count", "reset_launch_count",
           "bptt_threads_per_row", "bptt_rows_per_block", "bwd_dw_splits",
           "lstm_recurrence", "lstm_recurrence_reference", "lstm_recurrence_bwd",
           "lstm_recurrence_bwd_reference", "LSTMRecurrence", "lstm_scan"]


Result = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]


def lstm_recurrence_reference(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                              mask: torch.Tensor, reverse: bool = False,
                              need_cs: bool = False) -> Result:
    """Plain PyTorch version of the kernel (mmda_tpu/ops/pallas/lstm.py::
    _cell_fwd over t).  Returns (ys, cs or None, h_fin, c_fin)."""
    T, B, G = x_proj.shape
    H = G // 4
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    ys = x_proj.new_empty(T, B, H)
    cs = x_proj.new_empty(T, B, H) if need_cs else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[t] + torch.matmul(h, w_hh_t)
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys[t] = h
        if cs is not None:
            cs[t] = c
    return ys, cs, h, c


def _check(x_proj, w_hh_t, mask) -> None:
    if not isinstance(x_proj, torch.Tensor):
        raise TypeError(f"x_proj must be a tensor, got {type(x_proj).__name__}")
    for name, t in (("x_proj", x_proj), ("w_hh_t", w_hh_t), ("mask", mask)):
        check_tensor(name, t, x_proj.device)
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, B, 4H), got {tuple(x_proj.shape)}")
    T, B, G = x_proj.shape
    H = G // 4
    if T < 1 or B < 1:
        raise ValueError(f"x_proj must have T >= 1 and B >= 1, got {tuple(x_proj.shape)}")
    if tuple(w_hh_t.shape) != (H, G):
        raise ValueError(f"w_hh_t must be ({H}, {G}), got {tuple(w_hh_t.shape)}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"mask must be ({T}, {B}), got {tuple(mask.shape)}")


def bwd_dw_splits(T: int, B: int, H: int, n_sm: int) -> int:
    """Runs of (t, b) rows the backward's dW_hh reduction (csrc/lstm_bwd.cu)
    is cut into (`dw_runs`): the (T - 1) B rows that carry an h_prev, over
    the (H, 4H) result."""
    return dw_runs((T - 1) * B, H, 4 * H, n_sm)


def lstm_recurrence(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    need_cs: bool = False) -> Result:
    """Masked LSTM recurrence over time-major inputs.

    x_proj (T, B, 4H) f32 = x @ W_ih^T + b_ih + b_hh, gates i, f, g, o;
    w_hh_t (H, 4H) f32; mask (T, B) f32 in {0, 1}; reverse walks t = T-1..0.
    Returns ys (T, B, H) (carry held at masked steps), cs (T, B, H) when
    need_cs else None, and the final h, c (B, H).
    """
    _check(x_proj, w_hh_t, mask)
    dev = device_of(x_proj)
    if dev.type == "cpu":
        return lstm_recurrence_reference(x_proj, w_hh_t, mask, reverse, need_cs)
    T, B, G = x_proj.shape
    H = G // 4
    if H > MAX_THREADS:
        raise ValueError(f"hidden size {H} > {MAX_THREADS} is not supported by the kernel")
    so = lib("lstm_fwd", 7, 5)
    ys = torch.empty(T, B, H, device=dev)
    cs = torch.empty(T, B, H, device=dev) if need_cs else None
    h_fin = torch.empty(B, H, device=dev)
    c_fin = torch.empty(B, H, device=dev)
    n_sm = sm_count(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("lstm_fwd", so.mmda_lstm_fwd,
               x_proj.data_ptr(), w_hh_t.data_ptr(), mask.data_ptr(),
               ys.data_ptr(), cs.data_ptr() if cs is not None else None,
               h_fin.data_ptr(), c_fin.data_ptr(),
               T, B, H, bptt_rows_per_block(B, H, n_sm), int(reverse), stream)
    return ys, cs, h_fin, c_fin


# ------------------------------------------------------------------ backward

BwdResult = Tuple[torch.Tensor, torch.Tensor]


def lstm_recurrence_bwd_reference(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                                  mask: torch.Tensor, ys: torch.Tensor,
                                  cs: torch.Tensor, dys: torch.Tensor,
                                  dh_fin: torch.Tensor,
                                  dc_fin: Optional[torch.Tensor] = None,
                                  reverse: bool = False) -> BwdResult:
    """Plain PyTorch version of the backward kernel (mmda_tpu/ops/pallas/
    lstm.py::_cell_bwd over the steps of _bwd_kernel).  Returns (dx_proj
    (T, B, 4H), dw_hh_t (H, 4H)).  dW_hh^T is summed in f64 and rounded
    once, as the kernel sums it: the T * B products then agree whatever
    the summation order."""
    T, B, G = x_proj.shape
    H = G // 4
    dh = dh_fin
    dc = torch.zeros_like(dh_fin) if dc_fin is None else dc_fin
    dx = x_proj.new_empty(T, B, G)
    dw = x_proj.new_zeros(H, G, dtype=torch.float64)
    zero = x_proj.new_zeros(B, H)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        first = t == (T - 1 if reverse else 0)
        prev_t = t + 1 if reverse else t - 1
        h_prev = zero if first else ys[prev_t]
        c_prev = zero if first else cs[prev_t]
        dh = dh + dys[t]
        gates = x_proj[t] + torch.matmul(h_prev, w_hh_t)
        i, f, g, o = gates.split(H, dim=-1)
        ig, fg, gg, og = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        tanh_c = torch.tanh(fg * c_prev + ig * gg)
        m = mask[t][:, None]
        dh_new, dc_new = m * dh, m * dc
        dh_pass, dc_pass = (1.0 - m) * dh, (1.0 - m) * dc
        dc_new = dc_new + dh_new * og * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_new * gg * ig * (1.0 - ig),
                            dc_new * c_prev * fg * (1.0 - fg),
                            dc_new * ig * (1.0 - gg * gg),
                            dh_new * tanh_c * og * (1.0 - og)], dim=-1)
        dc = dc_new * fg + dc_pass
        dh = torch.matmul(dgates, w_hh_t.t()) + dh_pass
        dx[t] = dgates
        dw = dw + torch.matmul(h_prev.t().double(), dgates.double())
    return dx, dw.float()


def lstm_recurrence_bwd(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                        mask: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
                        dys: torch.Tensor, dh_fin: torch.Tensor,
                        dc_fin: Optional[torch.Tensor] = None,
                        reverse: bool = False) -> BwdResult:
    """Gradient of `lstm_recurrence` (BPTT with the gates recomputed from
    the saved ys, cs; on the card in a pass of their own before the serial
    one).  dys (T, B, H), dh_fin and dc_fin (B, H) are the incoming
    gradients; dc_fin None means zeros.  Returns dx_proj (T, B, 4H) and
    dw_hh_t (H, 4H), all f32."""
    _check(x_proj, w_hh_t, mask)
    T, B, G = x_proj.shape
    H = G // 4
    state = [("ys", ys, (T, B, H)), ("cs", cs, (T, B, H)), ("dys", dys, (T, B, H)),
             ("dh_fin", dh_fin, (B, H))]
    if dc_fin is not None:
        state.append(("dc_fin", dc_fin, (B, H)))
    for name, t, shape in state:
        check_tensor(name, t, x_proj.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    dev = device_of(x_proj)
    if dev.type == "cpu":
        return lstm_recurrence_bwd_reference(x_proj, w_hh_t, mask, ys, cs, dys,
                                             dh_fin, dc_fin, reverse)
    if H > MAX_THREADS:
        raise ValueError(f"hidden size {H} > {MAX_THREADS} is not supported by the kernel")
    so = lib("lstm_bwd", 11, 6)
    n_sm = sm_count(dev)
    splits = bwd_dw_splits(T, B, H, n_sm)
    dx = torch.empty(T, B, G, device=dev)
    dw = torch.empty(H, G, device=dev)
    dw_partial = torch.empty(splits, H, G, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("lstm_bwd", so.mmda_lstm_bwd,
               x_proj.data_ptr(), w_hh_t.data_ptr(), mask.data_ptr(),
               ys.data_ptr(), cs.data_ptr(), dys.data_ptr(), dh_fin.data_ptr(),
               dc_fin.data_ptr() if dc_fin is not None else None,
               dx.data_ptr(), dw.data_ptr(), dw_partial.data_ptr(),
               T, B, H, bptt_rows_per_block(B, H, n_sm), int(reverse), splits, stream)
    return dx, dw


class LSTMRecurrence(torch.autograd.Function):
    """(ys, h_fin) of the masked recurrence with the BPTT kernel as its
    backward (`lstm_scan`'s custom_vjp): the forward saves ys and cs, the
    backward feeds dc_fin = 0.  mask and reverse get no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, mask, reverse: bool = False):
        ys, cs, h_fin, _ = lstm_recurrence(x_proj, w_hh_t, mask, reverse, need_cs=True)
        ctx.save_for_backward(x_proj, w_hh_t, mask, ys, cs)
        ctx.reverse = reverse
        return ys, h_fin

    @staticmethod
    def backward(ctx, dys, dh_fin):
        x_proj, w_hh_t, mask, ys, cs = ctx.saved_tensors
        dx, dw = lstm_recurrence_bwd(x_proj, w_hh_t, mask, ys, cs,
                                     dys.contiguous(), dh_fin.contiguous(),
                                     None, ctx.reverse)
        return dx, dw, None, None


def lstm_scan(x_proj: torch.Tensor, w_hh_t: torch.Tensor, mask: torch.Tensor,
              reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys, h_fin), differentiable through the kernels
    (`mmda_tpu.ops.pallas.lstm.lstm_scan`; mask here is (T, B))."""
    return LSTMRecurrence.apply(x_proj, w_hh_t, mask, reverse)
