"""Masked LSTM forward recurrence: the CUDA kernel's wrapper and its plain version.

Counterpart of `mmda_tpu/ops/pallas/lstm.py` (forward: `_fwd_kernel` and
`_stream_fwd_kernel`); the kernel is `mmda_tpu_torch/csrc/lstm_fwd.cu`.

`lstm_recurrence` takes a CUDA tensor to the kernel and a CPU tensor to
`lstm_recurrence_reference`, the same math as a Python loop over t.  There is
no other route: a CUDA input that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mmda_tpu_torch.ops.kernels import _build

SOURCE = "lstm_fwd"
MAX_THREADS = 1024

_launches = 0


def launch_count() -> int:
    """Kernel launches made by `lstm_recurrence` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


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
    for name, t in (("x_proj", x_proj), ("w_hh_t", w_hh_t), ("mask", mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on {x_proj.device}")
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


def rows_per_block(B: int, H: int, n_sm: int) -> int:
    """Batch rows per thread block: spread B over the SMs (the recurrence is
    latency-bound, so short blocks on many SMs beat long blocks), within the
    1024-thread limit of one thread per (row, hidden unit)."""
    return max(1, min(-(-B // n_sm), MAX_THREADS // H))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.mmda_lstm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def lstm_recurrence(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    need_cs: bool = False) -> Result:
    """Masked LSTM recurrence over time-major inputs.

    x_proj (T, B, 4H) f32 = x @ W_ih^T + b_ih + b_hh, gates i, f, g, o;
    w_hh_t (H, 4H) f32; mask (T, B) f32 in {0, 1}; reverse walks t = T-1..0.
    Returns ys (T, B, H) (carry held at masked steps), cs (T, B, H) when
    need_cs else None, and the final h, c (B, H).
    """
    global _launches
    _check(x_proj, w_hh_t, mask)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_reference(x_proj, w_hh_t, mask, reverse, need_cs)
    if dev.type != "cuda":
        raise ValueError(f"lstm_recurrence runs on cuda or cpu tensors, got {dev}")
    T, B, G = x_proj.shape
    H = G // 4
    if H > MAX_THREADS:
        raise ValueError(f"hidden size {H} > {MAX_THREADS} is not supported by the kernel")
    lib = _lib()
    ys = torch.empty(T, B, H, device=dev)
    cs = torch.empty(T, B, H, device=dev) if need_cs else None
    h_fin = torch.empty(B, H, device=dev)
    c_fin = torch.empty(B, H, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mmda_lstm_fwd(
            x_proj.data_ptr(), w_hh_t.data_ptr(), mask.data_ptr(),
            ys.data_ptr(), cs.data_ptr() if cs is not None else None,
            h_fin.data_ptr(), c_fin.data_ptr(),
            T, B, H, rows_per_block(B, H, n_sm), int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed: cudaError {err}")
    _launches += 1
    return ys, cs, h_fin, c_fin
