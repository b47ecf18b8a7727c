"""What every kernel wrapper of the package shares: the list of CUDA
sources, the launch counts, the ctypes binding of a source's plain C entry,
and the checks on the tensors handed to a kernel.

One count per source (`launch_count(name)`): a wrapper adds one where it
launches its kernel (a source with several `__global__` passes counts once
per wrapper call) and nowhere else, so a run can show that its path went
through the kernels.  `reset_launch_count()` sets every count to 0.
"""

from __future__ import annotations

import ctypes

import torch

from mmda_tpu_torch.ops.kernels import _build

# csrc/<name>.cu, entry point mmda_<name>
KERNELS = ("lstm_fwd", "lstm_bwd", "gru_fwd", "gru_bwd",
           "ln_dropout_fwd", "ln_dropout_bwd",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "short_attn_fwd", "short_attn_bwd", "lstm_multi_fwd", "lstm_multi_bwd")
MAX_THREADS = 1024
DW_TILE = (16, 64)     # the recurrences' dW tile: hidden units x gate columns

_launches = dict.fromkeys(KERNELS, 0)


def launch_count(name: str = "lstm_fwd") -> int:
    """Launches of the `name` kernel since the last reset."""
    return _launches[name]


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def lib(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu with `mmda_<name>`'s signature:
    n_ptrs pointers, n_ints ints, n_floats floats, the stream."""
    loaded = _build.load(name)
    fn = getattr(loaded, f"mmda_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return loaded


def launch(name: str, fn, *args) -> None:
    """Call the C entry (which launches on the given stream and returns
    cudaGetLastError()), raise if the launch was refused, count it."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _launches[name] += 1


def device_of(x: torch.Tensor) -> torch.device:
    dev = x.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the kernels run on cuda or cpu tensors, got {dev}")
    return dev


def check_tensor(name: str, t, device: torch.device,
                 dtype: torch.dtype = torch.float32, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def rows_per_block(B: int, H: int, n_sm: int) -> int:
    """Batch rows per thread block of a recurrence kernel: spread B over the
    SMs (the recurrence is latency-bound, so short blocks on many SMs beat
    long blocks), within the 1024-thread limit of one thread per (row,
    hidden unit)."""
    return max(1, min(-(-B // n_sm), MAX_THREADS // H))


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
