"""What every kernel wrapper of the package shares: the list of CUDA
sources, the launch counts, the ctypes binding of a source's plain C entry,
and the checks on the tensors handed to a kernel.

One count per source (`launch_count(name)`): a wrapper adds one where it
launches its kernel (a source with several `__global__` passes counts once
per wrapper call) and nowhere else, so a run can show that its path went
through the kernels.  `reset_launch_count()` sets every count to 0.  The
counts are launches the card ran: a launch made while a CUDA graph is
captured runs only when the graph is replayed, so inside `recording()` it
goes to the recorded dict instead, and `add_launches(recorded)` adds it at
every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional, Tuple

import torch

from mmda_tpu_torch.ops.kernels import _build

# csrc/<name>.cu, entry point mmda_<name>
KERNELS = ("lstm_fwd", "lstm_bwd", "gru_fwd", "gru_bwd",
           "ln_dropout_fwd", "ln_dropout_bwd",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "short_attn_fwd", "short_attn_bwd", "lstm_multi_fwd", "lstm_multi_bwd",
           "short_attn_tiled_fwd", "short_attn_tiled_bwd")
MAX_THREADS = 1024
BWD_DW_TILE = (32, 64)     # csrc/lstm_bwd.cu's and gru_bwd.cu's dW tile: rows x gate columns
BWD_DW_CHUNK = 16          # (t, b) rows such a dW block stages at a time

_launches = dict.fromkeys(KERNELS, 0)
_recorded: Optional[Dict[str, int]] = None      # the launches of a graph being captured


def launch_count(name: str = "lstm_fwd") -> int:
    """Launches of the `name` kernel since the last reset."""
    return _launches[name]


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Launches made inside (a graph's capture) go to the yielded dict, by
    name, and not to the counts."""
    global _recorded
    if _recorded is not None:
        raise RuntimeError("launches are already being recorded (one capture at a time)")
    _recorded = dict.fromkeys(KERNELS, 0)
    try:
        yield _recorded
    finally:
        _recorded = None


def add_launches(recorded: Dict[str, int]) -> None:
    """Count a replay of a graph whose capture recorded `recorded`."""
    for name, n in recorded.items():
        _launches[name] += n


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
    (_launches if _recorded is None else _recorded)[name] += 1


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


# The serial passes of csrc/lstm_fwd.cu, lstm_bwd.cu and gru_bwd.cu: 4
# threads per (row, group of hidden units), one unit a group up to H = 80
# with a thread's weights in registers (11 or 21 float4s by gate_stride,
# which caps the block's threads: BPTT_REG_THREADS); above that ceil(H / 256)
# units a group, the weights read from global memory, up to 1024 threads
BPTT_REG_H = 80
BPTT_REG_THREADS = ((11, 640), (21, 384))   # (float4s a thread holds, threads)


def _gate_stride(H: int) -> int:
    """csrc/recurrence.cuh gate_stride: H rounded up to a multiple of 4 with
    an odd count of float4s."""
    hp = -(-H // 4) * 4
    return hp + 4 if (hp // 4) % 2 == 0 else hp


def bptt_instantiation(H: int) -> int:
    """The float4s of weights a thread of the serial passes holds for H (the
    kernels' template argument: 11 or 21), 0 where it reads them from global
    memory."""
    if H > BPTT_REG_H:
        return 0
    held = _gate_stride(H) // 4
    return next(n for n, _ in BPTT_REG_THREADS if held <= n)


def bptt_threads_per_row(H: int) -> Tuple[int, int]:
    """(threads per batch row, the block's thread limit) of the serial
    passes' instantiation for H."""
    held = bptt_instantiation(H)
    if held == 0:
        units = -(-H // 256)
        return 4 * -(-H // units), MAX_THREADS
    return 4 * H, dict(BPTT_REG_THREADS)[held]


def bptt_rows_per_block(B: int, H: int, n_sm: int) -> int:
    """Batch rows per block of a serial pass: B spread over the SMs (the
    recurrence is latency-bound, so short blocks on many SMs beat long
    blocks), within the block's thread limit."""
    per_row, cap = bptt_threads_per_row(H)
    return max(1, min(-(-B // n_sm), cap // per_row))


def dw_runs(n_rows: int, out_rows: int, out_cols: int, n_sm: int) -> int:
    """Runs of (t, b) rows a backward's dW reduction (csrc/lstm_bwd.cu,
    gru_bwd.cu) is cut into: enough 128-thread blocks of BWD_DW_TILE outputs
    over its (out_rows, out_cols) result for four per SM, at most one run per
    BWD_DW_CHUNK of the n_rows rows that add, at least one."""
    tiles = -(-out_rows // BWD_DW_TILE[0]) * -(-out_cols // BWD_DW_TILE[1])
    return max(1, min(-(-n_rows // BWD_DW_CHUNK), -(-4 * n_sm // tiles)))


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
