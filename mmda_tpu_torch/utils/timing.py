"""Timing and profiling (counterpart of `mmda_tpu/utils/timing.py`).

* `time_desc_decorator`: print a description and each call's wall time (the
  reference's `time_track` printer);
* `StepTimer`: host-clock laps that end, when given a CUDA tensor, in
  `torch.cuda.synchronize` on its device, so the lap holds the device work
  and not only its enqueue;
* `profile(log_dir)`: `torch.profiler` over the CPU and, where there is a
  card, CUDA activity; on exit a Chrome trace `trace_{pid}_{n}.json` lands in
  `log_dir` (view it in chrome://tracing or Perfetto).  A no-op for None;
* `debug_mode`: `torch.autograd.set_detect_anomaly` (a NaN in the backward
  raises, naming the forward op that made it) and every ATen op's floating
  output checked for NaN, raising on the op that produced it: the
  counterpart of `jax_debug_nans`.  The check reads every output back,
  so it runs eager work only (no CUDA-graph capture).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def time_desc_decorator(desc: str):
    """Print `desc` and the wall time of each call (reference parity)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            print(desc)
            start = time.time()
            out = fn(*args, **kwargs)
            print(f"{desc}: {time.time() - start:.3f}s")
            return out

        return wrapper

    return decorator


class StepTimer:
    """`start()`, then `stop(x)`: the seconds since `start`, after the
    device of `x` (a tensor, or a list or dict of them) has finished, where
    `x` lies on a card."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.laps = []

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, wait_on=None) -> float:
        for t in _tensors(wait_on):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.laps) / max(len(self.laps), 1)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


_trace_numbers = itertools.count()


@contextlib.contextmanager
def profile(log_dir: Optional[str]):
    """torch.profiler scope writing a Chrome trace into `log_dir`; yields
    the profiler (None when log_dir is None, where nothing is traced)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_trace_numbers)}.json"))


class _NanCheck(TorchDispatchMode):
    """Raise on the first ATen op whose floating output holds a NaN.  An
    allocation (uninitialised memory) and a view (no new values) are no
    result of their own."""

    _SKIP = ("empty", "new_empty")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.__name__.split(".")[0].startswith(self._SKIP)):
            for t in _tensors(out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode():
    """Anomaly detection in the backward and the NaN check of every op
    (module docstring)."""
    with torch.autograd.set_detect_anomaly(True), _NanCheck():
        yield
