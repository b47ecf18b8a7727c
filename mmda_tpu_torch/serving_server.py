"""Long-running serving front end: queueing, micro-batching, timeouts.

Counterpart of `mmda_tpu/serving_server.py`, the same code over the port's
`Predictor` (serving.py) or `ExportedPredictor` (serving_export.py):

  * callers submit single requests from any thread and get a Future;
  * a worker thread coalesces pending requests into micro-batches (up to
    `max_batch`, waiting at most `max_wait_ms` for the batch to fill), and
    same-bucket requests batch together;
  * `warmup()` runs one call per bucket, so the kernels are built and the
    allocator is warm before the first caller arrives;
  * per-request `timeout_s` (from submit time) surfaces as TimeoutError on
    the Future instead of wedging the queue;
  * graceful `close()` drains the queue and joins the worker.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np

from mmda_tpu_torch.serving_requests import validate_request

if TYPE_CHECKING:
    from mmda_tpu_torch.serving import Predictor


class _Pending:
    __slots__ = ("request", "future", "deadline")

    def __init__(self, request, future, deadline):
        self.request = request
        self.future = future
        self.deadline = deadline


class PredictionServer:
    def __init__(
        self,
        predictor: Predictor,
        max_wait_ms: float = 5.0,
        default_timeout_s: Optional[float] = None,
    ):
        self._predictor = predictor
        self._max_wait = max_wait_ms / 1e3
        self._default_timeout = default_timeout_s
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._closed = False
        # serializes submit()'s closed-check+put against close()'s sentinel
        # put, so no request can land BEHIND the shutdown sentinel (where the
        # worker would never see it and its Future would hang forever)
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(self, request: Dict, timeout_s: Optional[float] = None) -> Future:
        """Enqueue one request dict (same schema as Predictor.__call__ rows).
        Returns a Future resolving to that row's result dict.

        Raises ValueError immediately on a malformed request (e.g. missing
        'text') so bad input fails at the submitting caller, not inside the
        shared batching worker."""
        validate_request(request)
        timeout = timeout_s if timeout_s is not None else self._default_timeout
        deadline = (time.monotonic() + timeout) if timeout else None
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(_Pending(request, fut, deadline))
        return fut

    def predict(self, request: Dict, timeout_s: Optional[float] = None) -> Dict:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(request, timeout_s).result(timeout=timeout_s)

    def warmup(self, visual_size: Optional[int] = None,
               acoustic_size: Optional[int] = None) -> None:
        """One call per bucket, so no caller pays the first-use costs."""
        p = self._predictor
        dv = visual_size or p.visual_size or p.cfg.visual_size
        da = acoustic_size or p.acoustic_size or p.cfg.acoustic_size
        for b in sorted(p.cfg.bucket_sizes):
            req = {
                "text": np.zeros((b,), np.int32),
                "visual": np.zeros((b, dv), np.float32),
                "acoustic": np.zeros((b, da), np.float32),
                "bert_ids": np.zeros((b + 2,), np.int32),
                "bert_type": np.zeros((b + 2,), np.int32),
                "bert_mask": np.ones((b + 2,), np.int32),
            }
            p([req])

    def close(self, drain: bool = True) -> None:
        """Stop the worker.  With drain=True, queued work completes first;
        otherwise pending futures get CancelledError."""
        with self._submit_lock:
            self._closed = True
            if not drain:
                while True:
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        item.future.cancel()
            self._queue.put(None)
        self._worker.join()

    @property
    def stats(self) -> Dict[str, float]:
        return self._predictor.stats

    # ---------------------------------------------------------------- worker

    def _collect(self) -> Sequence[Optional[_Pending]]:
        """Block for one request, then soak up more until the batch fills or
        max_wait elapses."""
        first = self._queue.get()
        if first is None:
            return [None]
        batch = [first]
        deadline = time.monotonic() + self._max_wait
        while len(batch) < self._predictor.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(item)
            if item is None:
                break
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            stop = batch[-1] is None
            if stop:
                batch = batch[:-1]
            now = time.monotonic()
            live = []
            for p in batch:
                if p.future.cancelled():
                    continue
                if p.deadline is not None and now > p.deadline:
                    p.future.set_exception(
                        TimeoutError("request expired in queue"))
                    continue
                live.append(p)
            # group by bucket so one long request doesn't pad every short one
            # up to its bucket (each group hits an already-warm program).
            # Defense in depth: submit() validated the request, but anything
            # that still fails here fails ONLY its own future — an exception
            # on this worker thread would strand every queued caller.
            groups: Dict[int, list] = {}
            for p in live:
                try:
                    text = p.request.get("text")
                    n = len(text.split()) if isinstance(text, str) else len(text)
                    groups.setdefault(self._predictor._bucket(n), []).append(p)
                except Exception as e:
                    if not p.future.done():
                        p.future.set_exception(e)
            for _, grp in sorted(groups.items()):
                try:
                    result = self._predictor([p.request for p in grp])
                    for i, p in enumerate(grp):
                        p.future.set_result(
                            {k: v[i] for k, v in result.items()})
                except Exception as e:  # surface, don't wedge the worker
                    for p in grp:
                        if not p.future.done():
                            p.future.set_exception(e)
            if stop:
                return
