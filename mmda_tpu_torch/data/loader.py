"""Length-bucketed, fixed-shape batches from a dict-of-arrays split.

The port's copy of `mmda_tpu/data/loader.py::ArrayLoader`.  The host side
is the same code, so a seed gives the same batches in the same order:

* rows go to the smallest length bucket that holds them, and a batch is
  cut from one bucket, its time axes trimmed to the bucket (BERT axes to
  bucket + 2);
* with shuffle, the row order is one `permutation` and the batch plan one
  `shuffle` of `np.random.default_rng(seed)` per epoch;
* a short batch is padded with zero rows of length 1 and sample_weight 0;
  with drop_last (training) it is dropped instead.

Iteration yields `Batch`es on `device`: each array is copied from pinned
host memory with `non_blocking`, so the copy overlaps the host's work.  Id
arrays (text, bert_ids, bert_type) become int64 for the embedding lookups.
`StaticBatch` makes the same copies into device buffers kept for one batch
shape, which a captured step reads at every replay.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from mmda_tpu_torch.models.misa import Batch

REQUIRED_KEYS = tuple(f for f in Batch._fields
                      if f not in ("sample_weight", "visual_lengths", "acoustic_lengths"))
ARRAY_KEYS = tuple(Batch._fields)
ID_KEYS = ("text", "bert_ids", "bert_type")


def _trim(arrays: Dict[str, np.ndarray], idx: np.ndarray, t: int) -> Dict[str, np.ndarray]:
    """Rows `idx`, time axes cut to bucket length t (visual/acoustic keep
    their own axes when the split is unaligned)."""
    unaligned = "visual_lengths" in arrays
    out = {}
    for k, v in arrays.items():
        v = v[idx]
        if k == "text" or (k in ("visual", "acoustic") and not unaligned):
            v = v[:, :t]
        elif k in ("bert_ids", "bert_type", "bert_mask"):
            v = v[:, : t + 2]
        out[k] = v
    return out


def _pad_rows(arrays: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Pad to n rows: zeros, length 1, one valid BERT position,
    sample_weight 0."""
    out = {}
    k0 = len(next(iter(arrays.values())))
    pad = n - k0
    for k, v in arrays.items():
        p = np.zeros((pad,) + v.shape[1:], v.dtype)
        if k in ("lengths", "visual_lengths", "acoustic_lengths"):
            p[:] = 1
        if k == "bert_mask":
            p[:, :1] = 1
        out[k] = np.concatenate([v, p], axis=0)
    out["sample_weight"] = np.concatenate(
        [arrays.get("sample_weight", np.ones(k0, np.float32)), np.zeros(pad, np.float32)])
    return out


def auto_bucket_sizes(lengths, n_buckets: int = 3) -> tuple:
    """Bucket boundaries that minimise padded tokens over the length
    histogram (exact DP; `--bucket_sizes auto[,K]`)."""
    lengths = np.asarray(lengths)
    uniq, counts = np.unique(lengths[lengths > 0], return_counts=True)
    U = len(uniq)
    k = min(int(n_buckets), U)
    if U == 0:
        raise ValueError("auto_bucket_sizes: no positive lengths")
    csum = np.concatenate([[0], np.cumsum(counts)])
    dp = np.full((k + 1, U + 1), float("inf"))
    arg = np.zeros((k + 1, U + 1), np.int64)
    dp[0][0] = 0.0
    for kk in range(1, k + 1):
        for j in range(1, U + 1):
            best, besti = float("inf"), 0
            for i in range(kk - 1, j):
                c = dp[kk - 1][i] + float(uniq[j - 1]) * (csum[j] - csum[i])
                if c < best:
                    best, besti = c, i
            dp[kk][j], arg[kk][j] = best, besti
    bounds = []
    j = U
    for kk in range(k, 0, -1):
        bounds.append(int(uniq[j - 1]))
        j = arg[kk][j]
    return tuple(sorted(set(bounds)))


def _host_tensors(arrays: Dict[str, Optional[np.ndarray]], device: torch.device) -> Dict:
    """Each Batch field of a host batch as a CPU tensor (id arrays int64),
    pinned when it is bound for the card; None where the batch has none."""
    pin = device.type == "cuda"
    out = {}
    for k in ARRAY_KEYS:
        a = arrays.get(k)
        if a is not None:
            a = torch.from_numpy(np.ascontiguousarray(a))
            if k in ID_KEYS:
                a = a.long()
            if pin:
                a = a.pin_memory()
        out[k] = a
    return out


def to_device(arrays: Dict[str, Optional[np.ndarray]], device: torch.device) -> Batch:
    """A host batch as a `Batch` on `device` (pinned, non-blocking copies)."""
    return Batch(**{k: None if t is None else t.to(device, non_blocking=True)
                    for k, t in _host_tensors(arrays, device).items()})


def batch_shape(arrays: Dict[str, Optional[np.ndarray]]) -> tuple:
    """What one set of static buffers holds: each field's shape and dtype."""
    return tuple((k, None if arrays.get(k) is None else
                  (np.shape(arrays[k]), np.asarray(arrays[k]).dtype.str)) for k in ARRAY_KEYS)


class StaticBatch:
    """Device buffers for the host batches of one `batch_shape`: `load`
    copies a batch into them in place (pinned, non-blocking copies, as
    `to_device` makes them) and returns `batch`, the same tensors every
    time."""

    def __init__(self, arrays: Dict[str, Optional[np.ndarray]], device: torch.device):
        self.device = torch.device(device)
        self.shape = batch_shape(arrays)
        self.batch = Batch(**{k: None if t is None else torch.empty_like(t, device=self.device)
                              for k, t in _host_tensors(arrays, torch.device("cpu")).items()})

    def load(self, arrays: Dict[str, Optional[np.ndarray]]) -> Batch:
        if batch_shape(arrays) != self.shape:
            raise ValueError(f"batch of shape {batch_shape(arrays)} for buffers of {self.shape}")
        for buf, t in zip(self.batch, _host_tensors(arrays, self.device).values()):
            if buf is not None:
                buf.copy_(t, non_blocking=True)
        return self.batch


class ArrayLoader:
    """Iterate fixed-shape `Batch`es over a dict-of-arrays split."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, drop_last: bool = False,
                 bucket_sizes: Optional[Sequence[int]] = None, seed: int = 0,
                 device="cpu"):
        missing = set(REQUIRED_KEYS) - set(data)
        if missing:
            raise ValueError(f"split missing arrays: {sorted(missing)}")
        self.data = dict(data)
        if "sample_weight" not in self.data:
            self.data["sample_weight"] = np.ones(len(self.data["lengths"]), np.float32)
        self.n = len(self.data["lengths"])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

        t_max = self.data["text"].shape[1]
        buckets = sorted(b for b in (bucket_sizes or [t_max]) if b <= t_max)
        if not buckets or buckets[-1] < t_max:
            buckets = list(buckets) + [t_max]
        self.bucket_sizes = buckets
        self._bucket_of = np.searchsorted(np.asarray(buckets), self.data["lengths"],
                                          side="left")

    def __len__(self) -> int:
        sizes = [int(np.sum(self._bucket_of == b)) for b in range(len(self.bucket_sizes))]
        if self.drop_last:
            return sum(s // self.batch_size for s in sizes)
        return sum(-(-s // self.batch_size) for s in sizes)

    def host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of host-side batches, each filtered to the Batch fields
        (a missing optional field is None)."""
        order = np.arange(self.n)
        if self.shuffle:
            order = self._rng.permutation(self.n)
        plan = []                                  # (bucket length, row indices)
        for b, t in enumerate(self.bucket_sizes):
            rows = order[self._bucket_of[order] == b]
            for i in range(0, len(rows), self.batch_size):
                chunk = rows[i: i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                plan.append((t, chunk))
        if self.shuffle and len(self.bucket_sizes) > 1:
            self._rng.shuffle(plan)
        for t, chunk in plan:
            arrays = _trim(self.data, chunk, t)
            if len(chunk) < self.batch_size:
                arrays = _pad_rows(arrays, self.batch_size)
            yield {k: arrays.get(k) for k in ARRAY_KEYS}

    def __iter__(self) -> Iterator[Batch]:
        for arrays in self.host_batches():
            yield to_device(arrays, self.device)
