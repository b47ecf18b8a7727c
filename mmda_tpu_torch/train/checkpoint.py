"""Read side of the JAX package's checkpoints (best-on-dev exports).

`mmda_tpu/train/checkpoint.py::save_checkpoint` writes
`{ckpt_dir}/{name}.msgpack` in the fastser codec (`mmda_tpu/train/
fastser.py`):

    MMDAFSR1 | header length (8 bytes, little-endian) | JSON header | leaf bytes

The header lists every leaf with its '/'-joined path and either an inline
value or {dtype, shape, offset, nbytes} into the leaf bytes.  This module
parses it with json and numpy alone; bfloat16 leaves are read as uint16 and
viewed as torch.bfloat16.  Legacy flax-msgpack payloads are refused.  The
writer comes with the training path.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

MAGIC = b"MMDAFSR1"


def _leaf(data: bytearray, base: int, ent: Dict) -> torch.Tensor:
    name = ent["dtype"]
    off = base + ent["offset"]
    if name == "bfloat16":
        arr = np.frombuffer(data, np.uint16, ent["nbytes"] // 2, off)
        return torch.from_numpy(arr.reshape(ent["shape"])).view(torch.bfloat16)
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"leaf {ent['path']!r} has dtype {name!r}, which the "
                         "port cannot read") from None
    arr = np.frombuffer(data, dt, ent["nbytes"] // dt.itemsize, off)
    return torch.from_numpy(arr.reshape(ent["shape"]))


def from_bytes(data: bytes) -> Dict[str, Any]:
    """Nested dict of tensors / inline values from a fastser payload."""
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError(
            "not a fastser checkpoint (no MMDAFSR1 magic): legacy flax-msgpack "
            "checkpoints cannot be read by the port; re-save it with the JAX "
            "package's default codec")
    buf = bytearray(data)          # writable, so tensors view it without a copy
    n = int.from_bytes(buf[8:16], "little")
    header = json.loads(bytes(buf[16:16 + n]).decode())
    base = 16 + n
    nested: Dict[str, Any] = {}
    for ent in header:
        if ent.get("empty_dict"):
            leaf: Any = {}
        elif "dtype" in ent:
            leaf = _leaf(buf, base, ent)
        else:
            leaf = ent.get("value")
        parts = ent["path"].strip("/").split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return nested


def load_checkpoint(ckpt_dir: str, name: str) -> Dict[str, Any]:
    """The parameter tree saved as {ckpt_dir}/{name}.msgpack."""
    with open(os.path.join(ckpt_dir, f"{name}.msgpack"), "rb") as f:
        return from_bytes(f.read())


def best_model_name(cfg) -> str:
    """Best-on-dev export name: best_model_{model}[_C]_{data}."""
    suffix = "_C" if cfg.use_confidNet else ""
    return f"best_model_{cfg.model}{suffix}_{cfg.data}"
