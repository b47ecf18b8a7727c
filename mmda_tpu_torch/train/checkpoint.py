"""Best-on-dev checkpoints in the JAX package's format, read and written.

`mmda_tpu/train/checkpoint.py::save_checkpoint` writes
`{ckpt_dir}/{name}.msgpack` in the fastser codec (`mmda_tpu/train/
fastser.py`), with the run's metadata beside it in `{name}.json`:

    MMDAFSR1 | header length (8 bytes, little-endian) | JSON header | leaf bytes

The header lists every leaf with its '/'-joined path and either an inline
value or {dtype, shape, offset, nbytes} into the leaf bytes.  This module
parses and writes it with json and numpy alone; bfloat16 leaves are read
as their uint16 bits.  Legacy flax-msgpack payloads are refused.

`save_checkpoint` writes a model's parameters as the JAX parameter tree
(`convert.to_jax_tree`), so the JAX package's `load_checkpoint` and the
port's `Predictor` both load what the port's trainer saves.  Writes go to a
temporary file in the same directory and are renamed into place.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

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


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, f"{name}.msgpack"))


def _leaves(tree: Dict[str, Any], prefix: str, out: List) -> None:
    """(path, tensor) in fastser order: keys sorted at every level."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _leaves(tree[k], f"{prefix}/{k}", out)
        else:
            out.append((f"{prefix}/{k}", tree[k]))


def to_chunks(tree: Dict[str, Any]) -> List[bytes]:
    """[header, leaf bytes, ...] of a nested dict of tensors."""
    leaves: List = []
    _leaves(tree, "", leaves)
    header, buffers, offset = [], [], 0
    for path, leaf in leaves:
        arr = leaf.detach().to("cpu").contiguous().numpy()
        data = arr.tobytes()
        header.append({"path": path, "dtype": arr.dtype.name, "shape": list(arr.shape),
                       "offset": offset, "nbytes": len(data)})
        buffers.append(data)
        offset += len(data)
    hdr = json.dumps(header).encode()
    return [MAGIC + len(hdr).to_bytes(8, "little") + hdr, *buffers]


def _atomic_write(path: str, chunks: List[bytes]) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_checkpoint(ckpt_dir: str, name: str, model: nn.Module,
                    metadata: Optional[Dict] = None) -> str:
    """Write `model`'s parameters as {ckpt_dir}/{name}.msgpack (the JAX
    tree layout) and `metadata` as {name}.json; returns the .msgpack path."""
    from mmda_tpu_torch.convert import to_jax_tree

    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.msgpack")
    _atomic_write(path, to_chunks(to_jax_tree(model)))
    _atomic_write(os.path.join(ckpt_dir, f"{name}.json"),
                  [json.dumps(dict(metadata or {}), indent=2, default=str).encode()])
    return path


def best_model_name(cfg) -> str:
    """Best-on-dev export name: best_model_{model}[_C]_{data}."""
    suffix = "_C" if cfg.use_confidNet else ""
    return f"best_model_{cfg.model}{suffix}_{cfg.data}"
