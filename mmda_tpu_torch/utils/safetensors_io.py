"""Read a `.safetensors` file without the `safetensors` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`), then the tensors' raw little-endian bytes, each at its offsets
from the end of the header.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
           "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
           "U8": np.uint8, "BOOL": np.bool_}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of every tensor in the file, in its stored dtype."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"which this reader does not know ({sorted(_DTYPES)})")
        begin, end = info["data_offsets"]
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(data, dtype, count=(end - begin) // dtype.itemsize,
                            offset=begin).reshape(info["shape"])
        t = torch.from_numpy(arr.astype(dtype.newbyteorder("="), copy=True))
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out
