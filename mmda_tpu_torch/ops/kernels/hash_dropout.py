"""The positional hash that draws dropout masks inside kernels: the plain
PyTorch version of `csrc/hash_dropout.cuh`.

Counterpart of `mmda_tpu/ops/pallas/layernorm.py::_keep_mask` (the same
avalanche as the attention kernels').  The mask is a pure function of
(seed, absolute row, column), so a backward kernel regenerates it instead of
reading it, and it does not depend on how rows are cut into blocks.  Bit for
bit:

    x = row * 2654435761 + col * 0x9E3779B9 + seed * 40503     (uint32, wraps)
    x ^= x >> 16;  x *= 0x7FEB352D;  x ^= x >> 15;  x *= 0x846CA68B;  x ^= x >> 16
    u = float(x >> 8) * 2^-24                                   (24 bits, exact)
    keep = u >= float32(rate);   kept values scale by float32(1 / (1 - rate))

The attention kernels (`mmda_tpu/ops/pallas/attention.py::_keep_mask`) mix
their position in their own way and share the rest:

    x = row * 2654435761 + col * 0x9E3779B9 + seed * 40503 + bh * 51329

with (row, col) the absolute position in the S x S score matrix and bh the
flattened (batch, head) index: `attention_keep_mask`.  Under tensor
parallelism a rank holds heads head0 .. head0 + heads_local - 1 of
heads_total, and its local index bh = b * heads_local + h stands for

    bh_global = (bh // heads_local) * heads_total + head0 + bh % heads_local

(`global_bh`), so that every rank draws the masks of the heads it holds; the
short kernels likewise take h = head0 + the local head.

Under sequence parallelism a rank's LayerNorm rows are, for each batch item
b, rows s0 .. s0 + s_local - 1 of its S = s_total: the row layout
(s_local, s_total, s0) maps local row r to the row hashed,

    row = (r // s_local) * s_total + s0 + r % s_local

(`layout_rows`), and (N, N, 0) is a launch's own rows.

Here the uint32 arithmetic is int64 masked to 32 bits after every step that
can carry past them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF


def keep_scale(rate: float) -> float:
    """float32(1 / (1 - rate)), what a kept value is multiplied by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def avalanche(x: torch.Tensor) -> torch.Tensor:
    """The avalanche every kernel's hash ends in (`hash_avalanche` of the
    header): int64 values below 2^32 -> float32 uniforms in [0, 1) with 24
    bits.  The attention kernels mix their position into x in their own way."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _seed_term(seed: Union[int, torch.Tensor], device):
    """(seed as uint32) * 40503 mod 2^32 and the device the mask lies on: by
    default the seed's (the CPU for an int).  A tensor seed is read on its
    device, with no copy to the host; a negative seed wraps."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        seed = seed.reshape(()).to(device=device, dtype=torch.int64) & M32
    else:
        seed = int(seed) & M32
    return (seed * 40503) & M32, device


RowLayout = Tuple[int, int, int]     # (s_local, s_total, s0)


def layout_rows(rows: torch.Tensor, layout: Optional[RowLayout]) -> torch.Tensor:
    """The rows the LayerNorm kernels hash for local rows `rows` (int64)
    under the row layout (module docstring; None: the rows themselves)."""
    if layout is None:
        return rows
    s_local, s_total, s0 = layout
    return (rows // s_local) * s_total + s0 + rows % s_local


def keep_mask(shape: Tuple[int, int], rate: float, seed: Union[int, torch.Tensor],
              row0: int = 0, device=None, layout: Optional[RowLayout] = None) -> torch.Tensor:
    """float32 (rows, cols) mask, 1.0 where the element at absolute position
    (row0 + r, c) is kept under `seed`, the row placed by `layout`
    (`layout_rows`).  seed: an int or a one-element integer tensor; the mask
    lies on `device`, by default the seed's."""
    seed_term, device = _seed_term(seed, device)
    n_rows, n_cols = shape
    rows = layout_rows(torch.arange(n_rows, dtype=torch.int64, device=device) + int(row0),
                       layout) & M32
    cols = torch.arange(n_cols, dtype=torch.int64, device=device)
    x = ((rows * 2654435761) & M32)[:, None] + ((cols * 0x9E3779B9) & M32)[None, :]
    u = avalanche((x + seed_term) & M32)
    return (u >= float(np.float32(rate))).to(torch.float32)


HeadLayout = Tuple[int, int, int]    # (heads_local, heads_total, head0)
ALL_HEADS: HeadLayout = (1, 1, 0)    # bh_global = bh: every head in one process


def global_bh(bh, heads: HeadLayout = ALL_HEADS):
    """The (batch, head) index the attention kernels hash for the local
    index bh of a rank holding heads head0 .. head0 + heads_local - 1 of
    heads_total (ints or an integer tensor)."""
    heads_local, heads_total, head0 = heads
    return (bh // heads_local) * heads_total + head0 + bh % heads_local


def attention_keep_mask(shape: Tuple[int, int, int], rate: float,
                        seed: Union[int, torch.Tensor], bh0: int = 0, row0: int = 0,
                        col0: int = 0, device=None,
                        heads: HeadLayout = ALL_HEADS) -> torch.Tensor:
    """float32 (BH, rows, cols) mask of the attention kernels, 1.0 where the
    probability of query row0 + r and key col0 + c in local (batch, head)
    bh0 + b is kept under `seed`; `heads` maps a local index to the one
    hashed (`global_bh`)."""
    seed_term, device = _seed_term(seed, device)
    n_bh, n_rows, n_cols = shape

    def term(index, factor):
        return ((index & M32) * factor) & M32

    def positions(n, start):
        return torch.arange(n, dtype=torch.int64, device=device) + int(start)

    x = (term(positions(n_rows, row0), 2654435761)[:, None]
         + term(positions(n_cols, col0), 0x9E3779B9)[None, :])
    bh = global_bh(positions(n_bh, bh0), heads)
    x = (x & M32)[None] + ((term(bh, 51329) + seed_term) & M32)[:, None, None]
    return (avalanche(x & M32) >= float(np.float32(rate))).to(torch.float32)


def short_attention_keep_mask(S: int, rate: float, seed: Union[int, torch.Tensor],
                              b=0, h=0, device=None) -> torch.Tensor:
    """float32 (S, S) mask of the short attention kernels
    (`mmda_tpu/ops/pallas/short_attention.py::_dropout_mask`), 1.0 where the
    probability of query r and key c in batch item b, head h is kept under
    `seed`.  Their own mix, with S the call's own sequence length:

        x = r * S + c + seed * 2654435761 + b * 40503 + h * 51329

    b and h: ints, or integer tensors that broadcast against (S, S) and add
    their leading dims (the plain version passes (B, 1, 1, 1) and
    (1, nh, 1, 1) aranges for the whole (B, nh, S, S) mask)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        seed = seed.reshape(()).to(device=device, dtype=torch.int64)

    def term(index, factor):
        """(index as uint32) * factor mod 2^32, in int64 without overflow:
        the factor's two 16-bit halves apart."""
        index = torch.as_tensor(index, dtype=torch.int64, device=device) & M32
        high = ((index * (factor >> 16)) & 0xFFFF) << 16
        return (index * (factor & 0xFFFF) + high) & M32

    pos = torch.arange(S * S, dtype=torch.int64, device=device).reshape(S, S)
    x = pos + term(seed, 2654435761) + term(b, 40503) + term(h, 51329)
    return (avalanche(x & M32) >= float(np.float32(rate))).to(torch.float32)
