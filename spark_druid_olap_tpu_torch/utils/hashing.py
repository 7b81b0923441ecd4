"""Vectorized 32-bit hashing on the device, shared by the HLL, theta and
quantile sketches.

The hashes are murmur3 fmix32 finalizers over uint32 lanes, bit-equal to
the reference package's `utils/hashing.py`.  PyTorch has no usable uint32
arithmetic on every device (the CPU has no `>>` for it), so a uint32 value
is carried in int64, in [0, 2^32), and masked with `& 0xFFFFFFFF` after
every step that can leave that range.  A product of two 32-bit values can
overflow int64, so `_mul32` multiplies by the constant's 16-bit halves:
every intermediate stays below 2^49 and the low 32 bits come out exact on
every device.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3 fmix32 over uint32 lanes carried in int64; decorrelated by
    seed.  `x` is any integer tensor: it is taken modulo 2^32 first."""
    h = (x.to(torch.int64) & MASK32) ^ ((seed * 0x9E3779B9 + 0x85EBCA6B) & MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mix32_np(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Numpy twin of `mix32` (for host oracles): uint32 in, uint32 out."""
    h = x.astype(np.uint32) ^ np.uint32((seed * 0x9E3779B9 + 0x85EBCA6B) & MASK32)
    h = h ^ (h >> 16)
    h = (h * np.uint32(0x85EBCA6B)) & np.uint32(MASK32)
    h = h ^ (h >> 13)
    h = (h * np.uint32(0xC2B2AE35)) & np.uint32(MASK32)
    return h ^ (h >> 16)


def hash_column(col: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash one column (int codes / int64-ms times / float metrics) to uint32
    in int64, taking the reference's branch for the column's dtype."""
    if col.dtype in (torch.float32, torch.bfloat16, torch.float16):
        f = col.to(torch.float32)
        bits = f.view(torch.int32).to(torch.int64) & MASK32
        # normalize -0.0 / 0.0 so equal SQL values hash equal
        bits = torch.where(f == 0, torch.zeros_like(bits), bits)
        return mix32(bits, seed)
    if col.dtype == torch.int64:
        lo = col & MASK32
        hi = (col >> 32) & MASK32
        return mix32(lo ^ mix32(hi, seed + 1), seed)
    # every other dtype converts to uint32: integers wrap (negative codes
    # sign-extend), floats truncate toward zero
    return mix32(col.to(torch.int64), seed)


def combine_hashes(hashes) -> torch.Tensor:
    """Order-dependent combine for multi-column (byRow) cardinality."""
    acc = hashes[0]
    for h in hashes[1:]:
        acc = mix32(acc * 31 + h)
    return acc

