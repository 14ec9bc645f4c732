"""Stateless integer hashes behind the samplers.

PyTorch port of mitsuba_customization_tpu/core/qmc.py (`hash_u32`,
`hash_combine`). PyTorch's uint32 lacks most arithmetic, so the uint32
maths runs in int64 with every intermediate masked to 32 bits; the results
are bit-identical to the JAX package's uint32 streams.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x, like=None):
    """Python int or integer tensor -> int64 tensor holding a uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    device = like.device if like is not None else None
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32.

    Split at 16 bits so no product leaves int64's range.
    """
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_u32(x):
    """lowbias32 integer hash (Wang-style avalanche), uint32 -> uint32."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(a, b):
    """Mix two uint32 streams into one (order-sensitive)."""
    a = a & MASK32
    b = b & MASK32
    mixed = (b + 0x9E3779B9 + ((a << 6) & MASK32) + (a >> 2)) & MASK32
    return hash_u32(a ^ mixed)
