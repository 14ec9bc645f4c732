"""Stateless integer hashes and the Owen-scrambled Sobol' (0,2)-sequence
behind the samplers.

PyTorch port of mitsuba_customization_tpu/core/qmc.py (`hash_u32`,
`hash_combine`, `reverse_bits32`, `owen_scramble`, `sobol_u32`,
`sobol_owen_2d`). PyTorch's uint32 lacks most arithmetic, so the uint32
maths runs in int64 with every intermediate masked to 32 bits; the results
are bit-identical to the JAX package's uint32 streams.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x, like=None):
    """An integer tensor -> int64 tensor holding a uint32 value; a Python
    int -> that value as a Python int (the hashes below take either, and
    combined with a tensor give the same bits as a 0-d tensor would: no
    host-to-device copy, so a captured frame holds no constant of it).
    `like` is the JAX package's argument and is not read."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


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


def reverse_bits32(x):
    """Bit-reverse a uint32 (in int64)."""
    x = x & MASK32
    x = ((x >> 16) | (x << 16)) & MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


def _laine_karras_permutation(x, seed):
    """Owen-scramble the (reversed-bit) value x with the given seed
    (Burley, "Practical Hash-based Owen Scrambling", JCGT 2020). Each
    product of two 32-bit values goes through _mul32."""
    x = (x + seed) & MASK32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(x, seed):
    """Owen-scramble x (a radical-inverse-style uint32) with seed."""
    return reverse_bits32(_laine_karras_permutation(reverse_bits32(x), seed))


def sobol_u32(index, dim):
    """Unscrambled Sobol' sample `index` of dimension 0 or 1 as uint32:
    dim 0 is the van der Corput sequence (bit reversal), dim 1 the second
    Sobol' dimension (v_{k+1} = v_k ^ (v_k >> 1))."""
    index = index & MASK32
    if dim == 0:
        return reverse_bits32(index)
    out = torch.zeros_like(index)
    v = 1 << 31
    for _ in range(32):
        out = torch.where((index & 1) != 0, out ^ v, out)
        index = index >> 1
        v = v ^ (v >> 1)
    return out


def _u32_to_unit_float(x):
    """uint32 (in int64) -> float32 in [0, 1) from the top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sobol_owen_2d(index, seed):
    """Owen-scrambled (0,2)-sequence point `index` -> (..., 2) in [0,1)^2;
    `seed` decorrelates lanes (sample indices of one pixel share it)."""
    seed = seed & MASK32
    s0 = hash_u32(seed)
    s1 = hash_u32(seed ^ 0xDEADBEEF)
    # the index is scrambled too: a per-lane sample order over the same net
    idx = owen_scramble(index & MASK32, hash_u32(seed ^ 0x55AA55AA))
    x = owen_scramble(sobol_u32(idx, 0), s0)
    y = owen_scramble(sobol_u32(idx, 1), s1)
    return torch.stack([_u32_to_unit_float(x), _u32_to_unit_float(y)], -1)
