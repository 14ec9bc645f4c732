"""Per-lane stateless samplers (counter-based hash RNG + low-discrepancy).

PyTorch port of mitsuba_customization_tpu/core/sampler.py: the
`independent`, `stratified`, `sobol` / `ldsampler`, `multijitter` and
`orthogonal` samplers. Every random number is a pure function of (seed,
lane or pixel and sample index, dimension), so at a fixed seed the port
draws the same uniforms as the JAX package, bit for bit, and needs no
`torch.Generator`. The dimension is a Python-int base (set per bounce by
`with_dim`; bases are even, so the Sobol' pair parity is static) plus a
Python offset advanced by `next_1d` / `next_2d`. The uint32 arithmetic runs
in int64 masked to 32 bits (core/qmc.py); products of two 32-bit values go
through qmc._mul32.

Each class names in ARRAYS the per-lane tensors it reads: wavefront
compaction (render/integrator._run_bounces_compact) carries exactly those
through its permutation and rebuilds the bounce's sampler with
`with_lanes`, so a compacted lane draws what it draws uncompacted.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.qmc import (
    MASK32,
    _mul32,
    as_u32,
    hash_combine,
    sobol_owen_2d,
)


def _uniform_from_bits(bits):
    """uint32 (in int64) -> float32 in [0, 1) from the top 24 bits; a
    Python int -> the same value as a Python float (exact: 24 bits times a
    power of two)."""
    if not torch.is_tensor(bits):
        return (bits >> 8) * (1.0 / (1 << 24))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _div(x, n):
    """x / n elementwise for a Python number n. A divisor tensor, not a
    scalar: CUDA multiplies by the reciprocal of a scalar divisor, which
    rounds differently from the division the JAX package does."""
    return x / torch.full_like(x, float(n))


class Sampler:
    """Deterministic per-(lane, dim) sample streams.

    seed: uint32 Python int, or a 0-d int64 tensor on the lanes' device
    (a captured frame's seed buffer, render/frame_graph.py: the draws are
    bit-equal to the int's, and the sampler then reads nothing back to the
    host); lane: int64 tensor of lane ids (pixel * spp + sample index,
    masked to 32 bits); base_dim: Python int; dim: Python offset within
    the base.
    """

    ARRAYS = ("lane",)

    def __init__(self, seed, lane, dim=0, base_dim=0):
        self.seed = seed & MASK32 if torch.is_tensor(seed) else int(seed) & MASK32
        self.lane = lane
        self.dim = dim
        self.base_dim = int(base_dim)

    def clone(self):
        return copy.copy(self)

    def with_dim(self, base_dim):
        """Sampler repositioned at a dimension base, offset 0."""
        out = copy.copy(self)
        out.dim, out.base_dim = 0, int(base_dim)
        return out

    def with_lanes(self, **arrays):
        """A clone holding other per-lane tensors (the names of ARRAYS)."""
        out = copy.copy(self)
        for name, a in arrays.items():
            setattr(out, name, a)
        return out

    def _dim_value(self, offset):
        return as_u32(self.base_dim + offset, self.lane)

    def _seed(self, xor=0):
        return as_u32(self.seed ^ xor, self.lane)

    def next_1d(self):
        u = self._draw(self.dim)
        self.dim += 1
        return u

    def next_2d(self):
        u = torch.stack([self._draw(self.dim), self._draw(self.dim + 1)], -1)
        self.dim += 2
        return u

    def _draw(self, dim):  # pragma: no cover - abstract
        raise NotImplementedError


class IndependentSampler(Sampler):
    """Counter-based uniform sampler: the reference's `independent` plugin.
    hash_combine(seed, lane), shared by every draw of a lane, is kept as
    `_lane_key` and rides compaction with the lane."""

    ARRAYS = ("lane", "_lane_key")

    def __init__(self, seed, lane, dim=0, base_dim=0, _lane_key=None):
        super().__init__(seed, lane, dim, base_dim)
        self._lane_key = (
            _lane_key if _lane_key is not None
            else hash_combine(self._seed(), lane)
        )

    def _draw(self, dim):
        return _uniform_from_bits(hash_combine(self._lane_key, self._dim_value(dim)))


class SobolSampler(Sampler):
    """Owen-scrambled Sobol' (0,2)-sequence sampler: the reference's
    `ldsampler`. Consecutive 2-D dimension pairs use independently
    scrambled copies of the sequence, keyed by (seed, pixel, pair)."""

    ARRAYS = ("lane", "pixel", "sample_index")

    def __init__(self, seed, lane, dim=0, base_dim=0, pixel=None, sample_index=None):
        super().__init__(seed, lane, dim, base_dim)
        self.pixel = lane if pixel is None else pixel & MASK32
        self.sample_index = (torch.zeros_like(lane) if sample_index is None
                             else sample_index & MASK32)

    @classmethod
    def from_pixel(cls, seed, pixel, sample_index, spp):
        lane = (pixel * spp + sample_index) & MASK32
        return cls(seed, lane, 0, 0, pixel=pixel, sample_index=sample_index)

    def _pair(self, pair_offset):
        pair_dim = as_u32((self.base_dim >> 1) + pair_offset, self.lane)
        scramble = hash_combine(hash_combine(self._seed(), self.pixel), pair_dim)
        return sobol_owen_2d(self.sample_index, scramble)

    def _draw(self, dim):
        return self._pair(dim // 2)[..., dim % 2]

    def next_2d(self):
        if self.dim % 2 == 0:
            pair = self._pair(self.dim // 2)
            self.dim += 2
            return pair
        return super().next_2d()


class StratifiedSampler(Sampler):
    """Jittered-stratified sampler: the reference's `stratified` plugin.
    Each dimension is stratified over the sample index by a per-(pixel,
    dim) cyclic shift, jittered by the hash stream."""

    ARRAYS = ("lane", "sample_index")

    def __init__(self, seed, lane, dim=0, base_dim=0, sample_index=None, spp=1):
        super().__init__(seed, lane, dim, base_dim)
        self.spp = int(spp)
        self.sample_index = (torch.zeros_like(lane) if sample_index is None
                             else sample_index & MASK32)

    @classmethod
    def from_pixel(cls, seed, pixel, sample_index, spp):
        lane = (pixel * spp + sample_index) & MASK32
        return cls(seed, lane, 0, 0, sample_index=sample_index, spp=spp)

    def _pixel(self):
        return self.lane // self.spp

    def _permute(self, i, l, p):
        """_kensler_permute, stopping early only under a Python-int seed
        (a tensor seed is a captured frame's: no host reads)."""
        return _kensler_permute(i, l, p, early_stop=not torch.is_tensor(self.seed))

    def _draw(self, dim):
        d = self._dim_value(dim)
        jitter = _uniform_from_bits(hash_combine(hash_combine(self._seed(), self.lane), d))
        offset = hash_combine(hash_combine(self._seed(0xA511E9B3), self._pixel()), d)
        stratum = (((self.sample_index + offset) & MASK32) % self.spp).to(torch.float32)
        return _div(stratum + jitter, self.spp)


def _kensler_permute(i, l, p, rounds=24, early_stop=True):
    """Cycle-walking hash permutation of [0, l) (the pattern of Kensler
    2013): `rounds` lock-step rounds, each a bijection of the masked
    field, applied where the value is still >= l; a lane still out of
    range then falls back to i % l, as the JAX package's. A round's value
    lies in [0, w], w + 1 the power of two at or above l, so for l a power
    of two the first round is the answer and no walk is made. With
    early_stop the walk stops once no lane is out of range (checked on
    the host every 4 rounds: lanes in range do not change, so the result
    is the same); without, it runs every round and reads nothing back."""
    l = int(l)
    w = max(l - 1, 1)
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    p = p & MASK32

    def one_round(i):
        i = i ^ p
        i = _mul32(i, 0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = _mul32(i, 0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * (1 | (p >> 27))) & MASK32
        i = _mul32(i, 0x6935FA69)
        i = i ^ ((i & w) >> 3)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0xC860A3DF)
        i = i & w
        i = i ^ (i >> 5)
        return i

    out = one_round(i)
    if w + 1 != l:
        for r in range(rounds - 1):
            if early_stop and r % 4 == 0 and not bool((out >= l).any()):
                break
            out = torch.where(out >= l, one_round(out), out)
        out = torch.where(out >= l, i % l, out)
    return ((out + p) & MASK32) % l


class MultijitterSampler(StratifiedSampler):
    """Correlated multi-jittered sampler (Kensler 2013): the reference's
    `multijitter` plugin. 2-D pairs take the CMJ pattern over an m x n
    grid (m * n = spp, m the largest divisor <= sqrt(spp)); odd single
    draws fall back to the stratified stream."""

    def _grid(self):
        m = max(1, int(np.sqrt(self.spp)))
        while self.spp % m:
            m -= 1
        return m, self.spp // m

    def _pair_key(self, pair_offset):
        pair_dim = as_u32((self.base_dim >> 1) + pair_offset, self.lane)
        return hash_combine(hash_combine(self._seed(0xC3A5C85C), self._pixel()), pair_dim)

    def _cmj(self, pair_offset):
        m, n = self._grid()
        key = self._pair_key(pair_offset)
        # shuffle the sample order per (pixel, pair) so pairs decorrelate
        s = self._permute(self.sample_index, self.spp, key ^ 0x51633E2D)
        sx = self._permute(s % m, m, key ^ 0x68BC21EB)
        sy = self._permute(s // m, n, key ^ 0x02E5BE93)
        jx = _uniform_from_bits(hash_combine(key ^ 0x967A889B, s))
        jy = _uniform_from_bits(hash_combine(key ^ 0x368CC8B7, s))
        x = _div((s % m).to(torch.float32) + _div(sy.to(torch.float32) + jx, n), m)
        y = _div((s // m).to(torch.float32) + _div(sx.to(torch.float32) + jy, m), n)
        return torch.stack([x, y], -1)

    def next_2d(self):
        if self.dim % 2 == 0 and self.spp > 1:
            pair = self._cmj(self.dim // 2)
            self.dim += 2
            return pair
        return Sampler.next_2d(self)


class OrthogonalSampler(StratifiedSampler):
    """Orthogonal-array sampler (Bose OA of strength 2): the reference's
    `orthogonal` plugin. Needs spp = p^2 with p prime; any other spp
    falls back to the stratified stream."""

    def _p(self):
        p = int(round(np.sqrt(self.spp)))
        if p * p != self.spp:
            return 0
        for q in range(2, p):
            if p % q == 0:
                return 0
        return p

    def _draw(self, dim):
        p = self._p()
        if p == 0:
            return StratifiedSampler._draw(self, dim)
        d = self._dim_value(dim)
        pixel = self._pixel()
        key = hash_combine(hash_combine(self._seed(0x8C98C8EF), pixel), d)
        # the sample-order shuffle is per pixel, shared by every dimension
        pix_key = hash_combine(self._seed(0x19AD25CB), pixel)
        s = self._permute(self.sample_index, self.spp, pix_key)
        a = s // p
        b = s % p
        stratum = ((a + d * b) & MASK32) % p
        stratum = self._permute(stratum, p, key ^ 0x66D13D09)
        sub = self._permute(b, p, key ^ hash_combine(key, stratum))
        jitter = _uniform_from_bits(hash_combine(key ^ 0x4E7A4A33, s))
        return _div(stratum.to(torch.float32)
                    + _div(sub.to(torch.float32) + jitter, p), p)


SAMPLERS = {
    "independent": IndependentSampler,
    "stratified": StratifiedSampler,
    "sobol": SobolSampler,
    "ldsampler": SobolSampler,  # the reference's name for its low-discrepancy sampler
    "multijitter": MultijitterSampler,
    "orthogonal": OrthogonalSampler,
}


def make_sampler(name, seed, pixel, sample_index, spp):
    """Instantiate a sampler by reference plugin name; pixel, sample_index:
    int64 tensors."""
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler '{name}' (available: {sorted(SAMPLERS)})")
    cls = SAMPLERS[name]
    if cls is IndependentSampler:
        return IndependentSampler(seed, (pixel * spp + sample_index) & MASK32)
    return cls.from_pixel(seed, pixel, sample_index, spp)
