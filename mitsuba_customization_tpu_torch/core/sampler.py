"""Per-lane stateless sampler (counter-based hash RNG).

PyTorch port of the `independent` sampler of
mitsuba_customization_tpu/core/sampler.py. Every random number is a pure
hash of (seed, lane, dimension), so at a fixed seed the port draws the
same uniforms as the JAX package, bit for bit, and needs no
`torch.Generator`. The dimension is a Python-int base (set per bounce by
`with_dim`) plus a Python offset advanced by `next_1d` / `next_2d`.
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core.qmc import as_u32, hash_combine


def _uniform_from_bits(bits):
    """uint32 (in int64) -> float32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


class Sampler:
    """Deterministic per-(lane, dim) sample streams.

    seed: uint32 Python int; lane: int64 tensor of lane ids
    (pixel * spp + sample index); base_dim: Python int; dim: Python offset
    within the base.
    """

    def __init__(self, seed, lane, dim=0, base_dim=0, _lane_key=None):
        self.seed = int(seed) & 0xFFFFFFFF
        self.lane = lane
        self.dim = dim
        self.base_dim = int(base_dim)
        # hash_combine(seed, lane) is shared by every draw of the lane
        self._lane_key = (
            _lane_key if _lane_key is not None
            else hash_combine(as_u32(self.seed, lane), lane)
        )

    def clone(self):
        return type(self)(self.seed, self.lane, self.dim, self.base_dim,
                          self._lane_key)

    def with_dim(self, base_dim):
        """Sampler repositioned at a dimension base, offset 0."""
        return type(self)(self.seed, self.lane, 0, base_dim, self._lane_key)

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
    """Counter-based uniform sampler: the reference's `independent` plugin."""

    def _draw(self, dim):
        d = as_u32(self.base_dim + dim, self.lane)
        return _uniform_from_bits(hash_combine(self._lane_key, d))


SAMPLERS = {"independent": IndependentSampler}


def make_sampler(name, seed, pixel, sample_index, spp):
    """Instantiate a sampler by reference plugin name.

    pixel, sample_index: int64 tensors. Only `independent` is ported.
    """
    if name not in SAMPLERS:
        raise NotImplementedError(f"sampler '{name}' is not ported")
    lane = (pixel * spp + sample_index) & 0xFFFFFFFF
    return IndependentSampler(seed, lane)
