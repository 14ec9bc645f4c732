"""Shading frames: world <-> local transforms around a normal.

PyTorch port of mitsuba_customization_tpu/core/frame.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core.math import coordinate_system, dot


class Frame(NamedTuple):
    """Orthonormal shading frame (s, t, n), all (..., 3)."""

    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v):
        """World direction -> frame-local coordinates."""
        return torch.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)], -1)

    def to_world(self, v):
        """Frame-local direction -> world coordinates."""
        return v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
