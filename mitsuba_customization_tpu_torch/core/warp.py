"""Sampling warps: [0,1)^2 -> disk / hemisphere / sphere, with pdfs.

PyTorch port of the warps of mitsuba_customization_tpu/core/warp.py that
the flagship path uses.
"""

from __future__ import annotations

import math

import torch

from mitsuba_customization_tpu_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu concentric disk mapping: (..., 2) -> (..., 2)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = x.abs() > y.abs()
    r = torch.where(quadrant_x, x, y)
    ratio = torch.where(
        quadrant_x,
        torch.where(x != 0.0, y / torch.where(x == 0.0, 1.0, x), 0.0),
        torch.where(y != 0.0, x / torch.where(y == 0.0, 1.0, y), 0.0),
    )
    phi = torch.where(
        quadrant_x,
        (math.pi / 4.0) * ratio,
        (math.pi / 2.0) - (math.pi / 4.0) * ratio,
    )
    r = torch.where(is_zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere via concentric disk + projection."""
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_sphere(sample):
    """Uniform sphere."""
    z = 1.0 - 2.0 * sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
