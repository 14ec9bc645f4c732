"""Sampling warps: [0,1)^2 -> disk / hemisphere / sphere, with pdfs.

PyTorch port of mitsuba_customization_tpu/core/warp.py's disk, hemisphere,
sphere, cone and triangle warps, the Box-Muller normal and the tent.
"""

from __future__ import annotations

import math

import torch

from mitsuba_customization_tpu_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_TWO_PI = 0.5 / math.pi
INV_FOUR_PI = 0.25 / math.pi


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


def square_to_uniform_disk_concentric_pdf(p):
    return torch.full(p.shape[:-1], INV_PI, device=p.device)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere via concentric disk + projection."""
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_hemisphere(sample):
    """Uniform hemisphere (z >= 0)."""
    return _around_z(sample[..., 0], sample[..., 1])


def square_to_uniform_hemisphere_pdf(d):
    return torch.where(d[..., 2] >= 0.0, INV_TWO_PI, 0.0)


def square_to_uniform_sphere(sample):
    """Uniform sphere."""
    return _around_z(1.0 - 2.0 * sample[..., 0], sample[..., 1])


def square_to_uniform_sphere_pdf(d):
    return torch.full(d.shape[:-1], INV_FOUR_PI, device=d.device)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in the cone cos(theta) >= cos_cutoff around +z."""
    return _around_z(1.0 - sample[..., 0] * (1.0 - cos_cutoff), sample[..., 1])


def square_to_uniform_cone_pdf(d, cos_cutoff):
    return torch.where(d[..., 2] >= cos_cutoff, INV_TWO_PI / (1.0 - cos_cutoff), 0.0)


def _around_z(z, u_phi):
    """The unit vector at height z and azimuth 2 pi u_phi."""
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u_phi
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_triangle(sample):
    """Uniform barycentrics (b1, b2) on the unit triangle (sqrt mapping)."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], -1)


def square_to_std_normal(sample):
    """Box-Muller: (..., 2) -> a 2-D standard normal sample."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - sample[..., 0], min=1e-38)))
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def interval_to_tent(sample):
    """[0, 1) -> the tent distribution on (-1, 1)."""
    return torch.where(
        sample >= 0.5,
        1.0 - safe_sqrt(torch.clamp(2.0 - 2.0 * sample, min=0.0)),
        safe_sqrt(torch.clamp(2.0 * sample, min=0.0)) - 1.0,
    )
