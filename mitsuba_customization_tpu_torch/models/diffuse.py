"""Smooth diffuse (Lambertian) BSDF.

PyTorch port of mitsuba_customization_tpu/models/diffuse.py.
params: reflectance (..., 3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.warp import (
    INV_PI,
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)


class DiffuseParams(NamedTuple):
    reflectance: torch.Tensor  # (..., 3)


def eval(params: DiffuseParams, wi, wo):
    """f * cos(theta_o) = albedo/pi * cos(theta_o), one-sided."""
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    val = params.reflectance * (
        INV_PI * torch.clamp(m.cos_theta(wo), min=0.0)
    )[..., None]
    return torch.where(active[..., None], val, 0.0)


def pdf(params: DiffuseParams, wi, wo):
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return torch.where(active, square_to_cosine_hemisphere_pdf(wo), 0.0)


def sample(params: DiffuseParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight, sampled_delta)."""
    wo = square_to_cosine_hemisphere(sample2)
    p = pdf(params, wi, wo)
    active = m.cos_theta(wi) > 0.0
    weight = torch.where(active[..., None], params.reflectance, 0.0)
    return wo, p, weight, torch.zeros_like(active)
