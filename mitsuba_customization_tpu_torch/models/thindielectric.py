"""Thin dielectric slab: a delta BSDF whose internal bounces sum into the
reflectance R' = 2R / (1 + R); transmission passes straight through.

PyTorch port of mitsuba_customization_tpu/models/thindielectric.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_dielectric


class ThinDielectricParams(NamedTuple):
    eta: torch.Tensor  # (...) relative IOR int/ext
    specular_reflectance: torch.Tensor  # (..., 3)
    specular_transmittance: torch.Tensor  # (..., 3)


def _r_total(params, wi):
    r = fresnel_dielectric(m.cos_theta(wi).abs(), params.eta)[0]
    return r * 2.0 / (1.0 + r)


def eval(params: ThinDielectricParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape), device=wi.device)


def pdf(params: ThinDielectricParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape)[:-1], device=wi.device)


def sample(params: ThinDielectricParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight, sampled_delta = True)."""
    r = _r_total(params, wi)
    u = sample2[..., 0] if sample1 is None else sample1
    pick_reflect = u < r
    wo = torch.where(pick_reflect[..., None], m.reflect(wi), -wi)
    weight = torch.where(pick_reflect[..., None], params.specular_reflectance,
                         params.specular_transmittance)
    p = torch.where(pick_reflect, r, 1.0 - r)
    active = m.cos_theta(wi).abs() > 0.0
    return (wo, torch.where(active, p, 0.0),
            torch.where(active[..., None], weight, 0.0), torch.ones_like(active))
