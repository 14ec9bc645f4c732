"""Smooth dielectric (glass): a two-sided delta BSDF that reflects with
probability F and refracts with 1 - F; the transmitted throughput carries
the 1/eta^2 radiance scale.

PyTorch port of mitsuba_customization_tpu/models/dielectric.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_dielectric


class DielectricParams(NamedTuple):
    eta: torch.Tensor  # (...) relative IOR int/ext
    specular_reflectance: torch.Tensor  # (..., 3)
    specular_transmittance: torch.Tensor  # (..., 3)


def eval(params: DielectricParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape), device=wi.device)


def pdf(params: DielectricParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape)[:-1], device=wi.device)


def sample(params: DielectricParams, wi, sample2, sample1=None):
    """Reflect or refract by sample1 (sample2[..., 0] when absent).
    Returns (wo, pdf, weight, sampled_delta = True)."""
    ci = m.cos_theta(wi)
    f, cos_theta_t, _, eta_ti = fresnel_dielectric(ci, params.eta)
    u = sample2[..., 0] if sample1 is None else sample1
    reflect_sel = u <= f
    wo = torch.where(reflect_sel[..., None], m.reflect(wi),
                     m.refract(wi, cos_theta_t, eta_ti))
    w_t = params.specular_transmittance * (eta_ti * eta_ti)[..., None]
    weight = torch.where(reflect_sel[..., None], params.specular_reflectance, w_t)
    p = torch.where(reflect_sel, f, 1.0 - f)
    active = ci.abs() > 0.0
    return (wo, torch.where(active, p, 0.0),
            torch.where(active[..., None], weight, 0.0), torch.ones_like(active))
