"""Rough conductor (GGX or Beckmann microfacet) BSDF.

PyTorch port of mitsuba_customization_tpu/models/roughconductor.py:
f = spec * F(wi.h) D(h) G2 / (4 cos_i cos_o), pdf = p(h) / (4 wo.h) with
p(h) the density of microfacet.sample_micronormal. The distribution is a
static choice (dist_type) that selects the kernel (models/bsdf.py), not a
parameter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models import microfacet as mf
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_conductor


class RoughConductorParams(NamedTuple):
    alpha_u: torch.Tensor  # (...)
    alpha_v: torch.Tensor  # (...)
    eta: torch.Tensor  # (..., 3) real part of the IOR
    k: torch.Tensor  # (..., 3) imaginary part
    specular_reflectance: torch.Tensor  # (..., 3) tint


def _clamped_alpha(params):
    return (
        torch.clamp(params.alpha_u, min=1e-4),
        torch.clamp(params.alpha_v, min=1e-4),
    )


def eval(params: RoughConductorParams, wi, wo, dist_type=mf.GGX):
    """f * cos(theta_o) = D F G / (4 cos_i)."""
    au, av = _clamped_alpha(params)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    active = (ci > 0.0) & (co > 0.0)
    h = m.normalize(wi + wo)
    d = mf.eval_ndf(dist_type, au, av, h)
    g = mf.g2_separable(dist_type, au, av, wi, wo, h)
    f = fresnel_conductor(m.dot(wi, h), params.eta, params.k)
    val = params.specular_reflectance * f * m.safe_div(d * g, 4.0 * ci)[..., None]
    return torch.where(active[..., None], val, 0.0)


def pdf(params: RoughConductorParams, wi, wo, dist_type=mf.GGX):
    au, av = _clamped_alpha(params)
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    h = m.normalize(wi + wo)
    dv = mf.pdf_micronormal(dist_type, au, av, wi, h)
    p = m.safe_div(dv, 4.0 * m.dot(wo, h).abs())
    return torch.where(active, p, 0.0)


def sample(params: RoughConductorParams, wi, sample2, sample1=None,
           dist_type=mf.GGX):
    """Returns (wo, pdf, weight = f*cos/pdf, sampled_delta)."""
    au, av = _clamped_alpha(params)
    h = mf.sample_micronormal(dist_type, au, av, wi, sample2)
    wo = 2.0 * m.dot_keep(wi, h) * h - wi
    p = pdf(params, wi, wo, dist_type)
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    weight = m.safe_div(eval(params, wi, wo, dist_type), p[..., None])
    ok = active & (p > 0.0)
    return (
        wo,
        torch.where(ok, p, 0.0),
        torch.where(ok[..., None], weight, 0.0),
        torch.zeros_like(ok),
    )
