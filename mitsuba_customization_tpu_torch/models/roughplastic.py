"""Rough plastic: a microfacet dielectric coat over a diffuse base, with
plastic's internal-scattering compensation; all lobes smooth.

PyTorch port of mitsuba_customization_tpu/models/roughplastic.py.
Sampling mixes micronormal coat sampling (probability F(cos_i) clamped to
[0.15, 0.9]) with cosine diffuse sampling; the pdf is the exact mixture.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu_torch.models import microfacet as mf
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_dielectric
from mitsuba_customization_tpu_torch.models.plastic import diffuse_lobe


class RoughPlasticParams(NamedTuple):
    diffuse_reflectance: torch.Tensor  # (..., 3)
    specular_reflectance: torch.Tensor  # (..., 3)
    eta: torch.Tensor  # (...)
    alpha: torch.Tensor  # (...)


def _alpha(params):
    return torch.clamp(params.alpha, min=1e-4)


def _spec_prob(params, wi):
    return torch.clamp(fresnel_dielectric(m.cos_theta(wi), params.eta)[0], 0.15, 0.9)


def eval(params: RoughPlasticParams, wi, wo, dist_type=mf.GGX):
    a = _alpha(params)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    active = (ci > 0.0) & (co > 0.0)
    h = m.normalize(wi + wo)
    d = mf.eval_ndf(dist_type, a, a, h)
    g = mf.g2_separable(dist_type, a, a, wi, wo, h)
    f_h = fresnel_dielectric(m.dot(wi, h), params.eta)[0]
    spec = params.specular_reflectance * (f_h * m.safe_div(d * g, 4.0 * ci))[..., None]
    f_i = fresnel_dielectric(ci, params.eta)[0]
    f_o = fresnel_dielectric(co, params.eta)[0]
    diff = diffuse_lobe(params, wi, wo, f_i, f_o)
    return torch.where(active[..., None], spec + diff, 0.0)


def pdf(params: RoughPlasticParams, wi, wo, dist_type=mf.GGX):
    a = _alpha(params)
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    ps = _spec_prob(params, wi)
    h = m.normalize(wi + wo)
    dv = mf.pdf_micronormal(dist_type, a, a, wi, h)
    p_spec = m.safe_div(dv, 4.0 * m.dot(wo, h).abs())
    p = ps * p_spec + (1.0 - ps) * square_to_cosine_hemisphere_pdf(wo)
    return torch.where(active, p, 0.0)


def sample(params: RoughPlasticParams, wi, sample2, sample1=None,
           dist_type=mf.GGX):
    """Returns (wo, pdf, weight, sampled_delta = False)."""
    a = _alpha(params)
    ps = _spec_prob(params, wi)
    if sample1 is None:
        sample1 = sample2[..., 0]
        pick_spec = sample1 < ps
        u0 = torch.where(pick_spec, m.safe_div(sample1, ps),
                         m.safe_div(sample1 - ps, 1.0 - ps))
        sample2 = torch.stack([torch.clamp(u0, 0.0, 1.0 - 1e-7), sample2[..., 1]], -1)
    else:
        pick_spec = sample1 < ps
    h = mf.sample_micronormal(dist_type, a, a, wi, sample2)
    wo = torch.where(pick_spec[..., None], 2.0 * m.dot_keep(wi, h) * h - wi,
                     square_to_cosine_hemisphere(sample2))
    p = pdf(params, wi, wo, dist_type)
    weight = m.safe_div(eval(params, wi, wo, dist_type), p[..., None])
    ok = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0) & (p > 1e-12)
    return (wo, torch.where(ok, p, 0.0), torch.where(ok[..., None], weight, 0.0),
            torch.zeros_like(ok))
