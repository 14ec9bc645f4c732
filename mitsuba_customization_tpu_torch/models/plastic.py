"""Smooth plastic: a dielectric coating (delta lobe) over a diffuse base.

PyTorch port of mitsuba_customization_tpu/models/plastic.py: specular
reflection with probability F(cos_i), else diffuse scattering with the
(1 - F_i)(1 - F_o) transmission factors and the internal-scattering
compensation 1 / (1 - rho F_dr(1/eta)). The lobe is chosen per sample, so
`sampled_delta` is per lane.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_dielectric

INV_PI = 1.0 / math.pi


class PlasticParams(NamedTuple):
    diffuse_reflectance: torch.Tensor  # (..., 3)
    specular_reflectance: torch.Tensor  # (..., 3)
    eta: torch.Tensor  # (...) relative IOR int/ext


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance under diffuse illumination (polynomial
    fit)."""
    return torch.where(
        eta >= 1.0,
        -1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta,
        -0.4399 + 0.7099 / eta - 0.3319 / (eta * eta)
        + 0.0636 / (eta * eta * eta),
    )


def diffuse_lobe(params, wi, wo, f_i, f_o):
    """The coated diffuse base's f * cos_o, given F at wi and at wo."""
    fdr = fresnel_diffuse_reflectance(1.0 / params.eta)
    rho = params.diffuse_reflectance
    inv_eta2 = 1.0 / (params.eta * params.eta)
    return (
        rho
        * (INV_PI * inv_eta2 * (1.0 - f_i) * (1.0 - f_o))[..., None]
        / (1.0 - rho * fdr[..., None])
        * torch.clamp(m.cos_theta(wo), min=0.0)[..., None]
    )


def _spec_prob(params, wi):
    return fresnel_dielectric(m.cos_theta(wi), params.eta)[0]


def _diffuse_part(params, wi, wo):
    f_i = fresnel_dielectric(m.cos_theta(wi), params.eta)[0]
    f_o = fresnel_dielectric(m.cos_theta(wo), params.eta)[0]
    val = diffuse_lobe(params, wi, wo, f_i, f_o)
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return torch.where(active[..., None], val, 0.0)


def eval(params: PlasticParams, wi, wo):
    """The non-delta part of f * cos_o."""
    return _diffuse_part(params, wi, wo)


def pdf(params: PlasticParams, wi, wo):
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    p = (1.0 - _spec_prob(params, wi)) * square_to_cosine_hemisphere_pdf(wo)
    return torch.where(active, p, 0.0)


def sample(params: PlasticParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight, sampled_delta per lane)."""
    ps = _spec_prob(params, wi)
    if sample1 is None:
        # the lobe choice reuses sample2.x, rescaled back to U[0, 1)
        sample1 = sample2[..., 0]
        pick_spec = sample1 < ps
        u0 = torch.where(pick_spec, m.safe_div(sample1, ps),
                         m.safe_div(sample1 - ps, 1.0 - ps))
        sample2 = torch.stack([torch.clamp(u0, 0.0, 1.0 - 1e-7), sample2[..., 1]], -1)
    else:
        pick_spec = sample1 < ps
    wo = torch.where(pick_spec[..., None], m.reflect(wi),
                     square_to_cosine_hemisphere(sample2))
    active = m.cos_theta(wi) > 0.0
    p_diff = (1.0 - ps) * square_to_cosine_hemisphere_pdf(wo)
    w_diff = m.safe_div(_diffuse_part(params, wi, wo), p_diff[..., None])
    weight = torch.where(pick_spec[..., None], params.specular_reflectance, w_diff)
    p_out = torch.where(pick_spec, ps, p_diff)
    ok = active & (p_out > 0.0)
    return (wo, torch.where(ok, p_out, 0.0), torch.where(ok[..., None], weight, 0.0),
            pick_spec)
