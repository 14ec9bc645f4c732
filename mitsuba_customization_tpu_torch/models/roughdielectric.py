"""Rough dielectric (ground glass): microfacet reflection and transmission
(Walter et al. 2007), GGX or Beckmann, two-sided.

PyTorch port of mitsuba_customization_tpu/models/roughdielectric.py. The
transmitted throughput's 1/eta^2 radiance scale cancels the eta^2 of the
half-vector Jacobian, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models import microfacet as mf
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_dielectric


class RoughDielectricParams(NamedTuple):
    eta: torch.Tensor  # (...) relative IOR int/ext
    alpha: torch.Tensor  # (...)
    specular_reflectance: torch.Tensor  # (..., 3)
    specular_transmittance: torch.Tensor  # (..., 3)


def _alpha(params):
    return torch.clamp(params.alpha, min=1e-4)


def _halfvec(params, wi, wo):
    """The micronormal of the pair (wi, wo), reflection or refraction,
    flipped to the upper hemisphere: h ~ wi + wo (reflection), wi + eta_it
    wo (transmission)."""
    ci = m.cos_theta(wi)
    is_reflect = ci * m.cos_theta(wo) > 0.0
    eta_it = fresnel_dielectric(ci, params.eta)[2]
    scale = torch.where(is_reflect, 1.0, eta_it)
    h = m.normalize(wi + wo * scale[..., None])
    return m.mulsign(h, m.cos_theta(h)[..., None]), is_reflect, eta_it


def eval(params: RoughDielectricParams, wi, wo, dist_type=mf.GGX):
    """f(wi, wo) |cos theta_o|, both lobes."""
    a = _alpha(params)
    ci = m.cos_theta(wi)
    h, is_reflect, eta_it = _halfvec(params, wi, wo)
    d = mf.eval_ndf(dist_type, a, a, h)
    g = mf.g2_separable(dist_type, a, a, m.mulsign(wi, ci[..., None]),
                        m.mulsign(wo, ci[..., None]), h)
    f = fresnel_dielectric(m.dot(wi, h), params.eta)[0]

    val_r = params.specular_reflectance * m.safe_div(
        f * d * g, 4.0 * ci.abs())[..., None]
    wih = m.dot(wi, h)
    woh = m.dot(wo, h)
    denom = wih + eta_it * woh
    val_t = params.specular_transmittance * m.safe_div(
        wih * woh, ci * denom * denom).abs()[..., None] * ((1.0 - f) * d * g)[..., None]

    # Walter's sidedness: wi and wo each on their side of the microfacet
    sided = (wih * ci > 0.0) & (woh * m.cos_theta(wo) > 0.0)
    active_r = is_reflect & (d > 0.0) & sided
    active_t = ~is_reflect & (d > 0.0) & sided
    out = torch.where(active_r[..., None], val_r, 0.0)
    return out + torch.where(active_t[..., None], val_t, 0.0)


def pdf(params: RoughDielectricParams, wi, wo, dist_type=mf.GGX):
    a = _alpha(params)
    ci = m.cos_theta(wi)
    h, is_reflect, eta_it = _halfvec(params, wi, wo)
    h_pdf = mf.pdf_micronormal(dist_type, a, a, m.mulsign(wi, ci[..., None]), h)
    f = fresnel_dielectric(m.dot(wi, h), params.eta)[0]
    wih = m.dot(wi, h)
    woh = m.dot(wo, h)
    jac_r = m.safe_div(1.0, 4.0 * woh.abs())
    denom = wih + eta_it * woh
    jac_t = m.safe_div(eta_it * eta_it * woh.abs(), denom * denom)
    p = torch.where(is_reflect, f * jac_r, (1.0 - f) * jac_t) * h_pdf
    co = m.cos_theta(wo)
    sided = (wih * ci > 0.0) & (woh * co > 0.0)
    ok = (ci.abs() > 0.0) & (co.abs() > 0.0) & sided
    return torch.where(ok, p, 0.0)


def sample(params: RoughDielectricParams, wi, sample2, sample1=None,
           dist_type=mf.GGX):
    """Returns (wo, pdf, weight, sampled_delta = False). A sample whose
    direction lands on the other side than its lobe (grazing or near
    total internal reflection, in float32) is dropped: its classified
    density is not the one it was drawn from."""
    a = _alpha(params)
    ci = m.cos_theta(wi)
    h = mf.sample_micronormal(dist_type, a, a, m.mulsign(wi, ci[..., None]), sample2)
    f, cos_theta_t, _, eta_ti = fresnel_dielectric(m.dot(wi, h), params.eta)
    if sample1 is None:
        # a decorrelated (deterministic) lobe choice: reusing sample2
        # would bias the micronormal warp
        sample1 = torch.sin(sample2[..., 0] * 1e4 + sample2[..., 1]).abs()
    pick_reflect = sample1 < f
    wo_r = 2.0 * m.dot_keep(wi, h) * h - wi
    wo_t = (h * (m.dot(wi, h) * eta_ti + cos_theta_t)[..., None]
            - wi * eta_ti[..., None])
    wo = torch.where(pick_reflect[..., None], wo_r, m.normalize(wo_t))

    p = pdf(params, wi, wo, dist_type)
    weight = m.safe_div(eval(params, wi, wo, dist_type), p[..., None])
    consistent = pick_reflect == (m.cos_theta(wo) * ci > 0.0)
    ok = (p > 1e-12) & consistent
    return (wo, torch.where(ok, p, 0.0), torch.where(ok[..., None], weight, 0.0),
            torch.zeros_like(ok))
