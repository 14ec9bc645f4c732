"""Principled BSDF (Disney 2012/2015), opaque lobes.

PyTorch port of mitsuba_customization_tpu/models/principled.py: the base
diffuse with the retro-reflection term and the flatness mix, sheen, the
anisotropic GGX specular lobe with the principled Fresnel, and the GTR1
clearcoat (Smith alpha 0.25, F0 0.04). Sampling is a three-way mixture
(cosine diffuse, GGX visible normals, GTR1) with luminance-derived lobe
probabilities; the pdf is the exact mixture.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.spectrum import luminance
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu_torch.models import microfacet as mf

INV_PI = 1.0 / math.pi


class PrincipledParams(NamedTuple):
    base_color: torch.Tensor  # (..., 3)
    roughness: torch.Tensor  # (...)
    anisotropic: torch.Tensor  # (...)
    metallic: torch.Tensor  # (...)
    spec_tint: torch.Tensor  # (...)
    specular: torch.Tensor  # (...) dielectric F0 scale (0.5 -> F0 = 0.04)
    sheen: torch.Tensor  # (...)
    sheen_tint: torch.Tensor  # (...)
    clearcoat: torch.Tensor  # (...)
    clearcoat_gloss: torch.Tensor  # (...)
    flatness: torch.Tensor  # (...)


def _schlick_weight(cos):
    x = torch.clamp(1.0 - cos, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def _alphas(params):
    aspect = torch.sqrt(1.0 - 0.9 * torch.clamp(params.anisotropic, 0.0, 1.0))
    r2 = params.roughness * params.roughness
    return torch.clamp(r2 / aspect, min=1e-4), torch.clamp(r2 * aspect, min=1e-4)


def _tint(base_color):
    lum = luminance(base_color)
    return torch.where(lum[..., None] > 0.0,
                       base_color / torch.clamp(lum, min=1e-7)[..., None],
                       torch.ones_like(base_color))


def _cspec0(params):
    """Specular F0 color: lerp(0.08 specular tint_mix, base_color, metallic)."""
    tint_mix = ((1.0 - params.spec_tint)[..., None]
                + params.spec_tint[..., None] * _tint(params.base_color))
    f0_diel = (0.08 * params.specular)[..., None] * tint_mix
    return ((1.0 - params.metallic)[..., None] * f0_diel
            + params.metallic[..., None] * params.base_color)


def _gtr1_ndf(alpha, h):
    a2 = alpha * alpha
    c2 = m.cos_theta(h) ** 2
    denom = math.pi * torch.log(torch.clamp(a2, min=1e-7)) * (1.0 + (a2 - 1.0) * c2)
    return m.safe_div(a2 - 1.0, denom)


def _cc_alpha(params):
    return (1.0 - params.clearcoat_gloss) * 0.1 + params.clearcoat_gloss * 0.001


def _lobe_probs(params, wi):
    """(p_diff, p_spec, p_cc): the sampling mixture from lobe luminances."""
    w_spec = luminance(_cspec0(params)) + 0.1
    w_diff = (1.0 - params.metallic) * torch.clamp(luminance(params.base_color), min=1e-3)
    w_cc = 0.25 * params.clearcoat
    total = w_spec + w_diff + w_cc
    return w_diff / total, w_spec / total, w_cc / total


def eval(params: PrincipledParams, wi, wo):
    """f(wi, wo) cos(theta_o), the reflective lobes."""
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    active = (ci > 0.0) & (co > 0.0)
    h = m.normalize(wi + wo)
    cos_d = m.dot(wo, h).abs()

    fw_i, fw_o = _schlick_weight(ci), _schlick_weight(co)
    fd90 = 0.5 + 2.0 * params.roughness * cos_d * cos_d
    fd = (1.0 + (fd90 - 1.0) * fw_i) * (1.0 + (fd90 - 1.0) * fw_o)
    fss90 = params.roughness * cos_d * cos_d
    fss = (1.0 + (fss90 - 1.0) * fw_i) * (1.0 + (fss90 - 1.0) * fw_o)
    ss = 1.25 * (fss * (m.safe_div(1.0, ci + co) - 0.5) + 0.5)
    base_diff = (1.0 - params.flatness) * fd + params.flatness * ss
    diffuse = params.base_color * (INV_PI * base_diff * (1.0 - params.metallic))[..., None]

    c_sheen = ((1.0 - params.sheen_tint)[..., None]
               + params.sheen_tint[..., None] * _tint(params.base_color))
    sheen = c_sheen * (params.sheen * (1.0 - params.metallic)
                       * _schlick_weight(cos_d))[..., None]

    ax, ay = _alphas(params)
    d = mf.eval_ndf(mf.GGX, ax, ay, h)
    g = mf.g2_separable(mf.GGX, ax, ay, wi, wo, h)
    cspec0 = _cspec0(params)
    f = cspec0 + (1.0 - cspec0) * _schlick_weight(cos_d)[..., None]
    spec = f * m.safe_div(d * g, 4.0 * ci)[..., None]

    dc = _gtr1_ndf(_cc_alpha(params), h)
    fc = 0.04 + 0.96 * _schlick_weight(cos_d)
    gc = mf.g2_separable(mf.GGX, 0.25, 0.25, wi, wo, h)
    cc = (0.25 * params.clearcoat) * m.safe_div(dc * fc * gc, 4.0 * ci)

    out = (diffuse + sheen) * torch.clamp(co, min=0.0)[..., None] + spec + cc[..., None]
    return torch.where(active[..., None], out, 0.0)


def pdf(params: PrincipledParams, wi, wo):
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    h = m.normalize(wi + wo)
    jac = m.safe_div(1.0, 4.0 * m.dot(wo, h).abs())
    ax, ay = _alphas(params)
    p_diff_w, p_spec_w, p_cc_w = _lobe_probs(params, wi)
    p_spec = mf.pdf_micronormal(mf.GGX, ax, ay, wi, h) * jac
    p_cc = (_gtr1_ndf(_cc_alpha(params), h) * m.cos_theta(h)).abs() * jac
    p = (p_diff_w * square_to_cosine_hemisphere_pdf(wo) + p_spec_w * p_spec
         + p_cc_w * p_cc)
    return torch.where(active, p, 0.0)


def _sample_gtr1(alpha, sample2):
    a2 = torch.clamp(alpha * alpha, min=1e-7)
    u0 = torch.clamp(sample2[..., 0], 0.0, 1.0 - 1e-7)
    c2 = m.safe_div(1.0 - torch.pow(a2, 1.0 - u0), 1.0 - a2)
    cos_t = m.safe_sqrt(torch.clamp(c2, 0.0, 1.0))
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * sample2[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)


def sample(params: PrincipledParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight = f*cos/pdf, sampled_delta = False)."""
    p_diff_w, p_spec_w, _ = _lobe_probs(params, wi)
    t1 = p_diff_w
    t2 = p_diff_w + p_spec_w
    if sample1 is None:
        sample1 = sample2[..., 0]
        pick_diff = sample1 < t1
        pick_spec = (sample1 >= t1) & (sample1 < t2)
        u0 = torch.where(
            pick_diff, m.safe_div(sample1, t1),
            torch.where(pick_spec, m.safe_div(sample1 - t1, t2 - t1),
                        m.safe_div(sample1 - t2, 1.0 - t2)),
        )
        sample2 = torch.stack([torch.clamp(u0, 0.0, 1.0 - 1e-7), sample2[..., 1]], -1)
    else:
        pick_diff = sample1 < t1
        pick_spec = (sample1 >= t1) & (sample1 < t2)
    ax, ay = _alphas(params)
    h_spec = mf.sample_micronormal(mf.GGX, ax, ay, wi, sample2)
    h_cc = _sample_gtr1(_cc_alpha(params), sample2)
    h = torch.where(pick_spec[..., None], h_spec, h_cc)
    wo = torch.where(pick_diff[..., None], square_to_cosine_hemisphere(sample2),
                     2.0 * m.dot_keep(wi, h) * h - wi)
    p = pdf(params, wi, wo)
    weight = m.safe_div(eval(params, wi, wo), p[..., None])
    ok = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0) & (p > 1e-12)
    return (wo, torch.where(ok, p, 0.0), torch.where(ok[..., None], weight, 0.0),
            torch.zeros_like(ok))
