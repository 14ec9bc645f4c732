"""Microfacet distributions, GGX and Beckmann: NDF, Smith shadowing,
micronormal sampling and its density.

PyTorch port of mitsuba_customization_tpu/models/microfacet.py. The
distribution is the first argument (GGX or BECKMANN), a Python int.
Anisotropic (alpha_u, alpha_v); Beckmann sampling is isotropic (alpha_u),
from the full NDF: its density is D(h) cos(theta_h). GGX samples visible
normals (Heitz 2018).
"""

from __future__ import annotations

import math

import torch

from mitsuba_customization_tpu_torch.core import math as m

GGX = 0
BECKMANN = 1


def eval_ndf(dist_type, alpha_u, alpha_v, h):
    """NDF D(h); h in the shading frame, upper hemisphere."""
    cz = m.cos_theta(h)
    if dist_type == GGX:
        t = (h[..., 0] / alpha_u) ** 2 + (h[..., 1] / alpha_v) ** 2 + h[..., 2] ** 2
        d = m.safe_div(1.0, math.pi * alpha_u * alpha_v * t * t)
    else:
        c2 = cz * cz
        st2 = m.sin_theta2(h)
        t2 = m.safe_div(st2, c2)
        cphi2 = torch.where(st2 > 0, (h[..., 0] ** 2) / torch.clamp(st2, min=1e-12), 1.0)
        sphi2 = 1.0 - cphi2
        d = m.safe_div(
            torch.exp(-t2 * (cphi2 / alpha_u ** 2 + sphi2 / alpha_v ** 2)),
            math.pi * alpha_u * alpha_v * c2 * c2,
        )
    return torch.where(cz > 0.0, d, 0.0)


def _lambda_smith(dist_type, alpha_u, alpha_v, v):
    """Smith masking auxiliary Lambda(v) (Heitz 2014); Beckmann by the
    rational approximation of its error-function form."""
    vz = m.cos_theta(v)
    if dist_type == GGX:
        a2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
        t = m.safe_div(a2, vz * vz)
        return 0.5 * (-1.0 + torch.sqrt(1.0 + t))
    xy2 = v[..., 0] ** 2 + v[..., 1] ** 2
    alpha2 = torch.where(
        xy2 > 0,
        ((alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2)
        / torch.clamp(xy2, min=1e-12),
        alpha_u * alpha_u,
    )
    tan_theta = m.safe_div(torch.sqrt(xy2), vz.abs())
    a = m.safe_div(1.0, torch.sqrt(alpha2) * tan_theta, default=1e8)
    return torch.where(
        a < 1.6,
        m.safe_div(1.0 - 1.259 * a + 0.396 * a * a, 3.535 * a + 2.181 * a * a),
        0.0,
    )


def smith_g1(dist_type, alpha_u, alpha_v, v, h):
    """Monodirectional Smith shadowing G1(v, h)."""
    g = 1.0 / (1.0 + _lambda_smith(dist_type, alpha_u, alpha_v, v))
    back = m.dot(v, h) * m.cos_theta(v) <= 0.0
    return torch.where(back, 0.0, g)


def g2_separable(dist_type, alpha_u, alpha_v, wi, wo, h):
    """Separable Smith G2 = G1(wi) * G1(wo)."""
    return (smith_g1(dist_type, alpha_u, alpha_v, wi, h)
            * smith_g1(dist_type, alpha_u, alpha_v, wo, h))


def sample_micronormal(dist_type, alpha_u, alpha_v, wi, sample2):
    """A micronormal h: GGX visible normals, Beckmann from the full NDF
    (theta_h = atan sqrt(-a^2 ln(1 - u)))."""
    if dist_type == BECKMANN:
        a2 = alpha_u * alpha_u
        t2 = -a2 * torch.log(torch.clamp(1.0 - sample2[..., 0], min=1e-12))
        cos_t = 1.0 / torch.sqrt(1.0 + t2)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * math.pi * sample2[..., 1]
        return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    return sample_vndf(alpha_u, alpha_v, wi, sample2)


def pdf_micronormal(dist_type, alpha_u, alpha_v, wi, h):
    """Density of sample_micronormal in d(omega_h)."""
    if dist_type == BECKMANN:
        return eval_ndf(dist_type, alpha_u, alpha_v, h) * torch.clamp(
            m.cos_theta(h), min=0.0)
    return pdf_visible(dist_type, alpha_u, alpha_v, wi, h)


def sample_vndf(alpha_u, alpha_v, wi, sample2):
    """Heitz 2018 GGX visible-normal sampling."""
    vh = m.normalize(
        torch.stack([alpha_u * wi[..., 0], alpha_v * wi[..., 1], wi[..., 2]], -1)
    )
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = m.safe_rsqrt(lensq)
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack(
            [-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
             torch.zeros_like(inv_len)], -1,
        ),
        torch.eye(3, dtype=torch.float32, device=vh.device)[0],  # made on the device
    )
    t2 = m.cross(vh, t1)
    r = torch.sqrt(sample2[..., 0])
    phi = 2.0 * math.pi * sample2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh
    )
    return m.normalize(
        torch.stack(
            [alpha_u * nh[..., 0], alpha_v * nh[..., 1],
             torch.clamp(nh[..., 2], min=1e-6)], -1,
        )
    )


def pdf_visible(dist_type, alpha_u, alpha_v, wi, h):
    """VNDF density in d(omega_h): G1(wi) max(0, wi.h) D(h) / cos(theta_i)."""
    d = eval_ndf(dist_type, alpha_u, alpha_v, h)
    g1 = smith_g1(dist_type, alpha_u, alpha_v, wi, h)
    return m.safe_div(
        g1 * torch.clamp(m.dot(wi, h), min=0.0) * d, m.cos_theta(wi).abs()
    )
