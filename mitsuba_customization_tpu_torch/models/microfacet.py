"""GGX microfacet distribution: NDF, Smith shadowing, visible-normal
sampling.

PyTorch port of the GGX half of mitsuba_customization_tpu/models/
microfacet.py (Beckmann is not ported). Anisotropic (alpha_u, alpha_v).
"""

from __future__ import annotations

import math

import torch

from mitsuba_customization_tpu_torch.core import math as m

GGX = 0


def eval_ndf(alpha_u, alpha_v, h):
    """GGX NDF D(h); h in the shading frame, upper hemisphere."""
    t = (h[..., 0] / alpha_u) ** 2 + (h[..., 1] / alpha_v) ** 2 + h[..., 2] ** 2
    d = m.safe_div(1.0, math.pi * alpha_u * alpha_v * t * t)
    return torch.where(m.cos_theta(h) > 0.0, d, 0.0)


def _lambda_smith(alpha_u, alpha_v, v):
    """Smith masking auxiliary Lambda(v) for GGX (Heitz 2014)."""
    vz = m.cos_theta(v)
    a2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
    t = m.safe_div(a2, vz * vz)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + t))


def smith_g1(alpha_u, alpha_v, v, h):
    """Monodirectional Smith shadowing G1(v, h)."""
    g = 1.0 / (1.0 + _lambda_smith(alpha_u, alpha_v, v))
    back = m.dot(v, h) * m.cos_theta(v) <= 0.0
    return torch.where(back, 0.0, g)


def g2_separable(alpha_u, alpha_v, wi, wo, h):
    """Separable Smith G2 = G1(wi) * G1(wo)."""
    return smith_g1(alpha_u, alpha_v, wi, h) * smith_g1(alpha_u, alpha_v, wo, h)


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
        torch.tensor([1.0, 0.0, 0.0], device=vh.device),
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


def pdf_visible(alpha_u, alpha_v, wi, h):
    """VNDF density in d(omega_h): G1(wi) max(0, wi.h) D(h) / cos(theta_i)."""
    d = eval_ndf(alpha_u, alpha_v, h)
    g1 = smith_g1(alpha_u, alpha_v, wi, h)
    return m.safe_div(
        g1 * torch.clamp(m.dot(wi, h), min=0.0) * d, m.cos_theta(wi).abs()
    )
