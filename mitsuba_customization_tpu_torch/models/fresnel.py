"""Fresnel reflectance: dielectric (with the refraction data), conductor,
and Schlick's approximation.

PyTorch port of mitsuba_customization_tpu/models/fresnel.py.
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core.math import safe_sqrt


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel for a dielectric boundary, eta = n_t / n_i > 0;
    cos_theta_i < 0 means the ray arrives from inside. Returns (F,
    cos_theta_t, eta_it, eta_ti); cos_theta_t has the opposite sign of
    cos_theta_i, and is 0 under total internal reflection (F = 1)."""
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)

    cti = cos_theta_i.abs()
    sin2_t = eta_ti * eta_ti * torch.clamp(1.0 - cti * cti, min=0.0)
    tir = sin2_t >= 1.0
    ctt = safe_sqrt(1.0 - sin2_t)

    a_s = (cti - eta_it * ctt) / torch.clamp(cti + eta_it * ctt, min=1e-12)
    a_p = (eta_it * cti - ctt) / torch.clamp(eta_it * cti + ctt, min=1e-12)
    f = 0.5 * (a_s * a_s + a_p * a_p)
    f = torch.where(tir, 1.0, f)
    cos_theta_t = torch.where(tir, 0.0, -torch.sign(cos_theta_i) * ctt)
    return f, cos_theta_t, eta_it, eta_ti


def fresnel_schlick(cos_theta_i, f0):
    """Schlick's approximation, f0 (..., 3)."""
    m = torch.clamp(1.0 - cos_theta_i.abs(), 0.0, 1.0)[..., None]
    return f0 + (1.0 - f0) * (m ** 5)


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized Fresnel for a conductor with complex IOR eta - i*k;
    eta and k broadcast against cos_theta_i[..., None] (RGB channels)."""
    c = torch.clamp(cos_theta_i.abs(), min=1e-6)[..., None]
    c2 = c * c
    s2 = 1.0 - c2

    e2 = eta * eta
    k2 = k * k

    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)

    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)
