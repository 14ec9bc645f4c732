"""Fresnel reflectance of a conductor.

PyTorch port of `fresnel_conductor` from
mitsuba_customization_tpu/models/fresnel.py.
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core.math import safe_sqrt


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
