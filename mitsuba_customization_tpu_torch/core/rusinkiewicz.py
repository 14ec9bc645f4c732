"""Rusinkiewicz half/difference-angle parameterization for measured BRDFs.

PyTorch port of mitsuba_customization_tpu/core/rusinkiewicz.py
(`dirs_to_half_diff`, `dirs_to_half_diff_fast`, `half_diff_to_dirs`,
`half_dir_to_diff`). Directions are (..., 3) unit vectors in the local
shading frame (+z = normal).
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core.math import dir_to_sph, dot_keep, normalize, sph_to_dir


def _rotate_z(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1], v[..., 2]],
        -1,
    )


def _rotate_y(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [c * v[..., 0] + s * v[..., 2], v[..., 1], -s * v[..., 0] + c * v[..., 2]],
        -1,
    )


def dirs_to_half_diff(wi, wo):
    """(wi, wo) -> (theta_h, phi_h, theta_d, phi_d)."""
    h = normalize(wi + wo)
    theta_h, phi_h = dir_to_sph(h)
    d = _rotate_y(_rotate_z(wi, -phi_h), -theta_h)
    theta_d, phi_d = dir_to_sph(d)
    return theta_h, phi_h, theta_d, phi_d


def half_diff_to_dirs(theta_h, phi_h, theta_d, phi_d):
    """(theta_h, phi_h, theta_d, phi_d) -> (wi, wo), the inverse of
    dirs_to_half_diff: wi = Rz(phi_h) Ry(theta_h) sph(theta_d, phi_d), wo
    its reflection about the half vector."""
    wi = _rotate_z(_rotate_y(sph_to_dir(theta_d, phi_d), theta_h), phi_h)
    h = sph_to_dir(theta_h, phi_h)
    return wi, 2.0 * dot_keep(wi, h) * h - wi


def half_dir_to_diff(h, wi):
    """(theta_d, phi_d) of wi about the half vector h."""
    theta_h, phi_h = dir_to_sph(h)
    return dir_to_sph(_rotate_y(_rotate_z(wi, -phi_h), -theta_h))


def dirs_to_half_diff_fast(wi, wo):
    """(wi, wo) -> (theta_h, theta_d, phi_d) with 3 transcendentals.

    The same rotations as dirs_to_half_diff, with their cos/sin taken from
    the half vector's components. phi_h is not returned (isotropic tables).
    """
    h = normalize(wi + wo)
    hz = torch.clamp(h[..., 2], -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - hz * hz, min=0.0))
    safe = st > 1e-12
    inv_st = torch.where(safe, 1.0 / torch.clamp(st, min=1e-12), 0.0)
    cphi = torch.where(safe, h[..., 0] * inv_st, 1.0)
    sphi = torch.where(safe, h[..., 1] * inv_st, 0.0)

    # v = Rz(-phi_h) wi ; d = Ry(-theta_h) v   (cos=hz, sin=st)
    vx = cphi * wi[..., 0] + sphi * wi[..., 1]
    vy = -sphi * wi[..., 0] + cphi * wi[..., 1]
    vz = wi[..., 2]
    dx = hz * vx - st * vz
    dz = st * vx + hz * vz

    theta_h = torch.arccos(hz)
    theta_d = torch.arccos(torch.clamp(dz, -1.0, 1.0))
    phi_d = torch.atan2(vy, dx)
    return theta_h, theta_d, phi_d
