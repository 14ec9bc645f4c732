"""Phase functions: isotropic, Henyey-Greenstein, Rayleigh and SGGX
specular microflakes.

PyTorch port of mitsuba_customization_tpu/models/phase.py (mitsuba3
src/phase/). Each phase function is a plain function over lane batches;
`eval` and `sample` dispatch on a per-lane type id from the medium table
(render/medium.py). Directions point away from the interaction: `wi`
toward where the ray came from, `wo` the new direction. Every phase
function here is a normalised density over the sphere, so pdf == eval and
the sample weight is 1.
"""

from __future__ import annotations

import math

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core import warp

ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
SGGX = 3  # specular microflakes (Heitz et al. 2015; mitsuba3 sggx.cpp)

INV_FOURPI = 1.0 / (4.0 * math.pi)


def iso_eval(wi, wo):
    return torch.full(wo.shape[:-1], INV_FOURPI, device=wo.device)


def iso_sample(wi, sample2):
    wo = warp.square_to_uniform_sphere(sample2)
    return wo, torch.full(wo.shape[:-1], INV_FOURPI, device=wo.device)


def hg_eval(g, wi, wo):
    """HG density at cos_theta = -dot(wi, wo): with g > 0 the lobe peaks
    where wo continues the propagation direction (wo = -wi)."""
    cos_t = -m.dot(wi, wo)
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_t
    return INV_FOURPI * (1.0 - g2) / torch.clamp(denom * m.safe_sqrt(denom), min=1e-12)


def _around(fwd, cos_theta, phi):
    """The unit direction at (cos_theta, phi) about the axis fwd."""
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    s, t = m.coordinate_system(fwd)
    wo = ((sin_theta * torch.cos(phi))[..., None] * s
          + (sin_theta * torch.sin(phi))[..., None] * t
          + cos_theta[..., None] * fwd)
    return m.normalize(wo)


def hg_sample(g, wi, sample2):
    """Exact HG inverse-CDF sampling about the propagation direction -wi."""
    u1, u2 = sample2[..., 0], sample2[..., 1]
    small = g.abs() < 1e-4
    g_safe = torch.where(small, 1e-4, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cos_theta = torch.where(small, 1.0 - 2.0 * u1,  # the isotropic limit
                            (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe))
    wo = _around(-wi, torch.clamp(cos_theta, -1.0, 1.0), 2.0 * math.pi * u2)
    return wo, hg_eval(g, wi, wo)


def rayleigh_eval(wi, wo):
    """(3 / 16 pi)(1 + cos^2 theta)."""
    cos_t = m.dot(wi, wo)
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_t * cos_t)


def rayleigh_sample(wi, sample2):
    """Exact inversion through the depressed cubic's closed form (mitsuba3
    rayleigh.cpp). z + sqrt(z^2 + 1) > 0, so its cube root is a power."""
    u1, u2 = sample2[..., 0], sample2[..., 1]
    z = 2.0 * (2.0 * u1 - 1.0)
    tmp = torch.pow(z + torch.sqrt(z * z + 1.0), 1.0 / 3.0)
    cos_theta = torch.clamp(tmp - 1.0 / tmp, -1.0, 1.0)
    wo = _around(-wi, cos_theta, 2.0 * math.pi * u2)
    return wo, rayleigh_eval(wi, wo)


# SGGX: a symmetric PSD 3x3 matrix S packed as (..., 6) = [xx, yy, zz, xy,
# xz, yz]; f_p(wi -> wo) = D(h) / (4 sigma(wi)) with h = normalize(wi +
# wo), scale-invariant in S and normalised, so eval == pdf.


def _sggx_sigma(S, w):
    """Projected flake area sigma(w) = sqrt(w^T S w)."""
    xx, yy, zz, xy, xz, yz = S.unbind(-1)
    x, y, z = w.unbind(-1)
    q = (x * x * xx + y * y * yy + z * z * zz
         + 2.0 * (x * y * xy + x * z * xz + y * z * yz))
    return m.safe_sqrt(q)


def _sggx_det(S):
    xx, yy, zz, xy, xz, yz = S.unbind(-1)
    return (xx * (yy * zz - yz * yz) - xy * (xy * zz - yz * xz)
            + xz * (xy * yz - yy * xz))


def _sggx_ndf(S, h):
    """D(h) = 1 / (pi sqrt(|S|) (h^T S^-1 h)^2), S^-1 by its adjugate."""
    xx, yy, zz, xy, xz, yz = S.unbind(-1)
    det = torch.clamp(_sggx_det(S), min=1e-20)
    a_xx = yy * zz - yz * yz
    a_yy = xx * zz - xz * xz
    a_zz = xx * yy - xy * xy
    a_xy = xz * yz - xy * zz
    a_xz = xy * yz - xz * yy
    a_yz = xy * xz - xx * yz
    x, y, z = h.unbind(-1)
    q = (x * x * a_xx + y * y * a_yy + z * z * a_zz
         + 2.0 * (x * y * a_xy + x * z * a_xz + y * z * a_yz)) / det
    q = torch.clamp(q, min=1e-12)
    return 1.0 / (math.pi * torch.sqrt(det) * q * q)


def sggx_eval(S, wi, wo):
    h = m.normalize(wi + wo)
    # wi == -wo: h degenerates; the guards keep the density finite
    sig = torch.clamp(_sggx_sigma(S, wi), min=1e-12)
    return _sggx_ndf(S, h) / (4.0 * sig)


def sggx_sample(S, wi, sample2):
    """Visible-normal sampling (the paper's listing 4), then the mirror
    reflection of wi about the sampled flake normal."""
    wk, wj = m.coordinate_system(wi)
    xx, yy, zz, xy, xz, yz = S.unbind(-1)

    def quad(a, b):
        ax, ay, az = a.unbind(-1)
        bx, by, bz = b.unbind(-1)
        return (ax * bx * xx + ay * by * yy + az * bz * zz + (ax * by + ay * bx) * xy
                + (ax * bz + az * bx) * xz + (ay * bz + az * by) * yz)

    s_kk = torch.clamp(quad(wk, wk), min=1e-12)
    s_jj = torch.clamp(quad(wj, wj), min=1e-12)
    s_ii = torch.clamp(quad(wi, wi), min=1e-12)
    s_kj = quad(wk, wj)
    s_ki = quad(wk, wi)
    s_ji = quad(wj, wi)

    det = torch.clamp(_sggx_det(S), min=1e-20)
    # the listing's basis; the JAX package has S_kk / S_kj where S_ii /
    # S_ji belong, which biases its samples (ROADMAP's reference faults)
    tmp = m.safe_sqrt(torch.clamp(s_jj * s_ii - s_ji * s_ji, min=1e-20))
    inv_sqrt_sii = 1.0 / torch.sqrt(s_ii)
    zero = torch.zeros_like(tmp)
    mk = torch.stack([torch.sqrt(det) / tmp, zero, zero], -1)
    mj = torch.stack([-inv_sqrt_sii * (s_ki * s_ji - s_kj * s_ii) / tmp,
                      inv_sqrt_sii * tmp, zero], -1)
    mi = torch.stack([inv_sqrt_sii * s_ki, inv_sqrt_sii * s_ji, inv_sqrt_sii * s_ii], -1)

    r = m.safe_sqrt(sample2[..., 0])
    phi = 2.0 * math.pi * sample2[..., 1]
    pu = r * torch.cos(phi)
    pv = r * torch.sin(phi)
    pw = m.safe_sqrt(1.0 - pu * pu - pv * pv)
    m_local = m.normalize(pu[..., None] * mk + pv[..., None] * mj + pw[..., None] * mi)
    normal = m.normalize(m_local[..., 0:1] * wk + m_local[..., 1:2] * wj
                         + m_local[..., 2:3] * wi)
    wo = m.normalize(2.0 * m.dot(normal, wi)[..., None] * normal - wi)
    return wo, sggx_eval(S, wi, wo)


def eval(phase_type, g, wi, wo, S=None):
    """Per-lane phase density (== pdf). S: (..., 6) SGGX matrices, or None
    where the scene has no SGGX phase."""
    out = iso_eval(wi, wo)
    out = torch.where(phase_type == HG, hg_eval(g, wi, wo), out)
    out = torch.where(phase_type == RAYLEIGH, rayleigh_eval(wi, wo), out)
    if S is not None:
        out = torch.where(phase_type == SGGX, sggx_eval(S, wi, wo), out)
    return out


def sample(phase_type, g, wi, sample2, S=None):
    """Per-lane phase sampling -> (wo, pdf); the weight is 1."""
    wo_i, pdf_i = iso_sample(wi, sample2)
    wo_h, pdf_h = hg_sample(g, wi, sample2)
    wo_r, pdf_r = rayleigh_sample(wi, sample2)
    is_hg, is_ray = phase_type == HG, phase_type == RAYLEIGH
    wo = torch.where(is_hg[..., None], wo_h, torch.where(is_ray[..., None], wo_r, wo_i))
    pdf = torch.where(is_hg, pdf_h, torch.where(is_ray, pdf_r, pdf_i))
    if S is not None:
        wo_s, pdf_s = sggx_sample(S, wi, sample2)
        is_s = phase_type == SGGX
        wo = torch.where(is_s[..., None], wo_s, wo)
        pdf = torch.where(is_s, pdf_s, pdf)
    return wo, pdf
