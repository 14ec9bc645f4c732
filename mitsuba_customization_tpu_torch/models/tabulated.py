"""Tabulated measured BRDF (MERL grid): trilinear eval and luminance-weighted
importance sampling.

PyTorch port of mitsuba_customization_tpu/models/tabulated.py:
`TabulatedBRDF.build` / `build_stack`, `_build_sampling`, `_grid_coords`,
`eval_raw`, `eval_f`, the standalone `eval` / `pdf` / `sample` and the
fused per-bounce `bounce_shade`. Storage is
over (theta_h, theta_d, phi_d) with the sqrt warp on theta_h; phi_d wraps
with period pi. Sampling draws a half vector from a per-incident-angle
Marginal2D built from the table's luminance, mixed with a cosine lobe.

eval_f runs kernel K1 (ops/merl_sorted) and bounce_shade runs kernel K2
(ops/marginal_sorted) once, then K1 once over the two halves wo_nee and
wo_sampled: the plain route of models/bsdf.bounce_shade. On its fused
route (CUDA lanes) bsdf_shade_pre (ops/bsdf_shade) computes what
bounce_shade does before K2, and bounce_shade_fused runs K2,
bsdf_shade_post (what it does between K2 and K1), K1 over both halves and
f = f2 * scale, the one attached step. The standalone eval and sample
call K1 with one half; pdf and sample invert the Marginal2D CDFs in plain
torch, as the JAX package does outside its fused bounce. A table that
requires grad enters autograd once, through its GradSink: the K1 calls of
a render, standalone ones too, all add their backward into one gradient
buffer.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.distr import (
    Marginal2D,
    _invert_cdf,
    _select_at,
)
from mitsuba_customization_tpu_torch.core.rusinkiewicz import dirs_to_half_diff
from mitsuba_customization_tpu_torch.core.spectrum import luminance
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu_torch.ops import bsdf_shade, marginal_sorted, merl_sorted

HALF_PI = math.pi / 2.0

# Probability of the defensive cosine lobe in the sampling mixture.
COSINE_MIX = 0.1

# Sampler resolution: incident-angle slices and the (theta_h, phi_h) grid.
N_THETA_I = 32
SAMPLE_RES_H = 32
SAMPLE_RES_PHI = 64


class TabulatedBRDF(NamedTuple):
    """A measured BRDF table plus its sampling distributions.

    table:    (n_th, n_td, n_pd, 3) float32, or stacked (n_mat, ...).
    sampling: Marginal2D with leading axes ([n_mat,] N_THETA_I): one
              half-vector distribution per incident-angle bin.
    sink:     where the table requires grad, its merl_sorted.GradSink:
              every K1 call's backward adds into one table gradient.
    """

    table: torch.Tensor
    sampling: Marginal2D
    sink: Optional[merl_sorted.GradSink] = None

    @staticmethod
    def build(table):
        """From one (n_th, n_td, n_pd, 3) table; builds the sampling CDFs."""
        return TabulatedBRDF(table=table, sampling=_build_sampling(table),
                             sink=merl_sorted.grad_sink(table))

    @staticmethod
    def build_stack(tables):
        """From a stacked (n_mat, n_th, n_td, n_pd, 3) tensor."""
        per = [_build_sampling(t) for t in tables]
        sampling = Marginal2D(*(torch.stack(f) for f in zip(*per)))
        return TabulatedBRDF(table=tables, sampling=sampling,
                             sink=merl_sorted.grad_sink(tables))


# --------------------------------------------------------------------------
# Index math + trilinear interpolation
# --------------------------------------------------------------------------


def _grid_coords(table_shape, theta_h, theta_d, phi_d):
    """Continuous cell-centred grid coordinates for the three axes."""
    n_th, n_td, n_pd = table_shape[-4], table_shape[-3], table_shape[-2]
    return merl_sorted.grid_coords(n_th, n_td, n_pd, theta_h, theta_d, phi_d)


def _trilinear_gather(table, u_th, u_td, u_pd, slot=None):
    """Trilinear interpolation over (theta_h, theta_d, phi_d): theta axes
    clamp at the borders, phi_d wraps."""
    n_th, n_td, n_pd = table.shape[-4], table.shape[-3], table.shape[-2]
    i0 = torch.floor(u_th).long()
    j0 = torch.floor(u_td).long()
    k0 = torch.floor(u_pd).long()
    fth = u_th - i0
    ftd = u_td - j0
    fpd = u_pd - k0
    i0c, i1c = i0.clamp(0, n_th - 1), (i0 + 1).clamp(0, n_th - 1)
    j0c, j1c = j0.clamp(0, n_td - 1), (j0 + 1).clamp(0, n_td - 1)
    k0c, k1c = k0 % n_pd, (k0 + 1) % n_pd

    def corner(ii, jj, kk):
        if slot is None:
            return table[ii, jj, kk]
        return table[slot, ii, jj, kk]

    wth1, wth0 = fth[..., None], (1.0 - fth)[..., None]
    wtd1, wtd0 = ftd[..., None], (1.0 - ftd)[..., None]
    wpd1, wpd0 = fpd[..., None], (1.0 - fpd)[..., None]
    c00 = corner(i0c, j0c, k0c) * wpd0 + corner(i0c, j0c, k1c) * wpd1
    c01 = corner(i0c, j1c, k0c) * wpd0 + corner(i0c, j1c, k1c) * wpd1
    c10 = corner(i1c, j0c, k0c) * wpd0 + corner(i1c, j0c, k1c) * wpd1
    c11 = corner(i1c, j1c, k0c) * wpd0 + corner(i1c, j1c, k1c) * wpd1
    c0 = c00 * wtd0 + c01 * wtd1
    c1 = c10 * wtd0 + c11 * wtd1
    return c0 * wth0 + c1 * wth1


def eval_raw(table, wi, wo, slot=None):
    """Interpolated f(wi, wo) (no cosine), zero below the horizon. The
    reference formula; the sampling build uses it."""
    theta_h, _, theta_d, phi_d = dirs_to_half_diff(wi, wo)
    u_th, u_td, u_pd = _grid_coords(table.shape[-4:], theta_h, theta_d, phi_d)
    val = _trilinear_gather(table, u_th, u_td, u_pd, slot=slot)
    above = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return torch.where(above[..., None], torch.clamp(val, min=0.0), 0.0)


def _normalize_slot(params, slot):
    """A slot only selects from a stacked build; drop it otherwise."""
    return slot if params.table.dim() == 5 else None


def eval_f(params: TabulatedBRDF, wi, wo, slot=None, mask=None, coherent=False, *,
           wo_b=None, mask_b=None):
    """Interpolated f(wi, wo) (no cosine) through kernel K1; with wo_b,
    also f(wi, wo_b) on the same slots, as rows N..2N-1. `coherent` takes
    the JAX package's place and changes nothing there either (it skips
    that kernel's sort, which K1 does not have)."""
    return merl_sorted.eval_trilinear(
        params.table, wi, wo, _normalize_slot(params, slot), mask, wo_b, mask_b,
        sink=params.sink,
    )


def eval(params: TabulatedBRDF, wi, wo, slot=None, mask=None):
    """f(wi, wo) cos(theta_o): K1 with one half, then the cosine."""
    return eval_f(params, wi, wo, slot=slot, mask=mask) * torch.clamp(
        m.cos_theta(wo), min=0.0)[..., None]


# --------------------------------------------------------------------------
# Luminance-weighted importance sampling (half-vector square, per wi bin):
#   y in [0,1): theta_h = (pi/2) y^2;  x in [0,1): phi_h = 2 pi x - pi
#   d(omega_h) = 2 pi^2 y sin(theta_h) dy dx;  d(omega_o) = 4 |wo.h| d(omega_h)
# --------------------------------------------------------------------------


def _halfvec_from_square(y, x):
    """Unit-square coords -> (half vector in the canonical frame, |J|)."""
    theta_h = HALF_PI * y * y
    phi_h = 2.0 * math.pi * x - math.pi
    h = m.sph_to_dir(theta_h, phi_h)
    jac = 2.0 * math.pi * math.pi * y * torch.sin(theta_h)
    return h, jac


def _square_from_halfvec(h):
    """Half vector (canonical frame) -> unit-square coords (y, x)."""
    theta_h, phi_h = m.dir_to_sph(h)
    y = m.safe_sqrt(theta_h / HALF_PI)
    x = (phi_h + math.pi) / (2.0 * math.pi)
    return y, torch.clamp(x, 0.0, 1.0 - 1e-7)


def _build_sampling(table):
    """Per-incident-angle-bin Marginal2D stack from one 4-D table. The
    sampling quantities are detached (the JAX package's stop_gradient on
    the table), so the CDFs carry no autograd graph."""
    table = table.detach()
    dev = table.device
    ti = (torch.arange(N_THETA_I, dtype=torch.float32, device=dev) + 0.5) \
        / N_THETA_I * HALF_PI
    yy = (torch.arange(SAMPLE_RES_H, dtype=torch.float32, device=dev) + 0.5) \
        / SAMPLE_RES_H
    xx = (torch.arange(SAMPLE_RES_PHI, dtype=torch.float32, device=dev) + 0.5) \
        / SAMPLE_RES_PHI
    ti_g, y_g, x_g = torch.meshgrid(ti, yy, xx, indexing="ij")
    wi = m.sph_to_dir(ti_g, torch.zeros_like(ti_g))  # canonical phi_i = 0
    h, jac_h = _halfvec_from_square(y_g, x_g)
    wo = 2.0 * m.dot_keep(wi, h) * h - wi
    lum = luminance(eval_raw(table, wi, wo))
    weight = lum * jac_h * 4.0 * m.dot(wo, h).abs()
    weight = torch.where(m.cos_theta(wo) > 0.0, weight, 0.0)
    return Marginal2D.build(weight)


def _slice_index(theta_i):
    return torch.clamp(
        (theta_i / HALF_PI * N_THETA_I).long(), 0, N_THETA_I - 1
    )


def _rotate_phi(v, phi):
    c, s = torch.cos(phi), torch.sin(phi)
    return torch.stack(
        [c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1], v[..., 2]],
        -1,
    )


def _table_pdf_canonical(sampling, theta_i, wo_c, wi_c, slot=None, mask=None):
    """The tabulated half-vector density of wo (canonical frame), in solid
    angle at wo."""
    h = m.normalize(wi_c + wo_c)
    y, x = _square_from_halfvec(h)
    tbin = _slice_index(theta_i)
    if mask is not None:
        tbin = torch.where(mask, tbin, 0)
    slc = (tbin,) if slot is None else (slot, tbin)
    p_sq = sampling.eval_pdf(torch.stack([y, x], -1), slice_=slc)
    theta_h = HALF_PI * y * y
    jac_h = 2.0 * math.pi * math.pi * y * torch.sin(theta_h)
    return m.safe_div(p_sq, jac_h * 4.0 * m.dot(wo_c, h).abs())


def pdf(params: TabulatedBRDF, wi, wo, slot=None, mask=None):
    """The density of `sample` in solid angle at wo; the slot of a masked
    lane is clamped to 0."""
    slot = _normalize_slot(params, slot)
    if mask is not None and slot is not None:
        slot = torch.where(mask, slot.long(), 0)
    theta_i, phi_i = m.dir_to_sph(wi)
    wo_c = _rotate_phi(wo, -phi_i)
    wi_c = m.sph_to_dir(theta_i, torch.zeros_like(theta_i))
    p_tab = _table_pdf_canonical(params.sampling, theta_i, wo_c, wi_c, slot, mask)
    p = (1.0 - COSINE_MIX) * p_tab + COSINE_MIX * square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return torch.where(valid, p, 0.0)


def sample(params: TabulatedBRDF, wi, sample2, sample1=None, slot=None, mask=None):
    """Luminance-weighted half-vector sampling mixed with a cosine lobe.
    sample1 picks the component (sample2[..., 0] split at COSINE_MIX when
    absent). K1 evaluates one half, on the lanes of `mask` whose sample is
    valid. Returns (wo, pdf, weight = f cos / pdf, sampled_delta)."""
    slot = _normalize_slot(params, slot)
    theta_i, phi_i = m.dir_to_sph(wi)
    wi_c = m.sph_to_dir(theta_i, torch.zeros_like(theta_i))
    if sample1 is None:
        u0 = sample2[..., 0]
        use_cos = u0 < COSINE_MIX
        u0r = torch.where(
            use_cos, u0 / COSINE_MIX, (u0 - COSINE_MIX) / (1.0 - COSINE_MIX)
        )
        sample2 = torch.stack(
            [torch.clamp(u0r, 0.0, 1.0 - 1e-7), sample2[..., 1]], -1
        )
    else:
        use_cos = sample1 < COSINE_MIX

    if mask is not None and slot is not None:
        slot = torch.where(mask, slot.long(), 0)
    tbin = _slice_index(theta_i)
    if mask is not None:
        tbin = torch.where(mask, tbin, 0)
    slc = (tbin,) if slot is None else (slot, tbin)
    pos, p_sq = params.sampling.sample(sample2, slice_=slc)
    h, jac_h = _halfvec_from_square(pos[..., 0], pos[..., 1])
    wo_tab = 2.0 * m.dot_keep(wi_c, h) * h - wi_c
    wo_cos = square_to_cosine_hemisphere(sample2)
    wo_c = torch.where(use_cos[..., None], wo_cos, wo_tab)
    wo = _rotate_phi(wo_c, phi_i)

    p_tab_own = m.safe_div(p_sq, jac_h * 4.0 * m.dot(wo_tab, h).abs())
    p_tab_cos = _table_pdf_canonical(params.sampling, theta_i, wo_cos, wi_c, slot, mask)
    p_tab = torch.where(use_cos, p_tab_cos, p_tab_own)
    p = (1.0 - COSINE_MIX) * p_tab + COSINE_MIX * square_to_cosine_hemisphere_pdf(wo_c)
    valid = (p > 1e-12) & (m.cos_theta(wo_c) > 0.0) & (m.cos_theta(wi) > 0.0)
    mask_eval = valid if mask is None else mask & valid
    weight = m.safe_div(eval(params, wi, wo, slot=slot, mask=mask_eval), p[..., None])
    weight = torch.where(valid[..., None], weight, 0.0)
    return wo, torch.where(valid, p, 0.0), weight, torch.zeros_like(valid)


def _row_mass_at(rows, r):
    """Marginal-CDF cell mass at per-lane row r from (lanes, H) rows."""
    hi = _select_at(rows, r)
    lo = torch.where(r > 0, _select_at(rows, (r - 1).clamp(min=0)), 0.0)
    return hi - lo


def _square_cells(wi_c, wo_c):
    """Canonical direction pair -> (y, x, r, c, denom); denom = jac_h *
    4 |wo.h| converts the square density to solid angle at wo."""
    h = m.normalize(wi_c + wo_c)
    y, x = _square_from_halfvec(h)
    r = torch.clamp((y * SAMPLE_RES_H).long(), 0, SAMPLE_RES_H - 1)
    c = torch.clamp((x * SAMPLE_RES_PHI).long(), 0, SAMPLE_RES_PHI - 1)
    theta_h = HALF_PI * y * y
    jac_h = 2.0 * math.pi * math.pi * y * torch.sin(theta_h)
    denom = jac_h * 4.0 * m.dot(wo_c, h).abs()
    return y, x, r, c, denom


def bounce_shade(params: TabulatedBRDF, wi, wo_nee, sample2, sample1=None,
                 slot=None, mask=None, mask_nee=None):
    """All tabulated-BRDF work of one path-tracer bounce.

    One K2 pass (conditional-CDF inversion for the luminance sample plus
    the cell masses of the NEE and cosine-branch pdfs), the marginal-row
    work as plain indexing, and ONE K1 pass over the halves wo_nee and
    wo_sampled.
    Returns (f_nee, pdf_nee, wo, pdf_s, weight, is_delta); f_nee and
    weight include the cosine term. Only f_nee and weight carry the
    table's gradient (through K1); the sampled direction and the pdfs come
    from detached CDFs.
    """
    slot = _normalize_slot(params, slot)
    n = wi.shape[0]
    cos_wi_ok = m.cos_theta(wi) > 0.0
    any_mask = cos_wi_ok
    if mask is not None and mask_nee is not None:
        any_mask = any_mask & (mask | mask_nee)
    elif mask is not None:
        any_mask = any_mask & mask

    theta_i, phi_i = m.dir_to_sph(wi)
    wi_c = m.sph_to_dir(theta_i, torch.zeros_like(theta_i))
    tbin = torch.where(any_mask, _slice_index(theta_i), 0)
    slot_safe = None if slot is None else torch.where(any_mask, slot.long(), 0)

    # ---- mixture branch selection ----
    if sample1 is None:
        u0 = sample2[..., 0]
        use_cos = u0 < COSINE_MIX
        u0r = torch.where(
            use_cos, u0 / COSINE_MIX, (u0 - COSINE_MIX) / (1.0 - COSINE_MIX)
        )
        sample2 = torch.stack(
            [torch.clamp(u0r, 0.0, 1.0 - 1e-7), sample2[..., 1]], -1
        )
    else:
        use_cos = sample1 < COSINE_MIX
    u_row, u_col = sample2[..., 0], sample2[..., 1]

    # ---- marginal-row work ----
    cdf_row = params.sampling.cdf_row
    cdf_rows = cdf_row[tbin] if slot_safe is None else cdf_row[slot_safe, tbin]
    r_own, row_lo, row_mass_own = _invert_cdf(cdf_rows, u_row)
    dy = torch.clamp(
        (u_row - row_lo) / torch.clamp(row_mass_own, min=1e-20), 0.0, 1.0 - 1e-7
    )

    # NEE / cosine-branch half-vector cells (canonical frame)
    wo_nee_c = _rotate_phi(wo_nee, -phi_i)
    nee_ok = m.cos_theta(wo_nee) > 0.0
    if mask_nee is not None:
        nee_ok = nee_ok & mask_nee
    wo_nee_c = torch.where(nee_ok[..., None], wo_nee_c, wi_c)  # NaN-free
    _, _, r_nee, c_nee, denom_nee = _square_cells(wi_c, wo_nee_c)
    wo_cos = square_to_cosine_hemisphere(sample2)
    _, _, r_cos, c_cos, denom_cos = _square_cells(wi_c, wo_cos)

    # ---- K2: conditional-CDF work ----
    flat_key = tbin if slot_safe is None else slot_safe * N_THETA_I + tbin
    cdf_cond = params.sampling.cdf_cond
    x, mass_own, mass_nee, mass_cos = marginal_sorted.cond_sample_pdf(
        cdf_cond.reshape(-1, cdf_cond.shape[-2], cdf_cond.shape[-1]),
        flat_key, u_col, r_own, r_nee, c_nee, r_cos, c_cos, any_mask,
    )
    hw = SAMPLE_RES_H * SAMPLE_RES_PHI

    # ---- the sampled direction + its pdf ----
    y = (r_own.to(torch.float32) + dy) / SAMPLE_RES_H
    h, jac_h = _halfvec_from_square(y, x)
    wo_tab = 2.0 * m.dot_keep(wi_c, h) * h - wi_c
    denom_own = jac_h * 4.0 * m.dot(wo_tab, h).abs()
    p_tab_own = m.safe_div(row_mass_own * mass_own * hw, denom_own)
    row_mass_cos = _row_mass_at(cdf_rows, r_cos)
    p_tab_cos = m.safe_div(row_mass_cos * mass_cos * hw, denom_cos)

    wo_c = torch.where(use_cos[..., None], wo_cos, wo_tab)
    wo = _rotate_phi(wo_c, phi_i)
    p_tab = torch.where(use_cos, p_tab_cos, p_tab_own)
    p_cos = square_to_cosine_hemisphere_pdf(wo_c)
    pdf_s = (1.0 - COSINE_MIX) * p_tab + COSINE_MIX * p_cos
    valid_s = (pdf_s > 1e-12) & (m.cos_theta(wo_c) > 0.0) & cos_wi_ok
    valid_s_m = valid_s if mask is None else valid_s & mask

    # ---- NEE pdf (MIS) ----
    row_mass_nee = _row_mass_at(cdf_rows, r_nee)
    p_tab_nee = m.safe_div(row_mass_nee * mass_nee * hw, denom_nee)
    p_cos_nee = square_to_cosine_hemisphere_pdf(wo_nee_c)
    pdf_nee = (1.0 - COSINE_MIX) * p_tab_nee + COSINE_MIX * p_cos_nee
    pdf_nee = torch.where(nee_ok & cos_wi_ok, pdf_nee, 0.0)

    # ---- K1: one trilinear eval over the halves wo_nee and wo_sampled ----
    f2 = eval_f(params, wi, wo_nee, slot_safe, nee_ok & cos_wi_ok,
                wo_b=wo, mask_b=valid_s_m)
    f_nee = f2[:n] * torch.clamp(m.cos_theta(wo_nee), min=0.0)[..., None]
    f_s = f2[n:] * torch.clamp(m.cos_theta(wo), min=0.0)[..., None]

    weight = m.safe_div(f_s, pdf_s[..., None])
    weight = torch.where(valid_s[..., None], weight, 0.0)
    return (
        f_nee,
        pdf_nee,
        wo,
        torch.where(valid_s, pdf_s, 0.0),
        weight,
        torch.zeros_like(valid_s),
    )


def bounce_shade_fused(params: TabulatedBRDF, pre, wi, wo_nee, sample2, sample1=None):
    """The tabulated lanes of the fused route (models/bsdf._bounce_shade_fused)
    after bsdf_shade_pre (`pre`, ops/bsdf_shade.Pre): K2 on pre's indices,
    bsdf_shade_post, K1 over the halves wo_nee and wo_sampled on pre's
    masks, and f = f2 * scale: f_nee = f2[:n] max(cos wo_nee, 0) and the
    weight f2[n:] max(cos wo, 0) / pdf_s, added to pre's f_nee and weight
    (0 on these lanes, as the scales are 0 on the others). Returns (f_nee,
    weight); pre's wo, pdf_s and pdf_nee hold the lanes' values after the
    call. As in bounce_shade, only f_nee and the weight carry the table's
    gradient, through K1."""
    key, r_own, r_nee, c_nee, r_cos, c_cos, slot = pre.idx
    cdf_cond = params.sampling.cdf_cond
    k2 = marginal_sorted.cond_sample_pdf(
        cdf_cond.reshape(-1, cdf_cond.shape[-2], cdf_cond.shape[-1]),
        key, sample2[..., 1], r_own, r_nee, c_nee, r_cos, c_cos, pre.valid,
    )
    bsdf_shade.shade_post(pre, k2, sample2, sample1 is None)
    f2 = eval_f(params, wi, wo_nee, slot, pre.masks[0], wo_b=pre.wo, mask_b=pre.masks[1])
    n = wi.shape[0]
    return (torch.addcmul(pre.f_nee, f2[:n], pre.scales[0][:, None]),
            torch.addcmul(pre.weight, f2[n:], pre.scales[1][:, None]))
