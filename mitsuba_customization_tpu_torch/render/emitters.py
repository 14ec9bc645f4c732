"""Emitters: area lights, the constant sky, and scene-level NEE sampling.

PyTorch port of the area and constant branches of
mitsuba_customization_tpu/render/emitters.py: `EmitterTable`,
`_sample_position_on_prim`, `sample_direction`, `eval_hit`,
`pdf_hit_direction`, `pdf_miss_direction` and `eval_background`. The other
emitter types are not ported; the scene loader rejects them.

Area emitters reference emissive primitives of the scene Geometry. All of
them live in one array `em_prims` (Q,); each area emitter owns a pmf row
over it (zero outside its own prims), so prim selection is one CDF
inversion whichever emitter a lane picked. The JAX package's rank trick
(`_q_of_prim`) and its compact `em_geom` copy are TPU gather workarounds;
here a plain `prim_to_q` gather and plain indexing compute the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.distr import DiscreteDistribution
from mitsuba_customization_tpu_torch.core.frame import Frame
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_uniform_sphere,
    square_to_uniform_triangle,
)
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render.records import DirectionSample

AREA = 0
CONSTANT = 1

INV_FOUR_PI = 1.0 / (4.0 * math.pi)


class EmitterTable(NamedTuple):
    """All emitters of a scene (K emitters, Q emissive prims)."""

    em_type: torch.Tensor  # (K,) int64
    select: DiscreteDistribution  # NEE selection over the K emitters
    radiance: torch.Tensor  # (K, 3)
    background_index: int  # constant emitter id, -1 if none
    prim_dist: DiscreteDistribution  # (K, Q) per-emitter pmf over em_prims
    em_prims: torch.Tensor  # (Q,) int64 prim ids (padded with 0)
    prim_area: torch.Tensor  # (Q,) surface areas
    prim_to_q: torch.Tensor  # (P,) int64 prim id -> q index or -1
    # whether any area emitter exists (a host fact: without one the area
    # branches are not computed)
    has_area: bool = True

    @property
    def n_emitters(self):
        return self.em_type.shape[0]


def _sample_position_on_prim(geom: geo.Geometry, prim, sample2):
    """Uniform-area point and outward normal on primitives `prim`."""
    g = geo.Geometry(*(f[prim] for f in geom))
    b = square_to_uniform_triangle(sample2)
    p_tri = g.p0 + b[..., 0:1] * g.e1 + b[..., 1:2] * g.e2
    n_tri = m.normalize(m.cross(g.e1, g.e2))
    d = square_to_uniform_sphere(sample2)
    p_sph = g.p0 + g.e1[..., 0:1] * d
    cyl_len = torch.clamp(m.norm(g.e1), min=1e-12)
    cyl_a = g.e1 / cyl_len[..., None]
    fr = Frame.from_normal(cyl_a)
    phi = 2.0 * math.pi * sample2[..., 0]
    n_cyl = torch.cos(phi)[..., None] * fr.s + torch.sin(phi)[..., None] * fr.t
    p_cyl = (g.p0 + (sample2[..., 1] * cyl_len)[..., None] * cyl_a
             + g.e2[..., 0:1] * n_cyl)
    is_tri = (g.prim_type == geo.TRI)[..., None]
    is_cyl = (g.prim_type == geo.CYLINDER)[..., None]
    p = torch.where(is_tri, p_tri, torch.where(is_cyl, p_cyl, p_sph))
    n = torch.where(is_tri, n_tri, torch.where(is_cyl, n_cyl, d))
    return p, n


def sample_direction(table: EmitterTable, geom: geo.Geometry, p_ref,
                     sample3) -> DirectionSample:
    """Pick an emitter, sample a direction toward it; radiance and pdf in
    solid angle at p_ref. sample3 (..., 3): emitter selection (reused for
    the prim choice and the sky direction) and a 2-D position sample."""
    k, u0 = table.select.sample_reuse(sample3[..., 0])
    u2 = torch.stack([u0, sample3[..., 1]], -1)
    et = table.em_type[k]
    sel_pmf = table.select.eval_pmf(k)

    # ---- constant ----
    is_const = et == CONSTANT
    d = torch.where(is_const[..., None], square_to_uniform_sphere(u2), 0.0)
    dist = torch.full(p_ref.shape[:-1], float("inf"), device=p_ref.device)
    pdf = torch.where(is_const, INV_FOUR_PI, 0.0)
    radiance = torch.where(is_const[..., None], table.radiance[k], 0.0)

    # ---- area ----
    if table.has_area:
        is_area = et == AREA
        q, _ = table.prim_dist.sample_reuse(u2[..., 0], row=k)
        x, n_e = _sample_position_on_prim(geom, table.em_prims[q],
                                          sample3[..., 1:3])
        to_x = x - p_ref
        dist2 = (to_x * to_x).sum(-1)
        dist_a = torch.sqrt(torch.clamp(dist2, min=1e-12))
        d_a = to_x / dist_a[..., None]
        cos_e = m.dot(n_e, -d_a)
        front = cos_e > 0.0
        p_area = m.safe_div(table.prim_dist.eval_pmf(q, row=k), table.prim_area[q])
        pdf_a = torch.where(front, m.safe_div(p_area * dist2, cos_e), 0.0)
        d = torch.where(is_area[..., None], d_a, d)
        dist = torch.where(is_area, dist_a, dist)
        pdf = torch.where(is_area, pdf_a, pdf)
        radiance = torch.where((is_area & front)[..., None], table.radiance[k],
                               torch.where(is_area[..., None], 0.0, radiance))
    return DirectionSample(
        d=d, dist=dist, pdf=pdf * sel_pmf, radiance=radiance,
        delta=torch.zeros(p_ref.shape[:-1], dtype=torch.bool, device=p_ref.device),
    )


def pdf_hit_direction(table: EmitterTable, geom: geo.Geometry, si, p_ref):
    """NEE density (solid angle at p_ref) of a BSDF ray that hit si: the
    MIS denominator for area lights; 0 off emissive prims."""
    if not table.has_area:
        return torch.zeros_like(si.t)
    qs = torch.clamp(table.prim_to_q[si.prim.clamp(min=0)], min=0)
    valid = (si.prim >= 0) & (si.emitter >= 0)
    em = si.emitter.clamp(min=0)
    pmf_q = table.prim_dist.eval_pmf(qs, row=em)
    sel = table.select.eval_pmf(em)
    to_x = si.p - p_ref
    dist2 = (to_x * to_x).sum(-1)
    d = to_x * m.safe_rsqrt(dist2)[..., None]
    cos_e = m.dot(si.n, -d)
    pdf_sa = m.safe_div(
        pmf_q / torch.clamp(table.prim_area[qs], min=1e-12) * dist2, cos_e
    )
    return torch.where(valid & (cos_e > 0), sel * pdf_sa, 0.0)


def pdf_miss_direction(table: EmitterTable, d_world):
    """NEE density of a BSDF ray that escaped (the constant sky)."""
    p = torch.zeros(d_world.shape[:-1], device=d_world.device)
    if table.background_index >= 0:
        p = p + table.select.pmf[table.background_index] * INV_FOUR_PI
    return p


def eval_background(table: EmitterTable, d_world):
    """Radiance carried by escaped rays."""
    rad = torch.zeros_like(d_world)
    if table.background_index >= 0:
        rad = rad + table.radiance[table.background_index]
    return rad


def eval_hit(table: EmitterTable, si):
    """Radiance emitted by a surface hit toward the ray origin (area
    emitters, front side only)."""
    valid = si.emitter >= 0
    em = si.emitter.clamp(min=0)
    front = (si.n * si.to_world(si.wi)).sum(-1) > 0.0
    is_area = table.em_type[em] == AREA
    return torch.where(
        (valid & front & is_area)[..., None], table.radiance[em], 0.0
    )
