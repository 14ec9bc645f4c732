"""Primitive soup (triangles, spheres, cylinders) and brute-force ray
intersection.

PyTorch port of mitsuba_customization_tpu/render/geometry.py: `Geometry`,
`ray_triangle`, `ray_sphere`, `ray_cylinder`, `intersect_brute`,
`occluded_brute`, `compute_interaction`, `interaction_from_g` and
`spawn_ray`. The scene loader builds no cylinders, but the cluster
structure and its kernels test them, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.frame import Frame
from mitsuba_customization_tpu_torch.render.records import Ray, SurfaceInteraction

TRI = 0
SPHERE = 1
CYLINDER = 2  # p0 = base point, e1 = axis (length = height), e2[..., 0] =
              # radius; open-ended (lateral surface only)

_EPS = 1e-7


class Geometry(NamedTuple):
    """Primitive soup. Triangles: p0 + edge vectors e1, e2, per-vertex
    shading normals vn* and uvs. Spheres: p0 = center, e1[..., 0] = radius.
    Cylinders: see CYLINDER."""

    prim_type: torch.Tensor  # (P,) int64
    p0: torch.Tensor  # (P, 3)
    e1: torch.Tensor  # (P, 3)
    e2: torch.Tensor  # (P, 3)
    vn0: torch.Tensor  # (P, 3)
    vn1: torch.Tensor  # (P, 3)
    vn2: torch.Tensor  # (P, 3)
    uv0: torch.Tensor  # (P, 2)
    uv1: torch.Tensor  # (P, 2)
    uv2: torch.Tensor  # (P, 2)
    mat_id: torch.Tensor  # (P,) int64
    emitter_id: torch.Tensor  # (P,) int64, -1 = not an emitter
    shape_id: torch.Tensor  # (P,) int64

    @property
    def n_prims(self):
        return self.prim_type.shape[0]


def ray_triangle(o, d, p0, e1, e2):
    """Moller-Trumbore; broadcasts rays against prims. Returns (t, u, v, hit)
    with t = inf on a miss."""
    pvec = m.cross(d, e2)
    det = m.dot(e1, pvec)
    inv_det = m.safe_div(1.0, det)
    tvec = o - p0
    u = m.dot(tvec, pvec) * inv_det
    qvec = m.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = (det.abs() > _EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, float("inf")), u, v, hit


def ray_sphere(o, d, center, radius):
    """Stable quadratic sphere intersection. Returns (t, hit)."""
    oc = o - center
    b = m.dot(oc, d)
    c = m.dot(oc, oc) - radius * radius
    disc = b * b - c
    sqrt_d = m.safe_sqrt(disc)
    t0 = -b - sqrt_d
    t1 = -b + sqrt_d
    t = torch.where(t0 > _EPS, t0, t1)
    hit = (disc >= 0.0) & (t > _EPS)
    return torch.where(hit, t, float("inf")), hit


def ray_cylinder(o, d, p0, axis, radius):
    """Open cylinder around the segment p0..p0+axis: the nearest quadratic
    root whose axial coordinate lies on the segment. Returns (t, hit)."""
    length = torch.clamp(m.norm(axis), min=1e-12)
    a = axis / length[..., None]
    oc = o - p0
    d_par = m.dot(d, a)
    oc_par = m.dot(oc, a)
    dd = d - d_par[..., None] * a
    oo = oc - oc_par[..., None] * a
    qa = m.dot(dd, dd)
    qb = m.dot(dd, oo)
    qc = m.dot(oo, oo) - radius * radius
    disc = qb * qb - qa * qc
    sq = m.safe_sqrt(disc)
    inv_a = m.safe_div(1.0, qa)
    t0 = (-qb - sq) * inv_a
    t1 = (-qb + sq) * inv_a

    def on_seg(t):
        s = oc_par + t * d_par
        return (t > _EPS) & (s >= 0.0) & (s <= length)

    ok0, ok1 = on_seg(t0), on_seg(t1)
    t = torch.where(ok0, t0, torch.where(ok1, t1, float("inf")))
    hit = (disc >= 0.0) & (qa > 1e-12) & (ok0 | ok1)
    return torch.where(hit, t, float("inf")), hit


def _intersect_prims(geom: Geometry, o, d, cylinders=True):
    """Rays (N, 1, 3) against all prims -> (t, u, v), each (N, P).
    cylinders=False: the soup holds none (a host fact), so their test is
    not run."""
    t_tri, u, v, _ = ray_triangle(o, d, geom.p0, geom.e1, geom.e2)
    t_sph, _ = ray_sphere(o, d, geom.p0, geom.e1[..., 0])
    is_tri = geom.prim_type == TRI
    if cylinders:
        t_cyl, _ = ray_cylinder(o, d, geom.p0, geom.e1, geom.e2[..., 0])
        t_sph = torch.where(geom.prim_type == CYLINDER, t_cyl, t_sph)
    t = torch.where(is_tri, t_tri, t_sph)
    return t, torch.where(is_tri, u, 0.0), torch.where(is_tri, v, 0.0)


def intersect_brute(geom: Geometry, ray: Ray, cylinders=True):
    """All-pairs nearest hit: (t, prim, u, v), prim = -1 on a miss."""
    t, u, v = _intersect_prims(geom, ray.o[..., None, :], ray.d[..., None, :],
                               cylinders)
    t = torch.where(t < ray.maxt[..., None], t, float("inf"))
    t_best, best = t.min(-1)
    # first prim attaining the minimum, as the reference's masked reduction
    iota = torch.arange(t.shape[-1], device=t.device)
    best = torch.where(t == t_best[..., None], iota, t.shape[-1]).amin(-1)
    u_best = torch.gather(u, -1, best[..., None]).squeeze(-1)
    v_best = torch.gather(v, -1, best[..., None]).squeeze(-1)
    prim = torch.where(torch.isinf(t_best), -1, best)
    return t_best, prim, u_best, v_best


def occluded_brute(geom: Geometry, ray: Ray, cylinders=True):
    """Shadow-ray test: any hit with t < maxt."""
    t, _, _ = _intersect_prims(geom, ray.o[..., None, :], ray.d[..., None, :],
                               cylinders)
    return (t < ray.maxt[..., None]).any(-1)


def compute_interaction(geom: Geometry, ray: Ray, t, prim, u, v, cylinders=True):
    """SurfaceInteraction for the nearest hits (gathers the hit rows)."""
    g = Geometry(*(f[prim.clamp(min=0)] for f in geom))
    return interaction_from_g(g, ray, t, prim, u, v, cylinders)


def interaction_from_g(g: Geometry, ray: Ray, t, prim, u, v, cylinders=True):
    """SurfaceInteraction from per-lane winner Geometry rows `g` (the
    cluster intersector returns them, so no gather pass is needed).
    cylinders=False: the scene holds none (a host fact), so their normal
    and uv are not computed."""
    valid = prim >= 0
    p = ray.o + ray.d * torch.where(valid, t, 0.0)[..., None]

    is_tri = (g.prim_type == TRI)[..., None]
    n_tri = m.normalize(m.cross(g.e1, g.e2))
    radius = torch.clamp(g.e1[..., 0:1], min=1e-12)
    n_sph = (p - g.p0) / radius
    n_round = n_sph  # the normal of a sphere or cylinder hit
    if cylinders:
        is_cyl = (g.prim_type == CYLINDER)[..., None]
        cyl_len = torch.clamp(m.norm(g.e1), min=1e-12)
        cyl_a = g.e1 / cyl_len[..., None]
        pl = p - g.p0
        cyl_s = m.dot(pl, cyl_a)
        n_cyl = m.normalize(pl - cyl_s[..., None] * cyl_a)
        n_round = torch.where(is_cyl, n_cyl, n_sph)
    n_geo = torch.where(is_tri, n_tri, n_round)

    w = (1.0 - u - v)[..., None]
    n_sh = m.normalize(
        torch.where(
            is_tri, w * g.vn0 + u[..., None] * g.vn1 + v[..., None] * g.vn2,
            n_round,
        )
    )
    # two-sided shading: flip the shading frame toward the arriving ray;
    # si.n keeps the authored orientation (emitter front faces need it)
    facing = m.dot(n_geo, ray.d) < 0.0
    n_sh = torch.where(facing[..., None], n_sh, -n_sh)

    uv_tri = w * g.uv0 + u[..., None] * g.uv1 + v[..., None] * g.uv2
    theta, phi = m.dir_to_sph(n_sph)
    uv_round = torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], -1)
    if cylinders:
        cyl_frame = Frame.from_normal(cyl_a)
        phi_cyl = torch.atan2(m.dot(pl, cyl_frame.s), m.dot(pl, cyl_frame.t))
        uv_cyl = torch.stack([phi_cyl / (2.0 * math.pi) + 0.5, cyl_s / cyl_len], -1)
        uv_round = torch.where(is_cyl, uv_cyl, uv_round)
    uv = torch.where(is_tri, uv_tri, uv_round)

    frame = Frame.from_normal(n_sh)
    return SurfaceInteraction(
        valid=valid,
        t=t,
        p=p,
        n=n_geo,
        frame=frame,
        uv=uv,
        wi=frame.to_local(-ray.d),
        prim=torch.where(valid, prim, -1),
        mat_id=torch.where(valid, g.mat_id, 0),
        emitter=torch.where(valid, g.emitter_id, -1),
        bary=torch.where(
            valid[..., None] & is_tri, torch.stack([u, v], -1), 0.0
        ),
    )


def spawn_ray(si: SurfaceInteraction, d_world):
    """Secondary ray with its origin offset along the geometric normal."""
    sgn = torch.where(m.dot(d_world, si.n) >= 0.0, 1.0, -1.0)
    scale = m.RAY_EPSILON * (1.0 + si.p.abs().amax(-1))
    o = si.p + (sgn * scale)[..., None] * si.n
    return Ray.make(o, d_world)
