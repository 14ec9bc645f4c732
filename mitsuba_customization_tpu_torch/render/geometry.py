"""Primitive soup (triangles + spheres) and brute-force ray intersection.

PyTorch port of mitsuba_customization_tpu/render/geometry.py: `Geometry`,
`ray_triangle`, `ray_sphere`, `intersect_brute`, `occluded_brute`,
`compute_interaction` and `spawn_ray`. Cylinders are not ported; the
scene loader rejects them.
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
CYLINDER = 2

_EPS = 1e-7


class Geometry(NamedTuple):
    """Primitive soup. Triangles: p0 + edge vectors e1, e2, per-vertex
    shading normals vn* and uvs. Spheres: p0 = center, e1[..., 0] = radius."""

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


def _intersect_prims(geom: Geometry, o, d):
    """Rays (N, 1, 3) against all prims -> (t, u, v), each (N, P)."""
    t_tri, u, v, _ = ray_triangle(o, d, geom.p0, geom.e1, geom.e2)
    t_sph, _ = ray_sphere(o, d, geom.p0, geom.e1[..., 0])
    is_tri = geom.prim_type == TRI
    t = torch.where(is_tri, t_tri, t_sph)
    return t, torch.where(is_tri, u, 0.0), torch.where(is_tri, v, 0.0)


def intersect_brute(geom: Geometry, ray: Ray):
    """All-pairs nearest hit: (t, prim, u, v), prim = -1 on a miss."""
    t, u, v = _intersect_prims(geom, ray.o[..., None, :], ray.d[..., None, :])
    t = torch.where(t < ray.maxt[..., None], t, float("inf"))
    t_best, best = t.min(-1)
    # first prim attaining the minimum, as the reference's masked reduction
    iota = torch.arange(t.shape[-1], device=t.device)
    best = torch.where(t == t_best[..., None], iota, t.shape[-1]).amin(-1)
    u_best = torch.gather(u, -1, best[..., None]).squeeze(-1)
    v_best = torch.gather(v, -1, best[..., None]).squeeze(-1)
    prim = torch.where(torch.isinf(t_best), -1, best)
    return t_best, prim, u_best, v_best


def occluded_brute(geom: Geometry, ray: Ray):
    """Shadow-ray test: any hit with t < maxt."""
    t, _, _ = _intersect_prims(geom, ray.o[..., None, :], ray.d[..., None, :])
    return (t < ray.maxt[..., None]).any(-1)


def compute_interaction(geom: Geometry, ray: Ray, t, prim, u, v):
    """SurfaceInteraction for the nearest hits."""
    g = Geometry(*(f[prim.clamp(min=0)] for f in geom))
    valid = prim >= 0
    p = ray.o + ray.d * torch.where(valid, t, 0.0)[..., None]

    is_tri = (g.prim_type == TRI)[..., None]
    n_tri = m.normalize(m.cross(g.e1, g.e2))
    radius = torch.clamp(g.e1[..., 0:1], min=1e-12)
    n_sph = (p - g.p0) / radius
    n_geo = torch.where(is_tri, n_tri, n_sph)

    w = (1.0 - u - v)[..., None]
    n_sh = m.normalize(
        torch.where(
            is_tri, w * g.vn0 + u[..., None] * g.vn1 + v[..., None] * g.vn2,
            n_sph,
        )
    )
    # two-sided shading: flip the shading frame toward the arriving ray
    facing = m.dot(n_geo, ray.d) < 0.0
    n_sh = torch.where(facing[..., None], n_sh, -n_sh)

    uv_tri = w * g.uv0 + u[..., None] * g.uv1 + v[..., None] * g.uv2
    theta, phi = m.dir_to_sph(n_sph)
    uv_sph = torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], -1)
    uv = torch.where(is_tri, uv_tri, uv_sph)

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
