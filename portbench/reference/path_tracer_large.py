"""Plain PyTorch reference of the port's path integrator for scenes past
path_tracer's box-test memory: path_tracer (beside this file) with its
ray queries culled in two levels.

path_tracer culls a query by testing each chunk of rays against every box
of its groups of GROUP prims (Morton order): (rays x groups x 3) float32
tensors, ~22 GB each for 32,768 rays over the 56,000 groups of 7.2M
prims. Here the groups, in that order, are gathered into supergroups of
SUPER, each with the box around its groups' boxes. A chunk's rays are
tested against the supergroups' boxes, each (ray, supergroup) pair that
enters against its supergroup's own group boxes, and each (ray, group)
pair that enters against the group's prims by brute force, as in
path_tracer. The slab test is monotone in a box's bounds, so a ray that
enters a group's box enters its supergroup's: the (ray, group) pairs are
path_tracer's, and so is every answer, bit for bit (the nearest hit is
the least t, then the least prim id, whatever order the pairs come in).

Everything else is path_tracer's: its Scene (with the supergroups added),
sampler streams, integrator and materials; `trace` and `render_pixels`
are its own functions, run with this module's `_hits` in place of its
`_hits`. It imports nothing of the program.
"""

from __future__ import annotations

import types

import torch

from portbench.reference import path_tracer as pt

SUPER = 128  # groups a supergroup


class Scene(pt.Scene):
    """path_tracer's Scene, with its groups gathered in their order into
    supergroups: super_ids (S, SUPER) group ids padded with -1, super_lo /
    super_hi (S, 3) the least and greatest of their groups' bounds."""

    def __init__(self, d, device, dtype=torch.float32, params=None):
        super().__init__(d, device, dtype, params)
        g = self.group_lo.shape[0]
        n_sup = -(-g // SUPER)
        ids = torch.full((n_sup * SUPER,), -1, dtype=torch.int64, device=device)
        ids[:g] = torch.arange(g, device=device)
        self.super_ids = ids.reshape(n_sup, SUPER)
        inf = torch.full((n_sup * SUPER - g, 3), float("inf"), device=device)
        self.super_lo = torch.cat([self.group_lo, inf]).reshape(n_sup, SUPER, 3).amin(1)
        self.super_hi = torch.cat([self.group_hi, -inf]).reshape(n_sup, SUPER, 3).amax(1)


def scene_of(d, device, dtype=torch.float32, params=None):
    """The Scene of dict `d` (the references' common entry)."""
    return Scene(d, device, dtype, params)


def _enter(lo, hi, o, inv_d, lim):
    """path_tracer's slab test of rays (K, 1, 3) against boxes (K, M, 3)
    or (1, M, 3): a box is entered from t >= 0 and before lim."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return (far >= torch.clamp(near, min=0.0)) & (near <= lim[:, None])


def _pairs(scene, o, d, maxt, ray_chunk, pair_chunk):
    """The (ray, group) pairs whose group box each ray enters, through the
    supergroups: (rays, groups) int64."""
    n = o.shape[0]
    of = o.float()
    inv_d = 1.0 / torch.where(d.float().abs() < 1e-30, 1e-30, d.float())
    lim = torch.where(maxt.float() > 0.0, maxt.float(), -1.0)
    rays, groups = [], []
    for s in range(0, n, ray_chunk):
        sl = slice(s, s + ray_chunk)
        sup = torch.nonzero(_enter(scene.super_lo[None], scene.super_hi[None], of[sl, None],
                                   inv_d[sl, None], lim[sl]))
        for p in range(0, sup.shape[0], pair_chunk):
            r = sup[p:p + pair_chunk, 0] + s
            gid = scene.super_ids[sup[p:p + pair_chunk, 1]]
            safe = gid.clamp(min=0)
            ok = _enter(scene.group_lo[safe], scene.group_hi[safe], of[r, None], inv_d[r, None],
                        lim[r]) & (gid >= 0)
            pr, pg = torch.nonzero(ok, as_tuple=True)
            rays.append(r[pr])
            groups.append(gid[pr, pg])
    cat = (lambda xs: torch.cat(xs) if xs else torch.zeros(0, dtype=torch.int64,
                                                           device=o.device))
    return cat(rays), cat(groups)


def _hits(scene, o, d, maxt, any_hit, ray_chunk=1 << 15):
    """path_tracer's _hits over the pairs that _pairs finds: (t, prim, u, v)
    of the nearest hit with t < maxt (prim -1 on a miss; of equal t the
    lowest prim id), or a bool any-hit."""
    n, dev = o.shape[0], o.device
    pair_chunk = 1 << (17 if o.is_cuda else 15)
    pr = scene.prims
    rays, groups = _pairs(scene, o, d, maxt, ray_chunk, 1 << (16 if o.is_cuda else 12))
    t_p, prim_p, u_p, v_p = [], [], [], []
    m = scene.group_ids.shape[1]
    cols = torch.arange(m, device=dev)
    for s in range(0, rays.shape[0], pair_chunk):
        r, g = rays[s:s + pair_chunk], groups[s:s + pair_chunk]
        ids = scene.group_ids[g]
        safe = ids.clamp(min=0)
        t, u, v = pt._tri_test(o[r, None], d[r, None], pr["p0"][safe], pr["e1"][safe],
                               pr["e2"][safe], maxt[r])
        keep = ids >= 0
        if any_hit:
            keep = keep & scene.occludes[safe]
        t = torch.where(keep, t, float("inf"))
        t_g = t.amin(-1)
        j = torch.where(t == t_g[:, None], cols, m).amin(-1).clamp(max=m - 1)
        t_p.append(t_g)
        prim_p.append(torch.gather(ids, 1, j[:, None]).squeeze(1))
        if not any_hit:
            u_p.append(torch.gather(u, 1, j[:, None]).squeeze(1))
            v_p.append(torch.gather(v, 1, j[:, None]).squeeze(1))
    cat = (lambda xs, like: torch.cat(xs) if xs else like.new_zeros((0,)))
    t_p, prim_p = cat(t_p, o), cat(prim_p, rays)
    u_p, v_p = cat(u_p, o), cat(v_p, o)
    if scene.n_spheres:
        # every ray against every sphere (a scene holds few)
        oc = o[:, None] - scene.sphere_center[None]
        b = pt._dot(oc, d[:, None])
        c = pt._dot(oc, oc) - scene.sphere_radius[None] ** 2
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = -b - sq, -b + sq
        ts = torch.where(t0 > 1e-7, t0, t1)
        ok = (disc >= 0.0) & (ts > 1e-7) & (ts < maxt[:, None])
        if any_hit:
            ok = ok & scene.occludes[scene.n_tris:][None]
        rs, js = torch.nonzero(ok, as_tuple=True)
        rays = torch.cat([rays, rs])
        t_p = torch.cat([t_p, ts[rs, js]])
        prim_p = torch.cat([prim_p, js + scene.n_tris])
        u_p = torch.cat([u_p, torch.zeros_like(ts[rs, js])])
        v_p = torch.cat([v_p, torch.zeros_like(ts[rs, js])])
    hit = torch.isfinite(t_p)
    if any_hit:
        occluded = torch.zeros(n, dtype=torch.bool, device=dev)
        occluded[rays[hit]] = True
        return occluded
    best_t = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
    best_t = best_t.scatter_reduce(0, rays, t_p, "amin")
    tie = hit & (t_p == best_t[rays])
    big = scene.n_prims
    best_p = torch.full((n,), big, dtype=torch.int64, device=dev)
    best_p = best_p.scatter_reduce(0, rays[tie], prim_p[tie], "amin")
    win = tie & (prim_p == best_p[rays])
    best_u = torch.zeros(n, dtype=o.dtype, device=dev)
    best_v = torch.zeros(n, dtype=o.dtype, device=dev)
    best_u[rays[win]] = u_p[win]
    best_v[rays[win]] = v_p[win]
    return best_t, torch.where(best_p < big, best_p, -1), best_u, best_v


def _rebound(fn, glob):
    return types.FunctionType(fn.__code__, glob, fn.__name__, fn.__defaults__, fn.__closure__)


# path_tracer's own trace and render_pixels, reading this module's _hits
# (and render_pixels this module's trace) where they read path_tracer's
_GLOBALS = dict(vars(pt), _hits=_hits)
trace = _GLOBALS["trace"] = _rebound(pt.trace, _GLOBALS)
render_pixels = _GLOBALS["render_pixels"] = _rebound(pt.render_pixels, _GLOBALS)
