"""MIS path tracer (NEE + Russian roulette), wavefront compaction and the
render loop.

PyTorch port of mitsuba_customization_tpu/render/integrator.py:
`trace_paths` with its per-bounce body, `_compact_caps`,
`_systematic_survive`, `_run_bounces_compact`, `render_lanes` and
`render` (spp and row chunking, 16x16 blocked lane order, box filter). The
JAX package's lax.scan over bounces and passes becomes Python loops; the
bounce index is then a Python int, so the final bounce's dead shading tail
is skipped statically, as in the JAX package's unrolled loop.

Sampler dimension layout (identical to the JAX package, so at a fixed seed
both draw the same uniforms): dim = CAMERA_DIMS + bounce * BOUNCE_DIMS +
offset.
"""

from __future__ import annotations

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.qmc import as_u32, hash_combine
from mitsuba_customization_tpu_torch.core.sampler import (
    IndependentSampler,
    _uniform_from_bits,
    make_sampler,
)
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.models.normalmap import apply_normal_maps
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.render import film as film_mod
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.render.sensors import sample_ray

CAMERA_DIMS = 4  # 0-1 pixel jitter, 2-3 aperture
BOUNCE_DIMS = 8  # 0-1 bsdf 2d, 2 bsdf lobe select, 3 RR, 4-6 NEE
_OFF_NEE = 4

_SHADOW_INF = 1e30

# Pixel-block edge of the blocked lane ordering.
_BLOCK = 16

# Maximum lanes traced per pass; larger renders loop over spp / row chunks.
MAX_WAVEFRONT = 1 << 21


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2)."""
    a2 = pdf_a * pdf_a
    w = m.safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(pdf_a > 0.0, w, 0.0)


def _bounce(scene, state, sampler, b, max_depth, rr_depth, hide_emitters):
    """Bounce b of the path tracer over the lanes of `state` = (ray, thr,
    L, active, prev_pdf, prev_delta). Returns (state, rays traced)."""
    ray, thr, L, active, prev_pdf, prev_delta = state
    has_emitters = scene.emitters.n_emitters > 0
    do_nee = has_emitters and scene.config.nee
    smp = sampler.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS)
    # dead lanes trace with maxt = 0: the cluster kernels return at once
    si = scene.ray_intersect(
        Ray(o=ray.o, d=ray.d, maxt=torch.where(active, ray.maxt, 0.0))
    )
    si = apply_normal_maps(scene.bsdfs, si)
    n_rays = active.sum()

    # ---- emitter hits / escaped rays (MIS against the previous NEE) ----
    if has_emitters:
        show = b > 0 or not hide_emitters
        hit_rad = em_mod.eval_hit(scene.emitters, si)
        hit_pdf = em_mod.pdf_hit_direction(scene.emitters, scene.geometry, si, ray.o)
        bg_rad = em_mod.eval_background(scene.emitters, ray.d)
        bg_pdf = em_mod.pdf_miss_direction(scene.emitters, ray.d)
        rad = torch.where(si.valid[..., None], hit_rad, bg_rad)
        em_pdf = torch.where(si.valid, hit_pdf, bg_pdf)
        w_mis = torch.where(prev_delta, 1.0, mis_weight(prev_pdf, em_pdf))
        if show:
            L = L + torch.where(active[..., None], thr * rad * w_mis[..., None], 0.0)

    active = active & si.valid

    # final bounce: NEE (b + 2 <= max_depth) and the continuation
    # (b + 1 < max_depth) are both dead, so skip the shading tail
    if b == max_depth - 1:
        return (ray, thr, L, torch.zeros_like(active), prev_pdf, prev_delta), n_rays

    # ---- NEE direction + fused per-bounce BSDF work ----
    smp_nee = smp.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS + _OFF_NEE)
    u2 = smp.next_2d()
    u_lobe = smp.next_1d()
    nee_vis = None
    if do_nee:
        u3 = torch.stack(
            [smp_nee.next_1d(), smp_nee.next_1d(), smp_nee.next_1d()], -1
        )
        ds = em_mod.sample_direction(scene.emitters, scene.geometry, si.p, u3)
        wo_local = si.to_local(ds.d)
        # every ported BSDF only reflects: an NEE sample below the
        # shading horizon has f = 0, so its shadow ray is skipped
        nee_ok = (active & (ds.pdf > 0.0) & (b + 2 <= max_depth)
                  & (m.cos_theta(wo_local) > 0.0))
        # shadow ray before shading: occluded lanes skip the tabulated
        # NEE eval (visibility does not depend on f)
        shadow = geo.spawn_ray(si, ds.d)
        maxt = torch.where(
            torch.isinf(ds.dist), _SHADOW_INF, ds.dist * (1.0 - 1e-3)
        )
        maxt = torch.where(nee_ok, maxt, 0.0)
        occ = scene.ray_test(Ray(o=shadow.o, d=shadow.d, maxt=maxt))
        n_rays = n_rays + nee_ok.sum()
        nee_vis = nee_ok & ~occ
    else:
        wo_local = si.wi

    f_nee, bsdf_pdf_nee, wo, bsdf_pdf, weight, is_delta = bsdf_mod.bounce_shade(
        scene.bsdfs, si.mat_id, si.wi, wo_local, u2, u_lobe,
        has_nee=do_nee, active=active, nee_mask=nee_vis,
    )

    if do_nee:
        w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf_nee))
        contrib = thr * f_nee * ds.radiance * m.safe_div(w_nee, ds.pdf)[..., None]
        L = L + torch.where(nee_vis[..., None], contrib, 0.0)

    # ---- BSDF-sampled continuation ----
    thr = thr * torch.where(active[..., None], weight, 1.0)
    new_ray = geo.spawn_ray(si, si.to_world(wo))
    ray = Ray(
        o=torch.where(active[..., None], new_ray.o, ray.o),
        d=torch.where(active[..., None], new_ray.d, ray.d),
        maxt=torch.where(ray.maxt < 0.0, ray.maxt, float("inf")),
    )
    active = active & (bsdf_pdf > 0.0) & (weight > 0.0).any(-1)
    active = active & (b + 1 < max_depth)

    # ---- Russian roulette after rr_depth bounces (offset 3) ----
    if b + 1 >= rr_depth:
        u_rr = smp.next_1d()
        q = torch.clamp(thr.amax(-1), 0.05, 0.95)
        survive = u_rr < q
        thr = torch.where(survive[..., None], thr / q[..., None], thr)
        active = active & survive
    return (ray, thr, L, active, bsdf_pdf, is_delta), n_rays


def trace_paths(scene, ray0, sampler, max_depth, rr_depth, hide_emitters,
                compact_caps=None):
    """Per-lane path-traced radiance for primary rays ray0.

    compact_caps: a wavefront-compaction fraction schedule (None = off,
    see _run_bounces_compact). Returns (L (N, 3), {"rays_per_bounce":
    (max_depth,) float64 tensor}). Forward only: no backward pass is
    ported.
    """
    n = ray0.o.shape[0]
    dev = ray0.o.device
    state = (
        ray0,
        torch.ones((n, 3), device=dev),
        torch.zeros((n, 3), device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
    )
    if compact_caps is not None:
        L, rays_pb = _run_bounces_compact(
            scene, state, sampler, max_depth, rr_depth, hide_emitters,
            compact_caps,
        )
    else:
        rays_pb = []
        for b in range(max_depth):
            state, n_rays = _bounce(scene, state, sampler, b, max_depth,
                                    rr_depth, hide_emitters)
            rays_pb.append(n_rays)
        L = state[2]
    return L, {"rays_per_bounce": torch.stack(rays_pb).to(torch.float64)}


def _compact_caps(n, fracs, max_depth):
    """Per-bounce lane capacities from the fraction schedule `fracs`.

    caps[b] = lanes kept entering bounce b, rounded up to a multiple of
    2048, non-increasing, caps[0] = n. Entries beyond len(fracs) repeat
    the last fraction."""
    caps = [n]
    for b in range(1, max_depth):
        f = fracs[min(b, len(fracs) - 1)] if fracs else 1.0
        c = min(n, ((int(n * f) + 2047) // 2048) * 2048)
        caps.append(max(2048, min(caps[-1], c)))
    return caps


def _systematic_survive(active, cap, u):
    """Unbiased thinning to at most `cap` live lanes (systematic
    resampling): each active lane survives with p = min(1, c_eff / m),
    m = live count, and survivors carry weight 1 / p. c_eff keeps ~1.6 %
    headroom under cap so float32 rank rounding never overflows it; with
    p = 1 (the live set fits) every active lane survives. u: scalar
    uniform shared by all lanes. Returns (survive, p)."""
    m_live = active.to(torch.int32).sum(dtype=torch.int32)
    c_eff = cap - max(32, cap // 64)
    c_eff_f = torch.full((), float(c_eff), device=active.device)
    p = torch.clamp(c_eff_f / torch.clamp(m_live.to(torch.float32), min=1.0),
                    max=1.0)
    rank = (torch.cumsum(active.to(torch.int32), 0, dtype=torch.int32) - 1
            ).to(torch.float32)
    pos0 = (rank + u) * p
    survive = active & (torch.floor(pos0 + p) > torch.floor(pos0))
    return survive, p


def _spread7(x):
    """7-bit integer -> its bits on every third bit (Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spatial_key(o, d, s_lo, s_span):
    """3-bit direction octant << 21 | 21-bit Morton code of the origin's
    cell on a 128^3 grid over the supercluster bounds (int64)."""
    oct_ = ((d[:, 0] > 0).long() + 2 * (d[:, 1] > 0).long()
            + 4 * (d[:, 2] > 0).long())
    x = (o - s_lo) / s_span * 127.99
    # truncation toward zero, as the JAX package's astype(int32), of a
    # value first clamped where the clamp to [0, 127] gives the same cell
    cell = torch.clamp(torch.clamp(x, -1.0, 128.0).to(torch.int64), 0, 127)
    morton = (_spread7(cell[:, 0]) | (_spread7(cell[:, 1]) << 1)
              | (_spread7(cell[:, 2]) << 2))
    return (oct_ << 21) | morton


def _run_bounces_compact(scene, state, sampler, max_depth, rr_depth,
                         hide_emitters, fracs):
    """Bounce loop with per-bounce wavefront compaction.

    Entering bounce b the live lanes are thinned to the capacity caps[b]
    (_compact_caps) by unbiased systematic resampling
    (_systematic_survive), moved to a prefix by one sort, and the bounce
    runs on the prefix only; lanes past it keep their accumulated L. With
    the cluster intersector the sort key is the (direction octant, origin
    Morton cell) of each survivor, so neighbouring threads of K3 and K4
    trace neighbouring rays; otherwise it is the lane order. The sampler's
    lane ids and lane keys ride the permutation, so every lane draws what
    it draws uncompacted. A final scatter by lane tag restores film order.
    Returns (L (N, 3), per-bounce ray counts).

    The ray state lives in full-width tensors updated in place on the
    prefix (the JAX package rebuilds them by concatenation). maxt is not
    carried: after bounce 0 every spawned ray has maxt = inf.
    """
    ray, thr, L, active, prev_pdf, prev_delta = state
    n = ray.o.shape[0]
    dev = ray.o.device
    caps = _compact_caps(n, tuple(fracs), max_depth)
    full = {
        "o": ray.o.clone(), "d": ray.d.clone(), "maxt": ray.maxt.clone(),
        "thr": thr, "L": L, "active": active, "pdf": prev_pdf,
        "delta": prev_delta,
        "tag": torch.arange(n, dtype=torch.int64, device=dev),
        "lane": sampler.lane.clone(),
        "lane_key": sampler._lane_key.expand(n).clone(),
    }
    spatial = scene.config.intersector == "cluster" and scene.clusters is not None
    if spatial:
        root = scene.clusters.root
        s_lo = root[0:3]
        s_span = torch.clamp(root[3:6] - s_lo, min=1e-6)
    cur = n
    rays_pb = []
    compacted = False
    for b in range(max_depth):
        cap = caps[b]
        need_thin = cap < cur
        if need_thin or (spatial and b >= 1):
            compacted = True
            act = full["active"][:cur]
            if need_thin:
                bits = hash_combine(
                    hash_combine(as_u32(sampler.seed, act), as_u32(0xC09AC7, act)),
                    as_u32(b, act),
                )
                survive, p = _systematic_survive(act, cap, _uniform_from_bits(bits))
            else:
                survive, p = act, 1.0
            thr_p = torch.where(survive[..., None], full["thr"][:cur] / p,
                                full["thr"][:cur])
            if spatial:
                skey = _spatial_key(full["o"][:cur], full["d"][:cur], s_lo, s_span)
                key = torch.where(survive, skey, 1 << 25)
            else:
                iota = torch.arange(cur, device=dev)
                key = torch.where(survive, iota, iota + cur)
            perm = torch.sort(key).indices
            for name in ("o", "d", "L", "pdf", "delta", "tag", "lane", "lane_key"):
                full[name][:cur] = full[name][:cur][perm]
            full["thr"][:cur] = thr_p[perm]
            full["active"][:cur] = survive[perm]
            full["maxt"][:cur] = float("inf")
            if need_thin:
                cur = cap

        smp_b = IndependentSampler(sampler.seed, full["lane"][:cur],
                                   _lane_key=full["lane_key"][:cur])
        state_b = (
            Ray(o=full["o"][:cur], d=full["d"][:cur], maxt=full["maxt"][:cur]),
            full["thr"][:cur], full["L"][:cur], full["active"][:cur],
            full["pdf"][:cur], full["delta"][:cur],
        )
        (ray_b, thr_b, L_b, act_b, pdf_b, delta_b), n_rays = _bounce(
            scene, state_b, smp_b, b, max_depth, rr_depth, hide_emitters
        )
        for name, new in (("o", ray_b.o), ("d", ray_b.d), ("maxt", ray_b.maxt),
                          ("thr", thr_b), ("L", L_b), ("active", act_b),
                          ("pdf", pdf_b), ("delta", delta_b)):
            full[name][:cur] = new
        rays_pb.append(n_rays)

    L = full["L"]
    if compacted:
        # restore film (lane) order: tag is a permutation of [0, n)
        L_out = torch.empty_like(L)
        L_out[full["tag"]] = L
        L = L_out
    return L, rays_pb


def render_lanes(scene, spp, seed, max_depth=None, pixel=None, sample_idx=None):
    """Trace the lanes (pixel, sample_idx) (int64 tensors; all pixel * spp
    lanes when None). Returns (L (N, 3), film_xy (N, 2), stats). `spp` is
    the frame's total spp."""
    cfg = scene.config
    max_depth = max_depth or cfg.max_depth
    h, w = cfg.height, cfg.width
    if pixel is None:
        lanes = torch.arange(h * w * spp, dtype=torch.int64, device=scene.device)
        pixel, sample_idx = lanes // spp, lanes % spp
    smp = make_sampler(cfg.sampler, seed, pixel, sample_idx, spp)

    jitter = smp.next_2d()  # dims 2-3 (aperture) go unused: no thin lens
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)
    film_xy = torch.stack([px, py], -1) + jitter
    film_uv = film_xy / torch.tensor([w, h], dtype=torch.float32, device=px.device)
    ray0 = sample_ray(scene.sensor, film_uv, w / h)
    L, stats = trace_paths(
        scene, ray0, smp, max_depth, cfg.rr_depth, cfg.hide_emitters,
        compact_caps=cfg.compact,
    )
    return L, film_xy, stats


def _chunk_spp(hw, spp):
    """Largest divisor of spp keeping hw * chunk <= MAX_WAVEFRONT (min 1)."""
    chunk = max(1, min(spp, MAX_WAVEFRONT // max(hw, 1)))
    while spp % chunk != 0:
        chunk -= 1
    return chunk


def _chunk_rows(h, w):
    """Largest divisor of h keeping rows * w <= MAX_WAVEFRONT (min 1)."""
    rows = max(1, min(h, MAX_WAVEFRONT // max(w, 1)))
    while h % rows != 0:
        rows -= 1
    return rows


def render(scene, spp=None, seed=0, max_depth=None, return_stats=False):
    """Full pipeline to an (H, W, 3) image (box filter).

    Renders in (row slab, spp slice) passes of at most MAX_WAVEFRONT lanes.
    return_stats=True also returns {"rays_traced": total rays including
    shadow rays}.
    """
    cfg = scene.config
    spp = spp or cfg.spp
    dev = scene.device
    h, w = cfg.height, cfg.width
    rows = _chunk_rows(h, w)
    chunk = _chunk_spp(rows * w, spp)
    n_spp_pass = spp // chunk
    n_row_pass = h // rows

    # 16x16 pixel blocks when the slab tiles evenly, row-major otherwise
    blocked = rows % _BLOCK == 0 and w % _BLOCK == 0 and rows * w * chunk >= _BLOCK
    if blocked:
        order = np.arange(rows * w, dtype=np.int64).reshape(
            rows // _BLOCK, _BLOCK, w // _BLOCK, _BLOCK
        ).transpose(0, 2, 1, 3).reshape(-1)
    else:
        order = np.arange(rows * w, dtype=np.int64)
    pixel0 = torch.as_tensor(order, device=dev).repeat_interleave(chunk)
    sidx_local = torch.arange(chunk, dtype=torch.int64, device=dev).repeat(rows * w)

    img = torch.zeros((h, w, 3), device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    for p in range(n_spp_pass * n_row_pass):
        row_pass, spp_pass = p // n_spp_pass, p % n_spp_pass
        L, _, stats = render_lanes(
            scene, spp, seed, max_depth,
            pixel=pixel0 + row_pass * rows * w,
            sample_idx=sidx_local + spp_pass * chunk,
        )
        rays = rays + stats["rays_per_bounce"].sum()
        if blocked:
            slab = film_mod.develop_box_blocked(L, rows, w, chunk, _BLOCK)
        else:
            slab = film_mod.develop_box(L, rows, w, chunk)
        img[row_pass * rows:(row_pass + 1) * rows] += slab
    out = img / n_spp_pass
    if return_stats:
        return out, {"rays_traced": float(rays)}
    return out
