"""MIS path tracer (NEE + Russian roulette) and the render loop.

PyTorch port of mitsuba_customization_tpu/render/integrator.py:
`trace_paths` without wavefront compaction, `render_lanes` and `render`
(spp and row chunking, 16x16 blocked lane order, box filter). The JAX
package's lax.scan over bounces and passes becomes Python loops; the
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
from mitsuba_customization_tpu_torch.core.sampler import make_sampler
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


def trace_paths(scene, ray0, sampler, max_depth, rr_depth, hide_emitters):
    """Per-lane path-traced radiance for primary rays ray0.

    Returns (L (N, 3), {"rays_per_bounce": (max_depth,) float64 tensor}).
    Forward only: no backward pass is ported.
    """
    has_emitters = scene.emitters.n_emitters > 0
    do_nee = has_emitters and scene.config.nee
    n = ray0.o.shape[0]
    dev = ray0.o.device
    ray = ray0
    thr = torch.ones((n, 3), device=dev)
    L = torch.zeros((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    rays_pb = []

    for b in range(max_depth):
        smp = sampler.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS)
        si = scene.ray_intersect(
            Ray(o=ray.o, d=ray.d, maxt=torch.where(active, ray.maxt, 0.0))
        )
        si = apply_normal_maps(scene.bsdfs, si)
        n_rays = active.sum()

        # ---- emitter hits / escaped rays (MIS against the previous NEE) ----
        if has_emitters:
            show = b > 0 or not hide_emitters
            hit_rad = em_mod.eval_hit(scene.emitters, si)
            hit_pdf = em_mod.pdf_hit_direction(scene.emitters, si, ray.o)
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
            rays_pb.append(n_rays)
            break

        # ---- NEE direction + fused per-bounce BSDF work ----
        smp_nee = smp.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS + _OFF_NEE)
        u2 = smp.next_2d()
        u_lobe = smp.next_1d()
        nee_vis = None
        if do_nee:
            u3 = torch.stack(
                [smp_nee.next_1d(), smp_nee.next_1d(), smp_nee.next_1d()], -1
            )
            ds = em_mod.sample_direction(scene.emitters, si.p, u3)
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
        prev_pdf, prev_delta = bsdf_pdf, is_delta
        rays_pb.append(n_rays)

    return L, {"rays_per_bounce": torch.stack(rays_pb).to(torch.float64)}


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
        scene, ray0, smp, max_depth, cfg.rr_depth, cfg.hide_emitters
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
