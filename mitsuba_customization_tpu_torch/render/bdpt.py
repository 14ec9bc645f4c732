"""Bidirectional path tracer (`bdpt`): streaming three-strategy BDPT.

PyTorch port of mitsuba_customization_tpu/render/bdpt.py: `_pw2`, `_w_of`,
`_edge`, `_cam_area_pdf`, `trace_eye_bdpt`, `trace_light_bdpt` and
`render_bdpt`. Of the (s, t) strategies it keeps the three that need no
stored vertices: s = 0 (the eye path hits an emitter), s = 1 (the eye path
connects to an emitter sample, NEE) and t = 1 (the light path connects to
the camera), with power-heuristic MIS between them. Each tracer carries
the product of reverse-over-forward area densities of its interior
vertices, the reverse density of a vertex completed one bounce later (the
VCM family's streaming recurrence).

As in the JAX package: surfaces only (no media), a perspective / thinlens
pinhole sensor, area emitters for the t = 1 strategy (constant and
envmap backgrounds through the eye strategies only), Russian roulette off
in both passes (rr_depth is ignored), and a path with a delta vertex drops
the t = 1 strategy on both sides.

A frame is a plan (`plan`: the host facts, the checks, the passes) and a
body (`body`: device work only, the seed a Python int or a 0-d int64
tensor), as render/ptracer.py's; `render_bdpt` runs the two.
"""

from __future__ import annotations

import math

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.qmc import MASK32
from mitsuba_customization_tpu_torch.core.sampler import make_sampler
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.render import film as film_mod
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import sensors as sensor_mod
from mitsuba_customization_tpu_torch.render.integrator import (
    _OFF_NEE,
    BOUNCE_DIMS,
    CAMERA_DIMS,
    texcoords,
)
from mitsuba_customization_tpu_torch.render.ptracer import (
    EM_DIMS,
    TracerPlan,
    _camera_frame,
    _passes,
    check_sensor,
    connect_sensor,
    sample_emitter_ray,
    splat_rows,
)
from mitsuba_customization_tpu_torch.render.records import Ray

_SHADOW_INF = 1e30
_LIGHT_SEED = 0x51633E2D
_PASS_STRIDE = 0x9E3779B9
# the emitter types bdpt renders
_EMITTERS = (em_mod.AREA, em_mod.CONSTANT, em_mod.ENVMAP)


def _pw2(x):
    return x * x


def _w_of(*ratios):
    """Power-heuristic (beta = 2) weight 1 / (1 + sum ratios^2)."""
    denom = 1.0
    for r in ratios:
        denom = denom + _pw2(r)
    return 1.0 / denom


def _edge(p_from, n_from, p_to):
    """(cos at p_from toward p_to, 1 / d^2, the unit direction)."""
    v = p_to - p_from
    d2 = torch.clamp((v * v).sum(-1), min=1e-12)
    d = v * torch.rsqrt(d2)[..., None]
    return m.dot(n_from, d).abs(), 1.0 / d2, d


def _cam_area_pdf(sensor, p, n_at_p, h, w):
    """Area density at p of the eye pass's primary vertex: (H W) imp(p)
    cos(theta_p); and the direction to the camera."""
    _, w_cam, imp, ok = connect_sensor(sensor, p, h, w)
    cos_p = m.dot(n_at_p, w_cam).abs()
    return torch.where(ok, (h * w) * imp * cos_p, 0.0), w_cam


def trace_eye_bdpt(scene, ray0, sampler, max_depth):
    """Eye pass: the s = 0 and s = 1 contributions with three-strategy MIS
    (trace_paths' structure without roulette). Returns (L (N, 3), rays)."""
    h, w = scene.config.height, scene.config.width
    sensor = scene.sensor
    has_em = scene.emitters.n_emitters > 0
    n, dev = ray0.o.shape[0], ray0.o.device
    ray = ray0
    thr = torch.ones((n, 3), device=dev)
    L = torch.zeros((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, device=dev)  # solid angle
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)  # the camera
    R_run = torch.ones(n, device=dev)  # through x_{c-2}
    pend_pA = torch.ones(n, device=dev)  # pA_fwd(x_{c-1})
    n_prev = torch.zeros((n, 3), device=dev)
    p_prev = torch.zeros((n, 3), device=dev)
    any_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    n_rays = torch.zeros((), device=dev)

    for b in range(max_depth):
        first = b == 0
        smp = sampler.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS)
        smp_nee = sampler.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS + _OFF_NEE)
        si = scene.ray_intersect(Ray(o=ray.o, d=ray.d,
                                     maxt=torch.where(active, ray.maxt, 0.0)))
        n_rays = n_rays + active.sum()

        # the edge x_{c-1} -> x_c (at b = 0 x_{c-1} is the camera, whose
        # role pA_cam plays)
        cos_prev, inv_d2, _ = _edge(p_prev, n_prev, si.p)
        cos_cur = m.dot(si.n, -ray.d).abs()
        pA_cam, _ = _cam_area_pdf(sensor, si.p, si.n, h, w)
        pA_fwd_cur = pA_cam if first else prev_pdf * cos_cur * inv_d2

        # ---- s = 0: an emitter hit or the background ----
        if has_em:
            hit_rad = em_mod.eval_hit(scene.emitters, si)
            hit_pdf = em_mod.pdf_hit_direction(scene.emitters, scene.geometry, si, ray.o)
            bg_rad = em_mod.eval_background(scene.emitters, ray.d)
            bg_pdf = em_mod.pdf_miss_direction(scene.emitters, ray.d)
            rad = torch.where(si.valid[..., None], hit_rad, bg_rad)
            em_pdf = torch.where(si.valid, hit_pdf, bg_pdf)
            # B/A: NEE over BSDF sampling, solid angle at the same vertex
            BA = torch.where(prev_delta | first, 0.0, m.safe_div(em_pdf, prev_pdf))
            # C/A: the light tracer's density over the eye's (area
            # measure); the light leaves by a cosine lobe, p_omega = cos/pi
            pA_L = em_mod.pdf_hit_area(scene.emitters, si)
            p_emdir = m.dot(si.n, -ray.d).abs() / math.pi
            pA_rev_prev = p_emdir * cos_prev * inv_d2
            CA = m.safe_div(pA_L, pA_fwd_cur)
            if not first:
                CA = CA * (m.safe_div(pA_rev_prev, pend_pA) * R_run)
            CA = torch.where(any_delta | (si.emitter < 0), 0.0, CA)
            w_mis = torch.where(si.valid & (si.emitter >= 0), _w_of(BA, CA),
                                # the background: only A and B exist
                                torch.where(prev_delta | first, 1.0, _w_of(BA)))
            L = L + torch.where(active[..., None], thr * rad * w_mis[..., None], 0.0)

        active = active & si.valid

        # ---- NEE + BSDF sampling (the fused dispatch) ----
        u2 = smp.next_2d()
        u_lobe = smp.next_1d()
        tc = texcoords(scene, si)
        if has_em:
            u3 = torch.stack([smp_nee.next_1d(), smp_nee.next_1d(), smp_nee.next_1d()], -1)
            ds = em_mod.sample_direction(scene.emitters, scene.geometry, si.p, u3)
            nee_ok = active & (ds.pdf > 0.0) & (b + 2 <= max_depth)
            wo_nee = si.to_local(ds.d)
        else:
            wo_nee = si.wi
        f_nee, pdf_nee, wo, bsdf_pdf, weight, is_delta = bsdf_mod.bounce_shade(
            scene.bsdfs, si.mat_id, si.wi, wo_nee, u2, u_lobe, tc, has_nee=has_em,
            active=active)

        # the reverse BSDF pdfs at the current vertex
        pdf_rev_cont = bsdf_mod.pdf(scene.bsdfs, si.mat_id, wo, si.wi, tc, active=active)

        # ---- s = 1: the NEE connection ----
        if has_em:
            pdf_rev_nee = bsdf_mod.pdf(scene.bsdfs, si.mat_id, wo_nee, si.wi, tc,
                                       active=nee_ok)
            shadow = geo.spawn_ray(si, ds.d)
            maxt = torch.where(torch.isinf(ds.dist), _SHADOW_INF, ds.dist * (1.0 - 1e-3))
            occ = scene.ray_test(Ray(o=shadow.o, d=shadow.d,
                                     maxt=torch.where(nee_ok, maxt, 0.0)))
            n_rays = n_rays + nee_ok.sum()
            AB = torch.where(ds.delta, 0.0, m.safe_div(pdf_nee, ds.pdf))
            # C/B of the NEE-completed path: the current vertex's ratio
            # takes the light-side density from the sampled light point
            # (cos at the light from pdf_sa = p_area d^2 / cos_l), x_{c-1}'s
            # takes pdf_rev_nee
            d2_nee = torch.where(torch.isinf(ds.dist), 1.0, ds.dist * ds.dist)
            cos_l_nee = m.safe_div(ds.p_area * d2_nee, ds.pdf)
            pA_rev_cur = cos_l_nee / math.pi * m.dot(si.n, ds.d).abs() / d2_nee
            CB = m.safe_div(pA_rev_cur, pA_fwd_cur)
            if not first:
                CB = CB * (m.safe_div(pdf_rev_nee * cos_prev * inv_d2, pend_pA) * R_run)
            CB = torch.where(any_delta | ds.delta | (ds.p_area <= 0.0), 0.0, CB)
            w_nee = torch.where(ds.delta, 1.0, _w_of(AB, CB))
            contrib = thr * f_nee * ds.radiance * m.safe_div(w_nee, ds.pdf)[..., None]
            L = L + torch.where((nee_ok & ~occ)[..., None], contrib, 0.0)

        # ---- continuation ----
        thr = thr * torch.where(active[..., None], weight, 1.0)
        new_ray = geo.spawn_ray(si, si.to_world(wo))
        ray = Ray(o=torch.where(active[..., None], new_ray.o, ray.o),
                  d=torch.where(active[..., None], new_ray.d, ray.d),
                  maxt=torch.where(ray.maxt < 0.0, ray.maxt, float("inf")))
        # complete x_{c-1}'s ratio with the continuation's reverse pdf
        ratio_cont = torch.where(
            is_delta | torch.isclose(pend_pA, torch.zeros_like(pend_pA)), 1.0,
            m.safe_div(pdf_rev_cont * cos_prev * inv_d2, pend_pA))
        if not first:
            R_run = R_run * ratio_cont
        pend_pA = pA_fwd_cur
        any_delta = any_delta | (active & is_delta)
        n_prev, p_prev = si.n, si.p
        prev_pdf, prev_delta = bsdf_pdf, is_delta
        active = active & (bsdf_pdf > 0.0) & (weight > 0.0).any(-1) & (b + 1 < max_depth)
    return L, n_rays


def trace_light_bdpt(scene, n_paths, seed, max_depth):
    """Light pass: the t = 1 contributions with three-strategy MIS
    (trace_light_paths' structure with the mirrored carries). Returns
    (splat values (V, 3), film_xy (V, 2), rays)."""
    cfg = scene.config
    h, w = cfg.height, cfg.width
    sensor = scene.sensor
    dev = scene.device
    lanes = torch.arange(n_paths, dtype=torch.int64, device=dev)
    smp = make_sampler("independent", (seed ^ _LIGHT_SEED) & MASK32, lanes,
                       torch.zeros_like(lanes), 1)
    u_sel = smp.next_1d()
    u_pos = smp.next_1d()
    u_dir = smp.next_2d()
    ray, beta, p0, n0, le0, area_w = sample_emitter_ray(
        scene.emitters, scene.geometry, u_sel, u_pos, u_dir)
    pA_L = m.safe_div(torch.ones_like(area_w), area_w)  # 0 for delta emitters
    is_area0 = area_w > 0.0
    origin = _camera_frame(sensor)[0]

    # ---- k = 1: the emission vertex -> camera (against the eye pass's
    # primary emitter hit: A/C = pA_cam(x_1) / pA_L) ----
    film0, w_cam0, imp0, ok0 = connect_sensor(sensor, p0, h, w)
    cos0 = torch.clamp(m.dot(n0, w_cam0), min=0.0)
    occ0 = scene.ray_test(Ray(o=p0 + 1e-4 * w_cam0, d=w_cam0,
                              maxt=m.norm(origin - p0) * (1.0 - 1e-3)))
    w0 = _w_of(m.safe_div((h * w) * imp0 * cos0, pA_L))
    c0 = le0 * (area_w * cos0 * imp0 * w0)[..., None]
    values = [torch.where((ok0 & is_area0 & ~occ0)[..., None], c0, 0.0)]
    films = [film0]

    active = is_area0  # area emission only
    prev_pdf = m.dot(n0, ray.d).abs() / math.pi  # the emission direction's pdf
    S_run = torch.ones(n_paths, device=dev)  # through y_{c-2}
    pend_pA = pA_L  # pA_rev(y_{c-1}); y_0's is pA_L
    n_prev, p_prev = n0, p0
    em_fac = torch.ones(n_paths, device=dev)  # pA_fwd(x_k) / pA_L
    any_delta = torch.zeros(n_paths, dtype=torch.bool, device=dev)
    n_rays = torch.zeros((), device=dev)
    for b in range(max_depth - 1):
        first = b == 0
        smp_b = smp.with_dim(EM_DIMS + b * BOUNCE_DIMS)
        si = scene.ray_intersect(Ray(o=ray.o, d=ray.d,
                                     maxt=torch.where(active, ray.maxt, 0.0)))
        active = active & si.valid
        n_rays = n_rays + active.sum()
        tc = texcoords(scene, si)

        cos_prev, inv_d2, _ = _edge(p_prev, n_prev, si.p)
        pA_rev_cur = prev_pdf * m.dot(si.n, -ray.d).abs() * inv_d2  # y_c, light side

        # ---- camera connection at y_c ----
        film_xy, w_cam, imp, okc = connect_sensor(sensor, si.p, h, w)
        conn = active & okc
        wo_cam = si.to_local(w_cam)
        f_cam = bsdf_mod.eval(scene.bsdfs, si.mat_id, si.wi, wo_cam, tc, active=conn)
        shadow = geo.spawn_ray(si, w_cam)
        occ = scene.ray_test(Ray(o=shadow.o, d=shadow.d, maxt=torch.where(
            conn, m.norm(origin - si.p) * (1.0 - 1e-3), 0.0)))
        pA_cam_c = (h * w) * imp * m.dot(si.n, w_cam).abs()
        # y_{c-1}'s ratio given incidence from the camera: the eye side's
        # pdf at y_c toward y_{c-1}
        pdf_fwd_conn = bsdf_mod.pdf(scene.bsdfs, si.mat_id, wo_cam, si.wi, tc, active=conn)
        ratio_conn = m.safe_div(pdf_fwd_conn * cos_prev * inv_d2, pend_pA)
        camfac = m.safe_div(pA_cam_c, pA_rev_cur)
        # c = 1: y_{c-1} is the emission vertex, ratio_conn is em_fac
        AC = camfac * (ratio_conn if first else ratio_conn * S_run * em_fac)
        BC = camfac * (1.0 if first else ratio_conn * S_run)
        good = conn & ~occ & ~any_delta
        values.append(torch.where(good[..., None],
                                  beta * f_cam * (imp * _w_of(AC, BC))[..., None], 0.0))
        films.append(film_xy)

        # ---- continue the light path ----
        u2 = smp_b.next_2d()
        u_lobe = smp_b.next_1d()
        wo, pdf_s, weight, is_delta = bsdf_mod.sample(scene.bsdfs, si.mat_id, si.wi, u2,
                                                      u_lobe, tc, active=active)
        # y_{c-1}'s ratio given incidence from y_{c+1}; the first is em_fac
        pdf_fwd_cont = bsdf_mod.pdf(scene.bsdfs, si.mat_id, wo, si.wi, tc, active=active)
        ratio_cont = torch.where(is_delta, 1.0,
                                 m.safe_div(pdf_fwd_cont * cos_prev * inv_d2, pend_pA))
        if first:
            em_fac = ratio_cont
        else:
            S_run = S_run * ratio_cont
        beta = beta * torch.where(active[..., None], weight, 1.0)
        nray = geo.spawn_ray(si, si.to_world(wo))
        ray = Ray.make(torch.where(active[..., None], nray.o, ray.o),
                       torch.where(active[..., None], nray.d, ray.d))
        pend_pA = pA_rev_cur
        n_prev, p_prev = si.n, si.p
        prev_pdf = pdf_s
        any_delta = any_delta | (active & is_delta)
        active = active & (pdf_s > 0.0) & (weight > 0.0).any(-1)
    return torch.cat(values), torch.cat(films), n_rays + n_paths


def plan(scene, spp=None, max_depth=None):
    """render_bdpt's TracerPlan: it rejects the batch sensor, other sensors
    than a pinhole, media and emitters other than area, constant and
    envmap, with the JAX package's messages; spp and depth (None: the
    scene's), the passes and the sensor's types."""
    cfg = scene.config
    check_sensor(scene.sensor, "bdpt", "bdpt does not support the 'batch' sensor")
    if scene.media.n_media:
        raise ValueError("bdpt does not support participating media")
    bad = {int(t) for t in scene.emitters.em_type.tolist()} - set(_EMITTERS)
    if bad and scene.emitters.n_emitters:
        raise ValueError("bdpt supports area emitters (+ constant/envmap backgrounds "
                         "through the eye strategies); scene has unsupported emitter "
                         f"types {sorted(bad)}")
    spp = int(spp or cfg.spp)
    return TracerPlan("bdpt", spp, int(max_depth or cfg.max_depth),
                      _passes(cfg.height * cfg.width * spp),
                      frozenset(sensor_mod.types_present(scene.sensor)))


def body(scene, plan, seed):
    """A planned bdpt frame: the eye pass box-developed plus the light pass
    splatted and divided by spp, both over H * W * spp paths (so the
    strategies' densities compare lane for lane). Device work only.
    Returns (image, rays traced, a 0-d float64 tensor)."""
    cfg = scene.config
    spp, max_depth = plan.spp, plan.max_depth
    h, w = cfg.height, cfg.width
    dev = scene.device
    n_chunk = h * w * spp // plan.n_pass
    light_img = torch.zeros((h, w, 3), device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    eye_parts = []
    for p in range(plan.n_pass):
        lanes = p * n_chunk + torch.arange(n_chunk, dtype=torch.int64, device=dev)
        pixel, sidx = lanes // spp, lanes % spp
        smp = make_sampler(cfg.sampler, seed, pixel, sidx, spp)
        jitter = smp.next_2d()
        aperture = smp.next_2d() if sensor_mod.THINLENS in plan.present else None
        film_xy = torch.stack([(pixel % w).to(torch.float32),
                               (pixel // w).to(torch.float32)], -1) + jitter
        # the film size made on the device (no host copy in a captured frame)
        wh = torch.stack([film_xy.new_full((), float(w)), film_xy.new_full((), float(h))])
        film_uv = film_xy / wh
        ray0 = sensor_mod.sample_ray(scene.sensor, film_uv, aperture, w / h,
                                     present=plan.present)
        L, nr = trace_eye_bdpt(scene, ray0, smp, max_depth)
        eye_parts.append(L)
        vals, xy, nr2 = trace_light_bdpt(scene, n_chunk, (seed + p * _PASS_STRIDE) & MASK32,
                                         max_depth)
        light_img = light_img + splat_rows(vals, xy, h, w, film_mod.BOX)
        rays = rays + nr.to(torch.float64) + nr2.to(torch.float64)
    # the eye lanes are pixel-major chunks: together the whole wavefront
    img = film_mod.develop_box(torch.cat(eye_parts), h, w, spp) + light_img / spp
    return img, rays


def render_bdpt(scene, spp=None, seed=0, max_depth=None, return_stats=False):
    """A bdpt frame (`plan`, then `body`). return_stats adds
    {"rays_traced": ...}."""
    img, rays = body(scene, plan(scene, spp, max_depth), seed)
    if return_stats:
        return img, {"rays_traced": float(rays)}
    return img
