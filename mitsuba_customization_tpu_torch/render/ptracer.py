"""Particle (light) tracer: the `ptracer` integrator.

PyTorch port of mitsuba_customization_tpu/render/ptracer.py (mitsuba3
src/integrators/ptracer.cpp): `_camera_frame`, `_film_area`,
`connect_sensor`, `sample_emitter_ray`, `trace_light_paths` and
`render_ptracer`. Paths start on emitters, scatter through the scene, and
every vertex splats a camera connection onto the film; the film divides
by the paths per pixel (spp), as mitsuba3 develops its ptracer block.

For a pinhole camera with its film plane at z = 1, a particle of power
throughput beta at vertex x adds beta * f(x, w_i -> w_cam) / (r^2
cos^3(theta) A_film) to the pixel x projects to (connect_sensor's `imp`).

As in the JAX package: perspective and thinlens sensors (a pinhole: the
aperture is not sampled), area, point and spot emitters (the loader
rejects the others in a ptracer scene), and no importance-transport
corrections for shading normals or refraction. Its sampler is
`independent` with seed `seed ^ 0x9E3779B9`, one lane a light path; a
frame of more than MAX_WAVEFRONT paths renders in passes whose seeds
advance by 0x85EBCA6B.

A frame is a plan (`plan`: the host facts, the sensor check and the
passes) and a body (`body`: device work only, the seed a Python int or a
0-d int64 tensor), so a captured frame (render/integrator.render_jit)
records the body as it is; `render_ptracer` runs the two.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.frame import Frame
from mitsuba_customization_tpu_torch.core.qmc import MASK32
from mitsuba_customization_tpu_torch.core.sampler import make_sampler
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_uniform_sphere,
)
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.render import film as film_mod
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.render.sensors import PERSPECTIVE, THINLENS

# Sampler dimensions: EM_DIMS start a path, BOUNCE_DIMS a bounce
EM_DIMS = 6  # 0 emitter select, 1-2 position / prim, 3-4 direction
BOUNCE_DIMS = 8  # 0-1 bsdf 2d, 2 lobe, 3 RR
_LIGHT_SEED = 0x9E3779B9
# the emitters a light path starts from (the loader refuses the others in
# a ptracer scene)
SUPPORTED_EMITTERS = (em_mod.AREA, em_mod.POINT, em_mod.SPOT)
_PASS_STRIDE = 0x85EBCA6B
# rows splat at a time (splat_rows): film.splat's nine-offset temporaries
# take about 440 bytes a row, so a chunk holds about 0.9 GB of them
SPLAT_CHUNK = 1 << 21


def _camera_frame(sensor):
    rot = sensor.to_world[:3, :3]
    return sensor.to_world[:3, 3], rot, rot[:, 2]


def _film_area(sensor, aspect):
    """The film's area on the camera's z = 1 plane."""
    tan_half = torch.tan(torch.deg2rad(sensor.fov_x) * 0.5)
    return (2.0 * tan_half) * (2.0 * tan_half / aspect)


def connect_sensor(sensor, p, h, w):
    """Project world points p (N, 3) through the pinhole. Returns (film_xy
    (N, 2), w_cam (N, 3) the unit direction p -> camera, imp (N,) = 1 /
    (r^2 cos^3 theta A_film), 0 where not valid, valid (N,))."""
    aspect = w / h
    origin, rot, _ = _camera_frame(sensor)
    rel = p - origin
    # camera space: the components along rot's columns, as sums of
    # products (no matmul, so no TF32 on the card)
    pc = torch.stack([m.dot(rel, rot[:, i]) for i in range(3)], -1)
    z = pc[..., 2]
    valid = z > torch.clamp(sensor.near_clip, min=1e-6)
    zs = torch.where(valid, z, 1.0)
    tan_half = torch.tan(torch.deg2rad(sensor.fov_x) * 0.5)
    u = (pc[..., 0] / zs / tan_half + 1.0) * 0.5
    v = (1.0 - pc[..., 1] / zs * aspect / tan_half) * 0.5
    valid = valid & (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    film_xy = torch.stack([u * w, v * h], -1)
    r2 = torch.clamp((rel * rel).sum(-1), min=1e-12)
    cos_t = torch.clamp(z / torch.sqrt(r2), 1e-6, 1.0)
    imp = 1.0 / (r2 * cos_t ** 3 * _film_area(sensor, aspect))
    return film_xy, -m.normalize(rel), torch.where(valid, imp, 0.0), valid


def sample_emitter_ray(emitters, geom, u_sel, u_pos, u_dir):
    """Start light paths: (ray, beta (N, 3), p0, n0, le0, area_w). beta =
    Le cos / (p_sel p_A p_omega), the power throughput leaving the
    emission vertex; p0, n0 (the direction for a delta emitter) and le0
    describe that vertex for the direct camera connection, area_w =
    1 / (p_sel p_A) its surface-measure weight (0 for delta emitters)."""
    k, u_rest = emitters.select.sample_reuse(u_sel)
    p_sel = emitters.select.eval_pmf(k)
    et = emitters.em_type[k]
    rad = emitters.radiance.index_select(0, k)
    pos = emitters.position[k]
    sdir = emitters.direction[k]
    cutoff = emitters.cutoff_cos[k]
    beam = emitters.beam_cos[k]

    # area: a prim by the emitter's pmf, a uniform point, a cosine direction
    q, u_rest2 = emitters.prim_dist.sample_reuse(u_rest, slice_=k)
    pmf_q = emitters.prim_dist.eval_pmf(q, slice_=k)
    area = torch.clamp(emitters.prim_area[q], min=1e-12)
    p_area, n_area = em_mod._sample_position_on_prim(
        geom, emitters.em_prims[q], torch.stack([u_pos, u_rest2], -1))
    d_area = Frame.from_normal(n_area).to_world(square_to_cosine_hemisphere(u_dir))
    # beta = Le cos / (p_sel (pmf / area) cos / pi)
    w_area = math.pi * area / torch.clamp(pmf_q * p_sel, min=1e-12)

    # point: the uniform sphere
    d_point = square_to_uniform_sphere(u_dir)
    w_point = 4.0 * math.pi / torch.clamp(p_sel, min=1e-12)

    # spot: the uniform cone about its direction, linear falloff
    cos_theta = 1.0 - u_dir[..., 0] * (1.0 - cutoff)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * u_dir[..., 1]
    d_spot = Frame.from_normal(sdir).to_world(torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], -1))
    pdf_cone = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cutoff), min=1e-12)
    fall = torch.clamp((cos_theta - cutoff) / torch.clamp(beam - cutoff, min=1e-6), 0.0, 1.0)
    w_spot = fall / torch.clamp(pdf_cone * p_sel, min=1e-12)

    is_area = et == em_mod.AREA
    is_spot = et == em_mod.SPOT
    supported = is_area | (et == em_mod.POINT) | is_spot
    o = torch.where(is_area[..., None], p_area, pos)
    d = torch.where(is_area[..., None], d_area,
                    torch.where(is_spot[..., None], d_spot, d_point))
    w = torch.where(is_area, w_area, torch.where(is_spot, w_spot, w_point))
    beta = rad * torch.where(supported, w, 0.0)[..., None]
    n0 = torch.where(is_area[..., None], n_area, d)
    ray = Ray.make(o + 1e-4 * n0, d)
    area_w = torch.where(is_area, area / torch.clamp(pmf_q * p_sel, min=1e-12), 0.0)
    return ray, beta, o, n0, rad, area_w


def check_sensor(sensor, name, batch_msg):
    """The single pinhole camera the light paths connect to (the JAX
    package's messages)."""
    if sensor.child_types is not None:
        raise ValueError(batch_msg)
    if int(sensor.sensor_type) not in (PERSPECTIVE, THINLENS):
        raise ValueError(f"{name} supports perspective/thinlens sensors only")


def trace_light_paths(scene, n_paths, spp, seed, max_depth, rr_depth):
    """Trace n_paths light paths; returns (splat values (V, 3), film_xy
    (V, 2), rays traced) with V = n_paths * (max_depth + 1) camera
    connections, those that fail with zero weight. A lane that is no
    longer live traces, shades and connects nothing (maxt 0, masked BSDF
    calls), where the JAX package computes and then drops its values."""
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

    # ---- the emission vertex -> camera (path length 1) ----
    origin = _camera_frame(sensor)[0]
    film0, w_cam0, imp0, ok0 = connect_sensor(sensor, p0, h, w)
    cos0 = torch.clamp(m.dot(n0, w_cam0), min=0.0)
    occ0 = scene.ray_test(Ray(o=p0 + 1e-4 * w_cam0, d=w_cam0,
                              maxt=m.norm(origin - p0) * (1.0 - 1e-3)))
    c0 = le0 * (area_w * cos0 * imp0)[..., None]
    values = [torch.where((ok0 & ~occ0)[..., None], c0, 0.0)]
    films = [film0]

    active = torch.ones(n_paths, dtype=torch.bool, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(max_depth):
        smp_b = smp.with_dim(EM_DIMS + b * BOUNCE_DIMS)
        si = scene.ray_intersect(Ray(o=ray.o, d=ray.d, maxt=torch.where(active, ray.maxt, 0.0)))
        active = active & si.valid
        n_rays = n_rays + active.sum()

        # ---- camera connection from the surface vertex ----
        film_xy, w_cam, imp, okc = connect_sensor(sensor, si.p, h, w)
        conn = active & okc
        f_cam = bsdf_mod.eval(scene.bsdfs, si.mat_id, si.wi, si.to_local(w_cam), si.uv,
                              active=conn)
        shadow = geo.spawn_ray(si, w_cam)
        occ = scene.ray_test(Ray(o=shadow.o, d=shadow.d, maxt=torch.where(
            conn, m.norm(origin - si.p) * (1.0 - 1e-3), 0.0)))
        good = conn & ~occ
        values.append(torch.where(good[..., None], beta * f_cam * imp[..., None], 0.0))
        films.append(film_xy)

        # ---- continue the light path ----
        u2 = smp_b.next_2d()
        u_lobe = smp_b.next_1d()
        wo, pdf_s, weight, _ = bsdf_mod.sample(scene.bsdfs, si.mat_id, si.wi, u2, u_lobe,
                                               si.uv, active=active)
        beta = beta * torch.where(active[..., None], weight, 1.0)
        nray = geo.spawn_ray(si, si.to_world(wo))
        ray = Ray.make(torch.where(active[..., None], nray.o, ray.o),
                       torch.where(active[..., None], nray.d, ray.d))
        active = active & (pdf_s > 0.0) & (weight > 0.0).any(-1)
        # roulette on the step's weight, not the throughput (offset 3)
        if b + 1 >= rr_depth:
            u_rr = smp_b.next_1d()
            q = torch.clamp(torch.clamp(weight, max=1e3).amax(-1), 0.05, 0.95)
            survive = u_rr < q
            beta = torch.where(survive[..., None], beta / q[..., None], beta)
            active = active & survive
    return torch.cat(values), torch.cat(films), n_rays + n_paths


def splat_rows(values, film_xy, h, w, filter_type):
    """film.splat's image of every row of `values` (most camera
    connections of a light path fail, and their rows are zero: they add
    nothing). A zero row's film position, which a failed connection
    computes from garbage, moves first to the centre of a pixel of its own
    (row r to pixel r mod (H W)): its filter weights are then finite (a
    NaN weight times 0 would be NaN), and the zero rows' atomic adds on
    the card spread over the film instead of meeting at one pixel. The
    rows go SPLAT_CHUNK at a time, each chunk's image added to the sum,
    which bounds the temporaries whatever the number of rows."""
    img = values.new_zeros((h, w, values.shape[-1]))
    for s in range(0, values.shape[0], SPLAT_CHUNK):
        v, p = values[s:s + SPLAT_CHUNK], film_xy[s:s + SPLAT_CHUNK]
        keep = (v != 0.0).any(-1)
        r = torch.arange(s, s + v.shape[0], device=v.device) % (h * w)
        spread = torch.stack([r % w, r // w], -1).to(p.dtype) + 0.5
        xy = torch.where(keep[:, None], p, spread)
        img = img + film_mod.splat(v, xy, h, w, filter_type)[0]
    return img


def _passes(total):
    """The number of light-path passes of a frame: the fewest of at most
    MAX_WAVEFRONT paths each that divide `total`."""
    from mitsuba_customization_tpu_torch.render.integrator import MAX_WAVEFRONT

    n_pass = max(1, (total + MAX_WAVEFRONT - 1) // MAX_WAVEFRONT)
    while total % n_pass:
        n_pass += 1
    return n_pass


class TracerPlan(NamedTuple):
    """The host facts of a ptracer or bdpt frame: the integrator, spp, the
    path depth, the passes and (bdpt) the sensor's types. Hashable: a
    captured frame's key holds it."""

    kind: str
    spp: int
    max_depth: int
    n_pass: int
    present: frozenset = frozenset()


def plan(scene, spp=None, max_depth=None):
    """render_ptracer's TracerPlan: the sensor check, spp and depth (None:
    the scene's) and the passes."""
    cfg = scene.config
    check_sensor(scene.sensor, "ptracer",
                 "integrator 'ptracer' does not support the 'batch' sensor: "
                 "light-path camera connections need a single camera")
    spp = int(spp or cfg.spp)
    return TracerPlan("ptracer", spp, int(max_depth or cfg.max_depth),
                      _passes(cfg.height * cfg.width * spp))


def body(scene, plan, seed):
    """A planned ptracer frame: H * W * spp light paths splatted with the
    film's filter and divided by spp. Device work only. Returns (image,
    rays traced, a 0-d int64 tensor)."""
    cfg = scene.config
    h, w = cfg.height, cfg.width
    n_chunk = h * w * plan.spp // plan.n_pass
    img = torch.zeros((h, w, 3), device=scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for p in range(plan.n_pass):
        vals, xy, n_rays = trace_light_paths(scene, n_chunk, plan.spp,
                                             (seed + p * _PASS_STRIDE) & MASK32,
                                             plan.max_depth, cfg.rr_depth)
        img = img + splat_rows(vals, xy, h, w, film_mod.FILTER_NAMES[cfg.rfilter])
        rays = rays + n_rays
    return img / float(plan.spp), rays


def render_ptracer(scene, spp=None, seed=0, max_depth=None, return_stats=False):
    """A ptracer frame: H * W * spp light paths splatted with the film's
    filter and divided by spp (`plan`, then `body`). return_stats adds
    {"rays_traced": ...}."""
    out, rays = body(scene, plan(scene, spp, max_depth), seed)
    if return_stats:
        return out, {"rays_traced": float(rays)}
    return out
