"""MIS path tracer (NEE + Russian roulette), the volumetric path tracer,
wavefront compaction and the render loop.

PyTorch port of mitsuba_customization_tpu/render/integrator.py:
`trace_paths` with its per-bounce body, `trace_volpath` with its own,
`_compact_caps`, `_systematic_survive`, `_run_bounces_compact`,
`render_lanes` with its integrator dispatch (path, direct, depth, aov*,
moment, prb / prb_basic as path; volpath, volpathmis, prbvolpath and any
scene with media through trace_volpath) and `render` (ptracer and bdpt
handed to render/ptracer.py and render/bdpt.py; spp and row chunking,
16x16 blocked lane order, the box filter or a splat filter, the sensor's
scale; 6 channels for moment). The
JAX package's lax.scan over bounces and passes becomes Python loops; the
bounce index is then a Python int, so the final bounce's dead shading tail
is skipped statically, as in the JAX package's unrolled loop.

Sampler dimension layout (identical to the JAX package, so at a fixed seed
both draw the same uniforms): dim = CAMERA_DIMS + bounce * BOUNCE_DIMS +
offset.

Gradients (`ad_mode=True`) follow the JAX package: the detached estimator
of path-replay backpropagation, each bounce run under
torch.utils.checkpoint so that the backward replays it forward with the
stateless sampler (see `trace_paths`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.qmc import as_u32, hash_combine
from mitsuba_customization_tpu_torch.core.sampler import _uniform_from_bits, make_sampler
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.models import phase as phase_mod
from mitsuba_customization_tpu_torch.models.normalmap import apply_normal_maps
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.render import film as film_mod
from mitsuba_customization_tpu_torch.render import frame_graph
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import medium as medium_mod
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.render.scene import INTEGRATOR_TYPES
from mitsuba_customization_tpu_torch.render import sensors as sensor_mod
from mitsuba_customization_tpu_torch.utils import log

CAMERA_DIMS = 4  # 0-1 pixel jitter, 2-3 aperture
BOUNCE_DIMS = 8  # 0-1 bsdf 2d, 2 bsdf lobe select, 3 RR, 4-6 NEE
_OFF_NEE = 4
# the volumetric tracer's free-flight draws: their own seed, dimension
# base bounce * _MED_STRIDE, the shadow ray's ratio tracking + _MED_SHADOW
_MED_SEED = 0x6D656469
_MED_STRIDE = 4096
_MED_SHADOW = 2048
_VOL_TYPES = ("volpath", "volpathmis", "prbvolpath")

_SHADOW_INF = 1e30

# Pixel-block edge of the blocked lane ordering.
_BLOCK = 16

# Maximum lanes traced per pass; larger renders loop over spp / row chunks.
MAX_WAVEFRONT = 1 << 21


def texcoords(scene, si):
    """Texture coordinates for the BSDF dispatch: si.uv, or the widened
    [u, v, bary_u, bary_v, prim (, px, py, pz)] (models/texture TC_FULL /
    TC_VOL) when the scene's textured diffuse stack has mesh_attribute or
    volume rows (host facts: `attr` / `vol_grid` are None without them)."""
    st = scene.bsdfs.stacks.get(bsdf_mod.TEXTURED_DIFFUSE)
    if st is None or (st.attr is None and st.vol_grid is None):
        return si.uv
    parts = [si.uv, si.bary, si.prim.to(torch.float32)[..., None]]
    if st.vol_grid is not None:
        parts.append(si.p)
    return torch.cat(parts, -1)


def _bounce(scene, state, sampler, b, max_depth, rr_depth, hide_emitters,
            ad_mode=False):
    """Bounce b of the path tracer over the lanes of `state` = (ray, thr,
    L, active, prev_pdf, prev_delta). Returns (state, (live lanes, shadow
    rays or None)), 0-d tensors of the bounce's own sums. Sampled
    directions, pdfs, MIS weights and the roulette probability are
    detached, as the JAX package stop-grads them; in ad_mode the non-delta
    throughput weight is the detached estimator's (bsdf.bounce_shade).
    The stages are spans: intersect, emitter, shadow, bsdf."""
    ray, thr, L, active, prev_pdf, prev_delta = state
    has_emitters = scene.emitters.n_emitters > 0
    do_nee = has_emitters and scene.config.nee
    # with no transmissive kernel present an NEE sample below the shading
    # horizon has f = 0, so its shadow ray is skipped
    refl_only = not (set(scene.bsdfs.present_kernels) & bsdf_mod.TRANSMISSIVE_KERNELS)
    log.stage("intersect")
    smp = sampler.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS)
    # dead lanes trace with maxt = 0: the cluster kernels return at once
    si = scene.ray_intersect(
        Ray(o=ray.o, d=ray.d, maxt=torch.where(active, ray.maxt, 0.0))
    )
    si = apply_normal_maps(scene.bsdfs, si)
    live = active.sum()

    # ---- emitter hits / escaped rays (MIS against the previous NEE) ----
    log.stage("emitter")
    if has_emitters and (b > 0 or not hide_emitters):
        L = em_mod.hit_term(scene.emitters, scene.geometry, si, ray, L, thr, prev_pdf,
                            prev_delta, active)

    active = active & si.valid

    # final bounce: NEE (b + 2 <= max_depth) and the continuation
    # (b + 1 < max_depth) are both dead, so skip the shading tail
    if b == max_depth - 1:
        return (ray, thr, L, torch.zeros_like(active), prev_pdf, prev_delta), (live, None)

    # ---- NEE direction + fused per-bounce BSDF work ----
    log.stage("bsdf")
    smp_nee = smp.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS + _OFF_NEE)
    u2 = smp.next_2d()
    u_lobe = smp.next_1d()
    nee_vis = shadow_n = None
    if do_nee:
        log.stage("emitter")
        ds, wo_local, nee_ok = em_mod.sample_nee(scene.emitters, scene.geometry, si, si.p,
                                                 smp_nee, active, b + 2 <= max_depth,
                                                 refl_only)
        # shadow ray before shading: occluded lanes skip the tabulated
        # NEE eval (visibility does not depend on f)
        log.stage("shadow")
        shadow = geo.spawn_ray(si, ds.d)
        maxt = torch.where(
            torch.isinf(ds.dist), _SHADOW_INF, ds.dist * (1.0 - 1e-3)
        )
        maxt = torch.where(nee_ok, maxt, 0.0)
        occ = scene.ray_test(Ray(o=shadow.o, d=shadow.d, maxt=maxt))
        shadow_n = nee_ok.sum()
        nee_vis = nee_ok & ~occ
    else:
        wo_local = si.wi

    log.stage("bsdf")
    f_nee, bsdf_pdf_nee, wo, bsdf_pdf, weight, is_delta = bsdf_mod.bounce_shade(
        scene.bsdfs, si.mat_id, si.wi, wo_local, u2, u_lobe, texcoords(scene, si),
        need_attached=ad_mode, has_nee=do_nee, active=active, nee_mask=nee_vis,
    )

    if do_nee:
        log.stage("emitter")
        L = em_mod.nee_term(scene.emitters, ds, bsdf_pdf_nee, nee_vis, L, thr * f_nee)

    # ---- BSDF-sampled continuation ----
    log.stage("bsdf")
    wo = wo.detach()
    bsdf_pdf = bsdf_pdf.detach()
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
        q = torch.clamp(thr.amax(-1), 0.05, 0.95).detach()
        survive = u_rr < q
        thr = torch.where(survive[..., None], thr / q[..., None], thr)
        active = active & survive
    return (ray, thr, L, active, bsdf_pdf, is_delta), (live, shadow_n)


def _bounce_step(ad_mode, body=_bounce):
    """The bounce body a runner calls: `body` in a span "bounce<b>", or in
    ad_mode that under a non-reentrant checkpoint. The backward then runs
    the bounce forward again (path replay: the stateless sampler draws the
    same numbers, the detached intersections find the same hits), so the
    graph of only one bounce is held at a time; the replay's spans nest
    under "backward". The bounce's inputs are kept for that replay: a
    runner must not write them in place later."""
    def spanned(scene, state, sampler, b, *args, **kwargs):
        with log.span(f"bounce{b}"):
            return body(scene, state, sampler, b, *args, **kwargs)

    if not ad_mode:
        return spanned

    def step(*args):
        return checkpoint(spanned, *args, ad_mode=True, use_reentrant=False,
                          preserve_rng_state=False)

    return step


def trace_paths(scene, ray0, sampler, max_depth, rr_depth, hide_emitters,
                ad_mode=False, coherent0=False, compact_caps=None):
    """Per-lane path-traced radiance for primary rays ray0.

    coherent0 takes the JAX package's place and changes nothing there
    either (it skips the first bounce's sort in that package's MERL
    kernel, which the port's K1 does not have). compact_caps: a
    wavefront-compaction fraction schedule (None = off, see
    _run_bounces_compact). Returns (L (N, 3), {"bounces": [(lanes run,
    live lanes, shadow rays or None), ...]}): each bounce's counters, the
    lanes a host fact of the plan, the others 0-d tensors (_bounce).

    Differentiable in the scene's parameters (MERL tables, BSDF fields,
    emitter radiance) with the detached estimator of the reference's `prb`
    integrator: sampled directions, pdfs and MIS weights are detached,
    BSDF and emitter evaluations attached, intersections detached.
    ad_mode=True takes the non-delta throughput weight as eval (attached,
    at the sampled direction held fixed) over the detached pdf, the same
    forward value with the right gradient, and checkpoints each bounce
    (_bounce_step): path-replay backpropagation, with residual memory
    independent of the depth.
    """
    n = ray0.o.shape[0]
    dev = ray0.o.device
    with log.span("camera"):
        state = (
            ray0,
            torch.ones((n, 3), device=dev),
            torch.zeros((n, 3), device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
        )
    if compact_caps is not None:
        return _run_bounces_compact(scene, state, sampler, max_depth, rr_depth, hide_emitters,
                                    compact_caps, ad_mode)
    step = _bounce_step(ad_mode)
    bounces = []
    for b in range(max_depth):
        state, (live, shadow) = step(scene, state, sampler, b, max_depth, rr_depth,
                                     hide_emitters)
        bounces.append((n, live, shadow))
    return state[2], {"bounces": bounces}


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
                         hide_emitters, fracs, ad_mode=False):
    """Bounce loop with per-bounce wavefront compaction.

    Entering bounce b the live lanes are thinned to the capacity caps[b]
    (_compact_caps) by unbiased systematic resampling
    (_systematic_survive), moved to a prefix by one sort, and the bounce
    runs on the prefix only; lanes past it keep their accumulated L. With
    the cluster intersector the sort key is the (direction octant, origin
    Morton cell) of each survivor, so neighbouring threads of K3 and K4
    trace neighbouring rays; otherwise it is the lane order. The sampler's
    own per-lane tensors (its ARRAYS: the lane id, and the independent
    sampler's lane key or the others' pixel / sample index) ride the
    permutation, and each bounce's sampler is the same class rebuilt on
    them (`with_lanes`), so every lane draws what it draws uncompacted. A
    final scatter by lane tag restores film order.
    Returns (L (N, 3), {"bounces": ...}) as trace_paths, a bounce's lanes
    run the lanes it ran on (its cap).

    The ray state lives in full-width tensors. The primal render updates
    them in place on the prefix. In ad_mode every update builds a new
    tensor by concatenation, as the JAX package does: the checkpointed
    bounce keeps views of its inputs for its replay, so no tensor it was
    given may change afterwards. maxt is not carried: after bounce
    0 every spawned ray has maxt = inf. The set-up, each bounce's
    thinning, sort and gathers and its write-back, and the final scatter
    are spans "compact".
    """
    ray, thr, L, active, prev_pdf, prev_delta = state
    n = ray.o.shape[0]
    dev = ray.o.device
    caps = _compact_caps(n, tuple(fracs), max_depth)
    smp_names = sampler.ARRAYS
    spatial = scene.config.intersector == "cluster" and scene.clusters is not None
    with log.span("compact"):
        full = {
            "o": ray.o.clone(), "d": ray.d.clone(), "maxt": ray.maxt.clone(),
            "thr": thr, "L": L, "active": active, "pdf": prev_pdf,
            "delta": prev_delta,
            "tag": torch.arange(n, dtype=torch.int64, device=dev),
        }
        for nm in smp_names:
            full["smp." + nm] = torch.broadcast_to(getattr(sampler, nm), (n,)).clone()
        if spatial:
            root = scene.clusters.root
            s_lo = root[0:3]
            s_span = torch.clamp(root[3:6] - s_lo, min=1e-6)
    cur = n
    bounces = []
    compacted = False
    step = _bounce_step(ad_mode)

    def put(name, new, k):
        """full[name][:k] = new (a tensor or a scalar), out of place in
        ad_mode."""
        if not ad_mode:
            if torch.is_tensor(new):
                full[name][:k] = new
            else:
                full[name][:k].fill_(new)
        else:
            head = new if torch.is_tensor(new) else torch.full_like(full[name][:k], new)
            full[name] = torch.cat([head, full[name][k:]])

    for b in range(max_depth):
        cap = caps[b]
        need_thin = cap < cur
        with log.span(f"bounce{b}"), log.span("compact"):
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
                for name in ("o", "d", "L", "pdf", "delta", "tag") + tuple(
                        "smp." + nm for nm in smp_names):
                    put(name, full[name][:cur][perm], cur)
                put("thr", thr_p[perm], cur)
                put("active", survive[perm], cur)
                put("maxt", float("inf"), cur)
                if need_thin:
                    cur = cap

            smp_b = sampler.with_lanes(**{nm: full["smp." + nm][:cur] for nm in smp_names})
            state_b = (
                Ray(o=full["o"][:cur], d=full["d"][:cur], maxt=full["maxt"][:cur]),
                full["thr"][:cur], full["L"][:cur], full["active"][:cur],
                full["pdf"][:cur], full["delta"][:cur],
            )
        (ray_b, thr_b, L_b, act_b, pdf_b, delta_b), (live, shadow) = step(
            scene, state_b, smp_b, b, max_depth, rr_depth, hide_emitters
        )
        bounces.append((cur, live, shadow))
        with log.span(f"bounce{b}"), log.span("compact"):
            for name, new in (("o", ray_b.o), ("d", ray_b.d), ("maxt", ray_b.maxt),
                              ("thr", thr_b), ("L", L_b), ("active", act_b),
                              ("pdf", pdf_b), ("delta", delta_b)):
                put(name, new, cur)

    with log.span("compact"):
        L = full["L"]
        if compacted:
            # restore film (lane) order: tag is a permutation of [0, n)
            L_out = torch.empty_like(L)
            L_out[full["tag"]] = L
            L = L_out
    return L, {"bounces": bounces}


def _vol_bounce(scene, state, sampler, b, max_depth, rr_depth, hide_emitters,
                ad_mode=False):
    """Bounce b of the volumetric path tracer over the lanes of `state` =
    (ray, thr, L, active, prev_pdf, prev_delta, mid), mid each lane's
    medium (-1: vacuum). Returns (state, rays traced).

    A lane first samples a free flight through its medium up to the
    surface (medium.sample_interaction). A medium event scatters by the
    phase function with NEE and MIS; a surface event shades as the path
    tracer does; a null surface passes the ray on unchanged and switches
    the lane's medium: entering a shape (the ray against its geometric
    normal) picks the shape's interior, leaving returns to vacuum. The
    shadow ray's transmittance integrates the lane's medium up to the
    first boundary the ray meets, which takes one more closest-hit query
    on the main geometry (the shadow geometry's null prims are
    degenerate). As in the JAX package, compaction is not applied. The
    free flight and the transmittance are computed for the lanes whose
    values are read (live lanes, live NEE samples); the JAX package
    computes them for every lane in a medium, and a dead lane's ray, which
    meets no surface, then takes all MAX_TRACKING_STEPS + 1 null steps in
    a heterogeneous medium. Rays traced and stages as _bounce's, with the
    stage medium (tracking, phase sampling, transmittance)."""
    ray, thr, L, active, prev_pdf, prev_delta, mid = state
    log.stage("intersect")
    media = scene.media
    has_emitters = scene.emitters.n_emitters > 0
    do_nee = has_emitters and scene.config.nee
    lane = sampler.lane
    med_seed = (sampler.seed ^ _MED_SEED) & 0xFFFFFFFF
    med_base = b * _MED_STRIDE
    smp = sampler.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS)

    si = scene.ray_intersect(
        Ray(o=ray.o, d=ray.d, maxt=torch.where(active, ray.maxt, 0.0))
    )
    si = apply_normal_maps(scene.bsdfs, si)
    live = active.sum()
    t_surf = torch.where(si.valid, si.t, float("inf"))

    # ---- free flight through the current medium (live lanes only: a
    # dead lane's values are never read, and its ray meets no surface) ----
    log.stage("medium")
    ms = medium_mod.sample_interaction(media, torch.where(active, mid, -1), ray.o, ray.d,
                                       t_surf, med_seed, lane, med_base, ad_mode=ad_mode)
    # emissive media: the collision estimator's emission at real events
    emitted = ms.emitted if ad_mode else ms.emitted.detach()
    L = L + torch.where(active[..., None], thr * emitted, 0.0)
    thr = thr * torch.where(active[..., None], ms.weight if ad_mode else ms.weight.detach(),
                            1.0)
    med_event = active & ms.is_medium
    surf_event = active & ~ms.is_medium
    p_med = ray.o + ms.t[..., None] * ray.d

    mid_safe = mid.clamp(min=0)
    if media.n_media:
        ph_type = media.phase_type[mid_safe]
        ph_g = m.gather_rows(media.phase_g, mid_safe)
        ph_S = None if media.phase_S is None else m.gather_rows(media.phase_S, mid_safe)
    else:
        ph_type, ph_g, ph_S = mid_safe, torch.zeros_like(ray.maxt), None
    wi_world = -ray.d  # back along the ray (the phase convention)

    # ---- emitter hits / escaped rays, for lanes that reach the surface ----
    log.stage("emitter")
    if has_emitters and (b > 0 or not hide_emitters):
        L = em_mod.hit_term(scene.emitters, scene.geometry, si, ray, L, thr, prev_pdf,
                            prev_delta, surf_event)

    active = active & (si.valid | med_event)
    surf_event = surf_event & si.valid
    is_null = scene.bsdfs.mat_type[si.mat_id] == bsdf_mod.NULL
    real_surf = surf_event & ~is_null
    null_surf = surf_event & is_null

    # final bounce: NEE and the continuation are dead
    if b == max_depth - 1:
        return ((ray, thr, L, torch.zeros_like(active), prev_pdf, prev_delta, mid),
                (live, None))

    # ---- NEE direction; the shadow ray before shading ----
    log.stage("bsdf")
    smp_nee = smp.with_dim(CAMERA_DIMS + b * BOUNCE_DIMS + _OFF_NEE)
    u2 = smp.next_2d()
    u_lobe = smp.next_1d()
    nee_vis = shadow_n = None
    if do_nee:
        log.stage("emitter")
        p_ref = torch.where(med_event[..., None], p_med, si.p)
        ds, wo_local, nee_ok = em_mod.sample_nee(scene.emitters, scene.geometry, si, p_ref,
                                                 smp_nee, med_event | real_surf,
                                                 b + 2 <= max_depth, False)
        log.stage("shadow")
        shadow_o = torch.where(med_event[..., None], p_med, geo.spawn_ray(si, ds.d).o)
        maxt = torch.where(torch.isinf(ds.dist), _SHADOW_INF, ds.dist * (1.0 - 1e-3))
        maxt = torch.where(nee_ok, maxt, 0.0)
        shadow = Ray(o=shadow_o, d=ds.d, maxt=maxt)
        nee_vis = nee_ok & ~scene.ray_test(shadow)
    else:
        wo_local = si.wi

    log.stage("bsdf")
    f_surf, pdf_surf, wo_b, bsdf_pdf, weight_b, is_delta_b = bsdf_mod.bounce_shade(
        scene.bsdfs, si.mat_id, si.wi, wo_local, u2, u_lobe, texcoords(scene, si),
        need_attached=ad_mode, has_nee=do_nee, active=real_surf, nee_mask=nee_vis,
    )

    if do_nee:
        log.stage("medium")
        ph_val = phase_mod.eval(ph_type, ph_g, wi_world, ds.d, ph_S)
        f_scat = torch.where(med_event[..., None], ph_val[..., None], f_surf)
        pdf_scat = torch.where(med_event, ph_val, pdf_surf)
        if media.n_media:
            # the medium reaches to the first boundary along the shadow ray
            # (a null surface: anything else occluding failed the test)
            log.stage("shadow")
            si_sh = scene.ray_intersect(shadow)
            tr_dist = torch.where(si_sh.valid, torch.minimum(si_sh.t, maxt), maxt)
            log.stage("medium")
            tr = medium_mod.transmittance(media, torch.where(nee_ok, mid, -1), shadow_o, ds.d,
                                          tr_dist, med_seed, lane, med_base + _MED_SHADOW,
                                          ad_mode=ad_mode)
        else:
            tr = torch.ones_like(thr)
        log.stage("shadow")
        shadow_n = nee_ok.sum()
        log.stage("emitter")
        # the transmittance stays attached in ad_mode: its ratio-tracking
        # factors carry the extinction's gradient
        L = em_mod.nee_term(scene.emitters, ds, pdf_scat, nee_vis, L,
                            thr * f_scat * (tr if ad_mode else tr.detach()))

    # ---- continuation: phase sample | BSDF sample | null pass-through ----
    log.stage("medium")
    wo_b = wo_b.detach()
    bsdf_pdf = bsdf_pdf.detach()
    wo_ph, ph_pdf = phase_mod.sample(ph_type, ph_g, wi_world, u2, ph_S)
    wo_ph, ph_pdf = wo_ph.detach(), ph_pdf.detach()
    log.stage("bsdf")
    d_next = torch.where(med_event[..., None], wo_ph,
                         torch.where(null_surf[..., None], ray.d, si.to_world(wo_b)))
    o_next = torch.where(med_event[..., None], p_med, geo.spawn_ray(si, d_next).o)
    step_w = torch.where((med_event | null_surf)[..., None], 1.0, weight_b)
    thr = thr * torch.where(active[..., None], step_w, 1.0)
    ray = Ray(
        o=torch.where(active[..., None], o_next, ray.o),
        d=torch.where(active[..., None], d_next, ray.d),
        maxt=torch.where(ray.maxt < 0.0, ray.maxt, float("inf")),
    )

    # the medium after a null boundary: the shape's interior entering it,
    # vacuum leaving it
    entering = m.dot(ray.d, si.n) < 0.0
    interior = media.shape_interior[scene.geometry.shape_id[si.prim.clamp(min=0)]]
    mid = torch.where(null_surf, torch.where(entering, interior, -1), mid)

    prev_pdf = torch.where(med_event, ph_pdf, torch.where(null_surf, prev_pdf, bsdf_pdf))
    prev_delta = ~med_event & torch.where(null_surf, prev_delta, is_delta_b)
    ok_surf = (bsdf_pdf > 0.0) & (weight_b > 0.0).any(-1)
    cont = med_event | null_surf | (real_surf & ok_surf)
    active = active & cont & (b + 1 < max_depth) & (thr > 0.0).any(-1)

    # ---- Russian roulette (offset 3) ----
    if b + 1 >= rr_depth:
        u_rr = smp.next_1d()
        q = torch.clamp(thr.amax(-1), 0.05, 0.95).detach()
        survive = u_rr < q
        thr = torch.where(survive[..., None], thr / q[..., None], thr)
        active = active & survive
    return (ray, thr, L, active, prev_pdf, prev_delta, mid), (live, shadow_n)


def trace_volpath(scene, ray0, sampler, max_depth, rr_depth, hide_emitters,
                  ad_mode=False):
    """Volumetric path tracer (mitsuba3 volpath): the path tracer with
    participating media (_vol_bounce). Returns (L (N, 3), {"bounces": ...})
    as trace_paths. As in the JAX package: every lane starts in
    vacuum, leaving any boundary returns to vacuum (no nesting), the shadow
    ray integrates the lane's own medium only, and max_depth bounds every
    event, null crossings included. Gradients as trace_paths (ad_mode:
    each bounce checkpointed, the tracking loops a fixed
    medium.AD_TRACKING_STEPS steps)."""
    n = ray0.o.shape[0]
    dev = ray0.o.device
    with log.span("camera"):
        state = (
            ray0,
            torch.ones((n, 3), device=dev),
            torch.zeros((n, 3), device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.full((n,), -1, dtype=torch.int64, device=dev),
        )
    step = _bounce_step(ad_mode, _vol_bounce)
    bounces = []
    for b in range(max_depth):
        state, (live, shadow) = step(scene, state, sampler, b, max_depth, rr_depth,
                                     hide_emitters)
        bounces.append((n, live, shadow))
    return state[2], {"bounces": bounces}


def _integrator_kind(scene, integrator):
    """The integrator of render / render_lanes: a name or a dict of that
    type, None for the scene's own; an unknown name raises ValueError."""
    kind = integrator.get("type") if isinstance(integrator, dict) else integrator
    kind = kind or scene.config.integrator
    if kind not in INTEGRATOR_TYPES:
        raise ValueError(f"integrator type '{kind}' is not implemented")
    return kind


def _depth(scene, kind, max_depth):
    """The path depth of a render: max_depth or the scene's, at most 2 for
    direct."""
    max_depth = max_depth or scene.config.max_depth
    return min(max_depth, 2) if kind == "direct" else max_depth


def render_lanes(scene, spp, seed, integrator=None, max_depth=None, ad_mode=False,
                 lane_offset=0, n_lanes=None, pixel=None, sample_idx=None,
                 coherent0=False):
    """Trace the lanes (pixel, sample_idx) (int64 tensors), or when they
    are None the contiguous lane range [lane_offset, lane_offset +
    n_lanes) of the frame's pixel-major lanes (lane = pixel * spp +
    sample; n_lanes None: to the frame's end), the JAX package's
    sharding hook (the port's parallel/mesh.py renders a rank's rows
    through render_rows, in render's lane order, instead). Returns (L (N,
    C), film_xy (N, 2), stats): C = 3,
    or 6 for `moment` ([L, L^2]); stats {"rays_per_bounce": (bounces,)
    float64, each bounce's live lanes and shadow rays}. `spp` is the frame's total spp. The
    arguments are the JAX package's, in its order; coherent0 changes
    nothing (see trace_paths).

    The integrator dispatch is the JAX package's: path (prb and prb_basic
    render as path); direct is path at max_depth <= 2; depth, aov /
    aov_normals, aov_position and aov_uv read the camera ray's hit (t,
    the shading normal * 0.5 + 0.5, the position, (u, v, 0); 0 on a
    miss); moment traces path without compaction and returns L and L^2;
    volpath, volpathmis and prbvolpath, and any other of these on a scene
    with media, trace the volumetric tracer (no compaction). ptracer and
    bdpt trace light paths in `render`; here, as in the JAX package, their
    lanes trace the path (or volumetric) tracer.
    """
    kind = _integrator_kind(scene, integrator)
    cfg = scene.config
    h, w = cfg.height, cfg.width
    if pixel is None:
        n = h * w * spp - lane_offset if n_lanes is None else n_lanes
        lanes = torch.arange(lane_offset, lane_offset + n, dtype=torch.int64,
                             device=scene.device)
        pixel, sample_idx = lanes // spp, lanes % spp
    wh = torch.tensor([w, h], dtype=torch.float32, device=pixel.device)
    L, film_xy, stats = _trace_lanes(scene, spp, seed, kind, _depth(scene, kind, max_depth),
                                     ad_mode, pixel, sample_idx,
                                     sensor_mod.types_present(scene.sensor), wh)
    rays = [live if shadow is None else live + shadow for _, live, shadow in stats["bounces"]]
    return L, film_xy, {"rays_per_bounce": torch.stack(
        [torch.as_tensor(r, device=scene.device) for r in rays]).to(torch.float64)}


def rays_traced(counters):
    """The rays that bounce counters (rows_body's) count: every bounce's
    live lanes and shadow rays, a float (it waits for the device)."""
    return float(sum(live if shadow is None else live + shadow
                     for _, live, shadow in counters))


def _trace_lanes(scene, spp, seed, kind, max_depth, ad_mode, pixel, sample_idx, present,
                 wh):
    """render_lanes on resolved host facts: the integrator `kind`, the
    path depth, the sensor's types `present` and the film size `wh` as a
    (2,) float32 tensor on the lanes' device. Device work only (a seed
    tensor keeps the sampler off the host too), so a captured frame's body
    runs it as it is. The camera rays are the span "camera"."""
    cfg = scene.config
    h, w = cfg.height, cfg.width
    with log.span("camera"):
        smp = make_sampler(cfg.sampler, seed, pixel, sample_idx, spp)
        jitter = smp.next_2d()
        # dims 2-3: the aperture, drawn only for a thin lens (each bounce
        # repositions the sampler with with_dim, so no other draw moves)
        aperture = smp.next_2d() if sensor_mod.THINLENS in present else None
        px = (pixel % w).to(torch.float32)
        py = (pixel // w).to(torch.float32)
        film_xy = torch.stack([px, py], -1) + jitter
        film_uv = film_xy / wh
        ray0 = sensor_mod.sample_ray(scene.sensor, film_uv, aperture, w / h, present=present)

    if kind in ("depth", "aov", "aov_normals", "aov_position", "aov_uv"):
        si = scene.ray_intersect(ray0)
        if kind == "depth":
            L = torch.where(si.valid, si.t, 0.0)[..., None].expand(-1, 3)
        elif kind == "aov_position":
            L = si.p
        elif kind == "aov_uv":
            L = torch.cat([si.uv, torch.zeros_like(si.uv[..., :1])], -1)
        else:  # the shading normal
            L = apply_normal_maps(scene.bsdfs, si).frame.n * 0.5 + 0.5
        L = torch.where(si.valid[..., None], L, 0.0)
        n = pixel.shape[0]
        return L, film_xy, {"bounces": [(n, n, None)]}  # the camera rays, all live
    if kind != "moment" and (kind in _VOL_TYPES or scene.media.n_media > 0):
        L, stats = trace_volpath(scene, ray0, smp, max_depth, cfg.rr_depth,
                                 cfg.hide_emitters, ad_mode=ad_mode)
        return L, film_xy, stats
    L, stats = trace_paths(
        scene, ray0, smp, max_depth, cfg.rr_depth, cfg.hide_emitters,
        ad_mode=ad_mode, compact_caps=None if kind == "moment" else cfg.compact,
    )
    if kind == "moment":
        L = torch.cat([L, L * L], -1)
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


class RowsPlan(NamedTuple):
    """The host facts of render_rows' passes over the frame's rows [row0,
    row0 + n_rows): the integrator kind and path depth, spp, `rows` rows
    and `chunk` samples of each a pass (n_row_pass x n_spp_pass passes),
    whether a pass orders its pixels in 16x16 blocks, whether the box
    filter develops the rows (else they splat with `halo` rows each side)
    and the sensor's types. Hashable: a captured frame's key holds it."""

    kind: str
    max_depth: int
    spp: int
    row0: int
    n_rows: int
    halo: int
    rows: int
    chunk: int
    blocked: bool
    box: bool
    present: frozenset

    @property
    def n_spp_pass(self):
        return self.spp // self.chunk

    @property
    def n_row_pass(self):
        return self.n_rows // self.rows


def plan_rows(scene, spp, integrator, max_depth, row0, n_rows, halo=0):
    """render_rows' RowsPlan: host work only (the sensor's types are read
    from its type tensor)."""
    cfg = scene.config
    kind = _integrator_kind(scene, integrator)
    w = cfg.width
    rows = _chunk_rows(n_rows, w)
    chunk = _chunk_spp(rows * w, spp)
    blocked = rows % _BLOCK == 0 and w % _BLOCK == 0 and rows * w * chunk >= _BLOCK
    return RowsPlan(kind, _depth(scene, kind, max_depth), spp, row0, n_rows, halo, rows,
                    chunk, blocked, cfg.rfilter == "box",
                    frozenset(sensor_mod.types_present(scene.sensor)))


def rows_inputs(scene, plan):
    """The tensors a plan's passes read besides the scene: the first pass's
    pixels and the sample indices of a pass (lane order: pixel-major,
    blocked or row-major), and the film size (W, H) as float32."""
    cfg = scene.config
    dev = scene.device
    w, rows, chunk = cfg.width, plan.rows, plan.chunk
    if plan.blocked:
        order = np.arange(rows * w, dtype=np.int64).reshape(
            rows // _BLOCK, _BLOCK, w // _BLOCK, _BLOCK
        ).transpose(0, 2, 1, 3).reshape(-1)
    else:
        order = np.arange(rows * w, dtype=np.int64)
    pixel0 = torch.as_tensor(order, device=dev).repeat_interleave(chunk) + plan.row0 * w
    sidx_local = torch.arange(chunk, dtype=torch.int64, device=dev).repeat(rows * w)
    wh = torch.tensor([w, cfg.height], dtype=torch.float32, device=dev)
    return pixel0, sidx_local, wh


def rows_body(scene, plan, inputs, seed, ad_mode):
    """The passes of a plan on its inputs: device work only, so a captured
    frame records it as it is (seed: a Python int, or a 0-d int64 tensor
    on the scene's device). Returns render_rows' (out, counters). Spans:
    camera (each pass's lanes and camera rays), bounce<b> (the bounces'
    stages and compaction), film (splat or develop)."""
    cfg = scene.config
    h, w = cfg.height, cfg.width
    pixel0, sidx_local, wh = inputs
    rows, chunk, n_spp_pass = plan.rows, plan.chunk, plan.n_spp_pass
    slabs = [None] * plan.n_row_pass
    img = wsum = None
    counters = []
    for p in range(n_spp_pass * plan.n_row_pass):
        row_pass, spp_pass = p // n_spp_pass, p % n_spp_pass
        with log.span("camera"):
            pixel = pixel0 + row_pass * rows * w
            sample_idx = sidx_local + spp_pass * chunk
        L, film_xy, stats = _trace_lanes(scene, plan.spp, seed, plan.kind, plan.max_depth,
                                         ad_mode, pixel, sample_idx, plan.present, wh)
        counters += stats["bounces"]
        with log.span("film"):
            if not plan.box:
                part, wpart = film_mod.splat_slab(L, film_xy, plan.row0 - plan.halo,
                                                  plan.n_rows + 2 * plan.halo, h, w,
                                                  film_mod.FILTER_NAMES[cfg.rfilter])
                img = part if img is None else img + part
                wsum = wpart if wsum is None else wsum + wpart
                continue
            if plan.blocked:
                slab = film_mod.develop_box_blocked(L, rows, w, chunk, _BLOCK)
            else:
                slab = film_mod.develop_box(L, rows, w, chunk)
            prev = slabs[row_pass]
            slabs[row_pass] = slab if prev is None else prev + slab
    with log.span("film"):
        return (torch.cat(slabs) / n_spp_pass if plan.box else (img, wsum)), counters


def render_rows(scene, spp, seed, integrator, max_depth, ad_mode, row0, n_rows, halo=0):
    """The frame's rows [row0, row0 + n_rows) in (row slab, spp slice)
    passes of at most MAX_WAVEFRONT lanes, the pixels of a slab in 16x16
    blocks when it tiles evenly (row-major otherwise). Returns (out,
    counters): counters are every pass's bounces' (lanes run, live lanes,
    shadow rays or None) in order (trace_paths; rays_traced sums them);
    under the box filter out is the rows' (n_rows, W, C)
    image (each pixel's lanes averaged; the slabs summed out of place over
    the spp passes, which autograd keeps); under any other filter out is
    (img (n_rows + 2 halo, W, C), wsum (n_rows + 2 halo, W)), every pass's
    samples splatted into the film rows [row0 - halo, row0 + n_rows +
    halo). `render` takes all rows (halo 0); a sharded render
    (parallel/mesh.py) a rank's slab with HALO rows on each side. The
    plan (plan_rows, host facts), its inputs (rows_inputs) and the passes
    (rows_body, device work) are the steps a captured frame takes apart."""
    plan = plan_rows(scene, spp, integrator, max_depth, row0, n_rows, halo)
    return rows_body(scene, plan, rows_inputs(scene, plan), seed, ad_mode)


def develop(cfg, out):
    """render_rows' out over all rows -> the image: a splat divided by its
    weights, times cfg.sensor_scale (the span "film")."""
    with log.span("film"):
        if cfg.rfilter != "box":
            out = out[0] / torch.clamp(out[1], min=1e-12)[..., None]
        if cfg.sensor_scale != 1.0:
            out = out * cfg.sensor_scale  # measurement sensors (W/m^2)
        return out


def render(scene, spp=None, seed=0, integrator=None, max_depth=None,
           ad_mode=False, return_stats=False):
    """Full pipeline to an (H, W, C) image (C = 6 for moment, else 3), with
    the JAX package's arguments in its order.

    Renders in (row slab, spp slice) passes of at most MAX_WAVEFRONT lanes.
    The box filter averages each pixel's lanes; any other filter
    (cfg.rfilter) splats every pass's samples at their film positions into
    the full film, and the summed image is divided by the summed weights.
    The result is multiplied by cfg.sensor_scale (pi for an
    irradiancemeter). integrator: as render_lanes (None: the scene's own).
    return_stats=True also returns {"rays_traced": total rays including
    shadow rays}. ad_mode: see trace_paths (render/ad.render_ad is the
    differentiable entry). ptracer and bdpt (which ignore ad_mode) are
    rendered by render/ptracer.render_ptracer and render/bdpt.render_bdpt.
    render_jit is this frame captured, for every integrator.
    """
    kind = _integrator_kind(scene, integrator)
    cfg = scene.config
    spp = spp or cfg.spp
    if kind == "ptracer":
        from mitsuba_customization_tpu_torch.render.ptracer import render_ptracer

        return render_ptracer(scene, spp, seed, max_depth, return_stats)
    if kind == "bdpt":
        from mitsuba_customization_tpu_torch.render.bdpt import render_bdpt

        return render_bdpt(scene, spp, seed, max_depth, return_stats)
    out, counters = render_rows(scene, spp, seed, integrator, max_depth, ad_mode, 0,
                                cfg.height)
    out = develop(cfg, out)
    if return_stats:
        return out, {"rays_traced": rays_traced(counters)}
    return out


TRACERS = ("ptracer", "bdpt")


def tracer(kind):
    """The module of a light tracer (`kind` in TRACERS), with its `plan`
    (host facts) and `body` (device work): render/ptracer.py or
    render/bdpt.py (imported here: bdpt imports this module)."""
    if kind == "ptracer":
        from mitsuba_customization_tpu_torch.render import ptracer

        return ptracer
    from mitsuba_customization_tpu_torch.render import bdpt

    return bdpt


def render_jit(scene, spp=None, seed=0, integrator=None, max_depth=None):
    """`render` as one captured frame, the JAX package's render_jit (its
    arguments, in its order; no ad_mode, no return_stats), for every
    integrator.

    The frame is planned on the host (plan_rows and rows_inputs, or a
    light tracer's plan) and its body is device work only: the passes and
    develop (rows_body), or the tracer's body, with the seed in a buffer
    of the frame (render/frame_graph.py). The loops that run to a
    condition per lane are kernels that check nothing on the host (the
    media's tracking T1 / T2, the SDF march S1, the BVH walks B1 / B2). On
    the card the body is captured once into a CUDA graph for each (scene,
    its config and tensors, spp, integrator, depth) and replayed, the seed
    written into its buffer first; a capture that fails raises. On the
    CPU the body runs as it is. The image is render's bit for bit (a
    splat's atomic adds on the card aside: a splat filter, the light
    tracers' camera connections), and a fresh tensor at every call. Host
    spans: frame.call, and inside it frame.plan and the frame's own."""
    with log.span("frame.call"):
        kind = _integrator_kind(scene, integrator)
        cfg = scene.config
        spp = int(spp or cfg.spp)
        with log.span("frame.plan"):
            plan = (tracer(kind).plan(scene, spp, max_depth) if kind in TRACERS
                    else plan_rows(scene, spp, kind, max_depth, 0, cfg.height))
        if kind in TRACERS:
            return captured_tracer(scene, plan, seed)
        return captured_rows(scene, plan, seed, True)


def captured_rows(scene, plan, seed, whole_image):
    """rows_body's out of `plan` at `seed` as a captured frame
    (render/frame_graph.py; its inputs made on the frame's first call),
    developed into the image (`develop`) when whole_image."""
    def make():
        inputs = rows_inputs(scene, plan)

        def body(seed_t):
            out, counters = rows_body(scene, plan, inputs, seed_t, False)
            return (develop(scene.config, out) if whole_image else out), counters

        return {"body": body, "keep": inputs}

    return frame_graph.frame((plan, whole_image), scene, make)(seed)


def captured_tracer(scene, plan, seed):
    """A light tracer's image of `plan` (its TracerPlan) at `seed` as a
    captured frame."""
    body = tracer(plan.kind).body
    return frame_graph.frame(plan, scene, lambda: {
        "body": lambda seed_t: (body(scene, plan, seed_t)[0], None), "keep": None})(seed)
