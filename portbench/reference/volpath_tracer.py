"""Plain PyTorch reference of the port's volumetric path integrator
(`volpath`), for the benchmark's check of what a timed step produced.

The scenes of path_tracer.py plus participating media bounded by
null-material shapes: homogeneous media sampled in closed form (a channel
drawn uniformly, its pdf the channels' mean), heterogeneous ones on a
trilinear density grid by weighted delta tracking, with ratio tracking for
a shadow ray's transmittance under the channel-mean majorant; isotropic or
Henyey-Greenstein phase functions. A path starts in vacuum, a null
boundary switches the lane's medium (entering: the shape's interior;
leaving: vacuum), a shadow ray's transmittance covers its own medium up to
the first boundary it meets. The free flights draw from their own hash
stream (a seed of their own, a dimension base a bounce). Differentiable
the way the program's estimator is (its detached sampling decisions): in
ad_mode the tracking runs a fixed AD_STEPS-step masked scan, as the
program's gradient estimator does. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import path_tracer as pt

MED_SEED, MED_STRIDE, MED_SHADOW = 0x6D656469, 4096, 2048
MAX_STEPS, AD_STEPS = 256, 48
ISOTROPIC, HG = 0, 1
HOMOGENEOUS, HETEROGENEOUS = 0, 1
INV_FOURPI = 1.0 / (4.0 * math.pi)


class _Sink(torch.autograd.Function):
    """grid -> a 0-d token whose backward returns, as the grid's gradient,
    the one buffer every density gather of the backward pass added into
    (a dense gradient a gather would cost a grid's size each)."""

    @staticmethod
    def forward(ctx, grid, buf):
        ctx.buf, ctx.shape = buf, grid.shape
        return grid.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        grad = ctx.buf.pop().reshape(ctx.shape) if ctx.buf else None
        return grad, None


class _Gather(torch.autograd.Function):
    """flat[idx], its gradient index-added into the sink's buffer."""

    @staticmethod
    def forward(ctx, token, flat, idx, buf, numel):
        ctx.save_for_backward(idx)
        ctx.buf, ctx.numel = buf, numel
        return flat.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.buf:
            ctx.buf.append(g.new_zeros(ctx.numel))
        ctx.buf[0].index_add_(0, idx, g)
        return g.new_zeros(()), None, None, None, None


class Media:
    """The scene's media (in the order of the shapes that bound them) as
    tensors: type, sigma_t, albedo, phase type and g, the density grids
    zero-padded into one (K, D, H, W) stack with each medium's slot, dims
    and world -> grid map, and the majorant of the channel-mean extinction.
    params: the differentiable values ({key: tensor}, the program's
    keys), or the dicts' own."""

    def __init__(self, rows, device, dtype, params):
        k = len(rows)
        f32 = np.float32
        self.m_type = torch.tensor([HETEROGENEOUS if r.get("type") == "heterogeneous"
                                    else HOMOGENEOUS for r in rows], device=device)

        def rgb(r, key, default):
            val = r.get(key, default)
            val = val.get("value", default) if isinstance(val, dict) else val
            val = np.asarray(val, f32)
            return np.full(3, val, f32) if val.ndim == 0 else val

        own = {"sigma_t": np.stack([rgb(r, "sigma_t", [1, 1, 1]) * f32(r.get("scale", 1.0))
                                    for r in rows]),
               "albedo": np.stack([rgb(r, "albedo", [0.75] * 3) for r in rows]),
               "phase_g": np.asarray([float(r.get("phase", {}).get("g", 0.0)) for r in rows],
                                     f32)}
        self.phase_type = torch.tensor([HG if r.get("phase", {}).get("type") == "hg"
                                        else ISOTROPIC for r in rows], device=device)
        grids, slot, dims, w2g = [], np.zeros(k, np.int64), np.ones((k, 3), np.int64), \
            np.zeros((k, 3, 4), f32)
        for i, r in enumerate(rows):
            if r.get("type") != "heterogeneous":
                continue
            dens = r["density"]
            to_w = pt._transform(dens.get("to_world")) if isinstance(dens, dict) else \
                pt._transform(r.get("to_world"))
            g = np.asarray(dens["grid"] if isinstance(dens, dict) else dens, f32)
            slot[i], dims[i] = len(grids), g.shape
            grids.append(g)
            inv = np.linalg.inv(np.asarray(to_w, np.float64))
            perm = np.asarray([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float64)
            w2g[i, :, :3] = (perm @ inv[:3, :3]).astype(f32)
            w2g[i, :, 3] = (perm @ inv[:3, 3]).astype(f32)
        shape = tuple(np.max([g.shape for g in grids], 0)) if grids else (1, 1, 1)
        stack = np.zeros((max(len(grids), 1),) + shape, f32)
        for i, g in enumerate(grids):
            stack[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g
        own["grid"] = stack

        def val(key, field):
            if key in params:
                return params[key]
            return torch.as_tensor(own[field], device=device).to(dtype)

        self.sigma_t, self.albedo = val("medium.sigma_t", "sigma_t"), val("medium.albedo",
                                                                         "albedo")
        self.phase_g, self.grid = val("medium.phase_g", "phase_g"), val("medium.density",
                                                                       "grid")
        self.slot = torch.as_tensor(slot, device=device)
        self.dims = torch.as_tensor(dims, device=device)
        self.w2g = torch.as_tensor(w2g, device=device).to(dtype)
        with torch.no_grad():
            mean_sig = self.sigma_t.detach().mean(-1)
            gmax = self.grid.detach().reshape(self.grid.shape[0], -1).amax(-1)
            self.majorant = torch.where(self.m_type == HETEROGENEOUS,
                                        mean_sig * gmax[self.slot], mean_sig)
        self.new_pass()

    def new_pass(self):
        """A fresh entry of the grid into autograd for one backward pass."""
        self.buf = []
        self.token = (_Sink.apply(self.grid, self.buf)
                      if self.grid.requires_grad and torch.is_grad_enabled() else None)

    def density(self, mid, p):
        """Trilinear density at world p (N, 3) of lanes in media mid (>= 0):
        1 in a homogeneous medium, 0 outside a grid."""
        w2g = self.w2g[mid]
        dims = self.dims[mid]
        slot = self.slot[mid]
        het = self.m_type[mid] == HETEROGENEOUS
        g = (w2g[..., 0] * p[..., 0:1] + w2g[..., 1] * p[..., 1:2]
             + w2g[..., 2] * p[..., 2:3]) + w2g[..., 3]
        f = torch.clamp(g, 0.0, 1.0) * (dims.to(g.dtype) - 1.0)
        i0 = torch.minimum(torch.clamp(torch.floor(f).long(), min=0),
                           torch.clamp(dims - 2, min=0))
        t = f - i0
        i1 = torch.minimum(i0 + 1, dims - 1)
        _, gd, gh, gw = self.grid.shape
        zs = torch.stack([i0[:, 0], i1[:, 0]], -1)
        ys = torch.stack([i0[:, 1], i1[:, 1]], -1)
        xs = torch.stack([i0[:, 2], i1[:, 2]], -1)
        idx = (((slot[:, None, None, None] * gd + zs[:, :, None, None]) * gh
                + ys[:, None, :, None]) * gw + xs[:, None, None, :]).reshape(-1)
        flat = self.grid.reshape(-1)
        if self.token is not None:
            vals = _Gather.apply(self.token, flat.detach(), idx, self.buf, flat.numel())
        else:
            vals = flat.index_select(0, idx)
        c = vals.reshape(-1, 2, 2, 2)
        tz, ty, tx = t[:, 0], t[:, 1], t[:, 2]

        def lerp(a, b, s):
            return a * (1.0 - s) + b * s

        c00, c01 = lerp(c[:, 0, 0, 0], c[:, 0, 0, 1], tx), lerp(c[:, 0, 1, 0], c[:, 0, 1, 1], tx)
        c10, c11 = lerp(c[:, 1, 0, 0], c[:, 1, 0, 1], tx), lerp(c[:, 1, 1, 0], c[:, 1, 1, 1], tx)
        dens = lerp(lerp(c00, c01, ty), lerp(c10, c11, ty), tz)
        inside = ((g >= 0.0) & (g <= 1.0)).all(-1)
        return torch.where(het & inside, dens, torch.where(het, 0.0, 1.0).to(dens.dtype))


def _draw(key, dim, dtype):
    bits = pt._hash_combine(key, torch.full_like(key, dim & pt.MASK32))
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


def _free_step(u):
    return -torch.log1p(-torch.clamp(u, 0.0, 1.0 - 1e-7))


def _channel_mean(x):
    return (x[:, 0] + x[:, 1] + x[:, 2]) / x.new_full((), 3.0)


def _track(media, kind, mid, o, d, t_max, key, dim_base, steps):
    """Weighted delta tracking ("delta": (t, weight, scattered)) or ratio
    tracking ("ratio": weight) of lanes in heterogeneous media over
    [0, t_max], `steps` steps at most; lanes elsewhere come back done (t 0,
    weight 1)."""
    n, dt = o.shape[0], o.dtype
    safe = mid.clamp(min=0)
    need = (mid >= 0) & (media.m_type[safe] == HETEROGENEOUS)
    t = torch.zeros(n, dtype=dt, device=o.device)
    w = torch.ones((n, 3), dtype=dt, device=o.device)
    scat = torch.zeros(n, dtype=torch.bool, device=o.device)
    idx = need.nonzero().squeeze(1)
    if idx.numel() == 0:
        return (t, w, scat) if kind == "delta" else w
    o, d, tm, ky, sm = o[idx], d[idx], t_max[idx], key[idx], safe[idx]
    sg = media.sigma_t[sm]
    mj = torch.clamp(media.majorant[sm], min=1e-20).detach()
    ts, ws = t[idx], w[idx]
    sc = scat[idx]
    done = torch.zeros_like(sc)
    for step in range(steps):
        if kind == "delta":
            u1 = _draw(ky, dim_base + 2 + step * 2, dt)
            u2 = _draw(ky, dim_base + 3 + step * 2, dt)
        else:
            u1 = _draw(ky, dim_base + step, dt)
        t_new = ts + _free_step(u1) / mj
        passed = t_new >= tm
        dens = media.density(sm, o + t_new[:, None] * d)
        sig_p = sg * dens[:, None]
        if kind == "delta":
            mean_sig = _channel_mean(sig_p)
            p_real = torch.clamp(mean_sig / mj, 0.0, 1.0).detach()
            real = u2 < p_real
            w_real = pt._safe_div(sig_p, mean_sig.detach()[:, None])
            w_null = pt._safe_div(mj[:, None] - sig_p, (mj * (1.0 - p_real)).detach()[:, None])
            upd = ~done
            moved = upd & ~passed
            ts = torch.where(upd, torch.where(passed, tm, t_new), ts)
            ws = torch.where(moved[:, None], ws * torch.where(real[:, None], w_real, w_null),
                             ws)
            sc = sc | (moved & real)
            done = done | passed | sc | (step >= MAX_STEPS)
        else:
            upd = ~done & ~passed
            ws = torch.where(upd[:, None], ws * torch.clamp(1.0 - sig_p / mj[:, None], 0.0, 1.0),
                             ws)
            ts = torch.where(done, ts, t_new)
            done = done | passed | (step >= MAX_STEPS)
        if steps > AD_STEPS and not bool((~done).any()):
            break
    w = w.index_put((idx,), ws)
    if kind == "ratio":
        return w
    return t.index_put((idx,), ts), w, scat.index_put((idx,), sc)


def sample_interaction(media, mid, o, d, t_max, seed, lane, dim_base, steps):
    """(is_medium, t, weight, emitted) of a free flight of lanes in media
    mid (-1: vacuum, weight 1) up to t_max."""
    n, dt = o.shape[0], o.dtype
    in_med = mid >= 0
    safe = mid.clamp(min=0)
    het = media.m_type[safe] == HETEROGENEOUS
    sig, alb = media.sigma_t[safe], media.albedo[safe]
    key = pt._hash_combine(torch.full_like(lane, seed & pt.MASK32), lane)
    u_ch, u_t = _draw(key, dim_base, dt), _draw(key, dim_base + 1, dt)
    ch = torch.clamp((u_ch * 3).long(), max=2)
    sig_ch = torch.gather(sig, 1, ch[:, None]).squeeze(1)
    t_hom = (_free_step(u_t) / torch.clamp(sig_ch, min=1e-20)).detach()
    scat_hom = t_hom < t_max
    tr_t = torch.exp(-sig * torch.minimum(t_hom, t_max)[:, None])
    pdf_scat = (sig * tr_t).mean(-1).detach()
    pdf_pass = tr_t.mean(-1).detach()
    base = pt._safe_div(tr_t * sig, pdf_scat[:, None])
    w_hom = torch.where(scat_hom[:, None], base * alb, pt._safe_div(tr_t, pdf_pass[:, None]))
    t_het, w_het, scat_het = _track(media, "delta", mid, o, d, t_max, key, dim_base, steps)
    w_het = torch.where(scat_het[:, None], w_het * alb, w_het)
    is_med = in_med & torch.where(het, scat_het, scat_hom)
    t_s = torch.where(het, t_het, t_hom)
    weight = torch.where(in_med[:, None], torch.where(het[:, None], w_het, w_hom), 1.0)
    return is_med, t_s, weight


def transmittance(media, mid, o, d, dist, seed, lane, dim_base, steps):
    """(N, 3) transmittance of lanes in media mid over [0, dist]."""
    in_med = mid >= 0
    safe = mid.clamp(min=0)
    het = media.m_type[safe] == HETEROGENEOUS
    d_fin = torch.where(torch.isfinite(dist), dist, 1e7)
    tr_hom = torch.exp(-media.sigma_t[safe] * d_fin[:, None])
    key = pt._hash_combine(torch.full_like(lane, seed & pt.MASK32), lane)
    tr_het = _track(media, "ratio", mid, o, d, d_fin, key, dim_base, steps)
    return torch.where(in_med[:, None], torch.where(het[:, None], tr_het, tr_hom), 1.0)


def _hg_eval(g, wi, wo):
    cos_t = -pt._dot(wi, wo)
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_t
    return INV_FOURPI * (1.0 - g2) / torch.clamp(denom * torch.sqrt(torch.clamp(denom, min=0.0)),
                                                 min=1e-12)


def phase_eval(ptype, g, wi, wo):
    return torch.where(ptype == HG, _hg_eval(g, wi, wo),
                       torch.full_like(g, INV_FOURPI))


def phase_sample(ptype, g, wi, u):
    """(wo, pdf) of the phase functions: uniform sphere, or HG by its
    inverse CDF about the propagation direction -wi."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    wo_iso = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    u1 = u[..., 0]
    small = g.abs() < 1e-4
    gs = torch.where(small, 1e-4, g)
    sqr = (1.0 - gs * gs) / (1.0 - gs + 2.0 * gs * u1)
    cos_t = torch.clamp(torch.where(small, 1.0 - 2.0 * u1, (1.0 + gs * gs - sqr * sqr) / (2.0 * gs)),
                        -1.0, 1.0)
    fwd = -wi
    s, t = pt._basis(fwd)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    wo_hg = pt._normalize((sin_t * torch.cos(phi))[..., None] * s
                          + (sin_t * torch.sin(phi))[..., None] * t + cos_t[..., None] * fwd)
    is_hg = ptype == HG
    wo = torch.where(is_hg[..., None], wo_hg, wo_iso)
    pdf = torch.where(is_hg, _hg_eval(g, wi, wo_hg), torch.full_like(g, INV_FOURPI))
    return wo, pdf


def trace(scene, seed, pixel, sample, ad_mode=False):
    """Per-lane radiance (N, 3) of lanes (pixel, sample index) under the
    volumetric integrator; `scene` a path_tracer.Scene with `media` set
    (Media). ad_mode: the tracking's fixed AD_STEPS-step scan."""
    dt, dev = scene.dtype, scene.device
    media = scene.vol
    steps = AD_STEPS if ad_mode else MAX_STEPS + 1
    w, h, spp = scene.width, scene.height, scene.spp
    lane = (pixel * spp + sample) & pt.MASK32
    rng = pt._Uniforms(seed, lane, dt)
    med_seed = (int(seed) ^ MED_SEED) & pt.MASK32
    n = lane.shape[0]
    jitter = torch.stack([rng.draw(0), rng.draw(1)], -1)
    film = torch.stack([(pixel % w).to(dt), (pixel // w).to(dt)], -1) + jitter
    uv = film / torch.tensor([w, h], dtype=torch.float32, device=dev).to(dt)
    x = (2.0 * uv[:, 0] - 1.0) * scene.tan_half
    y = (1.0 - 2.0 * uv[:, 1]) * scene.tan_half / (w / h)
    d_cam = pt._normalize(torch.stack([x, y, torch.ones_like(x)], -1))
    rot = scene.cam_rot
    d = pt._normalize(d_cam[:, 0:1] * rot[:, 0] + d_cam[:, 1:2] * rot[:, 1]
                      + d_cam[:, 2:3] * rot[:, 2])
    o = scene.cam_pos + d * scene.near_clip
    maxt = torch.full((n,), float("inf"), dtype=dt, device=dev)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, dtype=dt, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    mid = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sky = torch.as_tensor(scene.sky, device=dev).to(dt)
    depth = scene.max_depth
    for b in range(depth):
        base = pt.CAMERA_DIMS + b * pt.BOUNCE_DIMS
        med_base = b * MED_STRIDE
        t, prim, u, v = pt._hits(scene, o, d, torch.where(active, maxt, 0.0), False)
        hit = pt._Hit(scene, o, d, t, prim, u, v)
        t_surf = torch.where(hit.valid, hit.t, float("inf"))
        is_med, t_m, m_w = sample_interaction(media, torch.where(active, mid, -1), o, d, t_surf,
                                              med_seed, lane, med_base, steps)
        thr = thr * torch.where(active[..., None], m_w, 1.0)
        med_event = active & is_med
        surf_event = active & ~is_med
        p_med = o + t_m[..., None] * d
        mid_safe = mid.clamp(min=0)
        ph_type = media.phase_type[mid_safe]
        ph_g = media.phase_g[mid_safe]
        wi_world = -d
        # emitted radiance reached by the lanes that reach the surface
        row = scene.prim_light_row[hit.prim.clamp(min=0)].clamp(min=0)
        on_light = hit.valid & (hit.emitter >= 0)
        front = pt._dot(hit.n, hit.to_world(hit.wi)) > 0.0
        rad = torch.where((on_light & front)[..., None], scene.light_radiance, 0.0)
        rad = torch.where(hit.valid[..., None], rad, sky)
        to_x = hit.p - o
        dist2 = (to_x * to_x).sum(-1)
        cos_e = pt._dot(hit.n, -(to_x * torch.rsqrt(torch.clamp(dist2, min=1e-14))[..., None]))
        pdf_hit = pt._safe_div(scene.light_pmf[row] / torch.clamp(scene.light_area[row],
                                                                   min=1e-12) * dist2, cos_e)
        em_pdf = torch.where(on_light & (cos_e > 0.0), pdf_hit, 0.0)
        w_mis = torch.where(prev_delta, 1.0, pt._mis(prev_pdf, em_pdf)).to(dt).detach()
        L = L + torch.where(surf_event[..., None], thr * rad * w_mis[..., None], 0.0)
        active = active & (hit.valid | med_event)
        surf_event = surf_event & hit.valid
        is_null = scene.mat_kind[hit.mat] == pt.NULL
        real_surf = surf_event & ~is_null
        null_surf = surf_event & is_null
        if b == depth - 1:
            break
        u2 = torch.stack([rng.draw(base), rng.draw(base + 1)], -1)
        u_lobe = rng.draw(base + 2)
        u3 = [rng.draw(base + pt.OFF_NEE + i) for i in range(3)]
        p_ref = torch.where(med_event[..., None], p_med, hit.p)
        q = pt._invert_cdf(scene.light_cdf.expand(n, -1),
                           torch.clamp(u3[0], max=1.0 - 1e-7))[0]
        prim_q = scene.light_prims[q]
        e1, e2 = scene.prims["e1"][prim_q], scene.prims["e2"][prim_q]
        su = torch.sqrt(torch.clamp(1.0 - u3[1], min=0.0))
        pos = (scene.prims["p0"][prim_q] + (1.0 - su)[..., None] * e1
               + (su * u3[2])[..., None] * e2)
        n_e = pt._normalize(pt._cross(e1, e2))
        to_l = pos - p_ref
        ldist2 = (to_l * to_l).sum(-1)
        ldist = torch.sqrt(torch.clamp(ldist2, min=1e-12))
        ld = to_l / ldist[..., None]
        cos_l = pt._dot(n_e, -ld)
        lfront = cos_l > 0.0
        p_area = pt._safe_div(scene.light_pmf[q], scene.light_area[q])
        l_pdf = torch.where(lfront, pt._safe_div(p_area * ldist2, cos_l), 0.0)
        l_rad = torch.where(lfront[..., None], scene.light_radiance, 0.0)
        wo_nee = hit.to_local(ld)
        nee_ok = (med_event | real_surf) & (l_pdf > 0.0) & (b + 2 <= depth)
        shadow_o = torch.where(med_event[..., None], p_med, hit.spawn(ld))
        smaxt = torch.where(nee_ok, ldist * (1.0 - 1e-3), 0.0)
        nee_vis = nee_ok & ~pt._hits(scene, shadow_o, ld, smaxt, True)
        f_s, p_s_nee, wo_b, bsdf_pdf, weight_b = pt._shade(scene, hit, wo_nee, u2, u_lobe,
                                                           real_surf, nee_vis)
        ph_val = phase_eval(ph_type, ph_g, wi_world, ld)
        f_scat = torch.where(med_event[..., None], ph_val[..., None], f_s)
        pdf_scat = torch.where(med_event, ph_val, p_s_nee)
        # the medium reaches to the first boundary along the shadow ray
        t_sh, prim_sh, _, _ = pt._hits(scene, shadow_o, ld, smaxt, False)
        tr_dist = torch.where(prim_sh >= 0, torch.minimum(t_sh, smaxt), smaxt)
        tr = transmittance(media, torch.where(nee_ok, mid, -1), shadow_o, ld, tr_dist,
                           med_seed, lane, med_base + MED_SHADOW, steps)
        w_nee = pt._mis(l_pdf, pdf_scat)
        contrib = thr * f_scat * tr * l_rad * pt._safe_div(w_nee, l_pdf).detach()[..., None]
        L = L + torch.where(nee_vis[..., None], contrib, 0.0)
        wo_b, bsdf_pdf = wo_b.detach(), bsdf_pdf.detach()
        wo_ph, ph_pdf = phase_sample(ph_type, ph_g, wi_world, u2)
        wo_ph, ph_pdf = wo_ph.detach(), ph_pdf.detach()
        d_next = torch.where(med_event[..., None], wo_ph,
                             torch.where(null_surf[..., None], d, hit.to_world(wo_b)))
        o_next = torch.where(med_event[..., None], p_med, hit.spawn(d_next))
        step_w = torch.where((med_event | null_surf)[..., None], 1.0, weight_b)
        thr = thr * torch.where(active[..., None], step_w, 1.0)
        o = torch.where(active[..., None], o_next, o)
        d = torch.where(active[..., None], d_next, d)
        entering = pt._dot(d, hit.n) < 0.0
        interior = scene.interior[hit.prim.clamp(min=0)]
        mid = torch.where(null_surf, torch.where(entering, interior, -1), mid)
        prev_pdf = torch.where(med_event, ph_pdf, torch.where(null_surf, prev_pdf, bsdf_pdf))
        prev_delta = ~med_event & torch.where(null_surf, prev_delta, torch.zeros_like(prev_delta))
        ok_surf = (bsdf_pdf > 0.0) & (weight_b > 0.0).any(-1)
        cont = med_event | null_surf | (real_surf & ok_surf)
        active = active & cont & (b + 1 < depth) & (thr > 0.0).any(-1)
        if b + 1 >= scene.rr_depth:
            qq = torch.clamp(thr.amax(-1), 0.05, 0.95).detach()
            survive = rng.draw(base + 3) < qq
            thr = torch.where(survive[..., None], thr / qq[..., None], thr)
            active = active & survive
    return L


def scene_of(d, device, dtype=torch.float32, params=None):
    """A path_tracer.Scene of dict `d` with its media (`vol`)."""
    params = params or {}
    scene = pt.Scene(d, device, dtype, params)
    scene.vol = Media(scene.media, device, dtype, params)
    return scene


def render_pixels(scene, seed, pixels, ad_mode=False):
    """The box-filtered values (M, 3) of `pixels` at `seed`."""
    spp = scene.spp
    pix = pixels.repeat_interleave(spp)
    smp = torch.arange(spp, device=pixels.device).repeat(pixels.shape[0])
    return trace(scene, seed, pix, smp, ad_mode).reshape(-1, spp, 3).mean(1)


def loss_and_grad(d, params, target, seed, device, dtype=torch.float32,
                  lanes_per_block=None):
    """path_tracer.loss_and_grad under the volumetric integrator (ad_mode)."""
    leaves = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
              for k, v in params.items()}
    scene = scene_of(d, device, dtype, leaves)
    w, h, spp = scene.width, scene.height, scene.spp
    tgt = target.to(device=device, dtype=dtype).reshape(-1, 3)
    lanes_per_block = lanes_per_block or (1 << (18 if torch.device(device).type == "cuda"
                                                    else 14))
    per = max(1, lanes_per_block // spp)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for p0 in range(0, w * h, per):
        pix = torch.arange(p0, min(p0 + per, w * h), device=device)
        scene.vol.new_pass()
        part = ((render_pixels(scene, seed, pix, True) - tgt[pix]) ** 2).sum() / (w * h * 3)
        if part.requires_grad:  # rows of sky alone depend on no parameter
            part.backward()
        total += part.detach().double()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total, grads


Adam = pt.Adam
