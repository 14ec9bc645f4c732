"""Participating media: homogeneous and heterogeneous (grid) volumes.

PyTorch port of mitsuba_customization_tpu/render/medium.py (mitsuba3
src/media/{homogeneous,heterogeneous}.cpp and src/volumes/gridvolume.cpp):
`MediumTable`, `empty_table`, `build_table`, `_density`, `sigma_t_at`,
`_draw`, `sample_interaction`, `transmittance` and `recompute_majorant`.

All media of a scene compile into one MediumTable: per-medium type and
parameters, the density grids zero-padded into one (K, D, H, W) stack.
Homogeneous media sample distances in closed form (a channel picked
uniformly, its pdf averaged over the channels); heterogeneous media use
weighted delta tracking for distances and ratio tracking for shadow-ray
transmittance, under a scalar majorant of the channel-mean extinction.
`shape_interior[s]` is the medium entered through shape s (-1: vacuum).

The tracking loops draw from hash(seed, lane, dim_base + step) (core/qmc),
so a lane's steps depend on nothing but its own state, and a lane that is
done stays as it is. The JAX package's while_loop runs until every lane
is done (a lane is done at the latest after step MAX_TRACKING_STEPS, the
257th update); under ad_mode its fixed AD_TRACKING_STEPS-step scan cuts
the lanes that are not done by then, which keep their partial distance
and weight and pass through: part of its gradient estimator, kept here.
The port runs each loop on the lanes that need it (those in a
heterogeneous medium) and, every CHECK_EVERY steps, reads on the host
whether any lane is still going (one sync) and goes on with those lanes
only. The results are the JAX package's.

Detached and attached as in the JAX package: sampled distances,
majorants and selection pdfs are detached; the extinction in numerators
and in the ratio-tracking factors stays attached. A density grid that
requires grad is read through `_GridGather`, whose backward adds into one
grid-sized buffer per read (counted in GRID_BUFFERS): one read (the eight
corners of every lane) per tracking step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.qmc import MASK32, as_u32, hash_combine
from mitsuba_customization_tpu_torch.core.sampler import _uniform_from_bits

HOMOGENEOUS = 0
HETEROGENEOUS = 1

MAX_TRACKING_STEPS = 256
AD_TRACKING_STEPS = 48
CHECK_EVERY = 8

# Since the counts were last set to 0: one (kind, lanes, steps, host
# checks) entry per tracking loop run (chip_smoke and the frame profile
# read them), and the grid-sized gradient buffers made by backward passes.
LOOPS = []
GRID_BUFFERS = 0


class MediumTable(NamedTuple):
    """All media of a scene (K media, S shapes).

    m_type (K,) int64 HOMOGENEOUS / HETEROGENEOUS; sigma_t (K, 3) scaled
    extinction; albedo (K, 3); phase_type (K,) int64 (models/phase.py);
    phase_g (K,) HG anisotropy; grid (Kg, D, H, W) stacked densities
    (Kg >= 1; a 1x1x1x1 dummy without grids); grid_slot (K,) int64;
    world_to_grid (K, 3, 4) world -> unit-cube grid coordinates as (z, y,
    x) fractions; grid_dims (K, 3) int64 each grid's own (D, H, W);
    majorant (K,) of the channel-mean extinction; shape_interior (S,)
    int64; emission (K, 3) radiance of emissive media; phase_S (K, 6)
    SGGX matrices, None without an SGGX phase; has_het: a heterogeneous
    medium exists (a host fact).
    """

    m_type: torch.Tensor
    sigma_t: torch.Tensor
    albedo: torch.Tensor
    phase_type: torch.Tensor
    phase_g: torch.Tensor
    grid: torch.Tensor
    grid_slot: torch.Tensor
    world_to_grid: torch.Tensor
    grid_dims: torch.Tensor
    majorant: torch.Tensor
    shape_interior: torch.Tensor
    emission: torch.Tensor
    phase_S: torch.Tensor = None
    has_het: bool = False

    @property
    def n_media(self):
        return self.m_type.shape[0]


def empty_table(n_shapes=1, *, device="cpu"):
    """A table with no media: every lookup is vacuum."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MediumTable(
        m_type=z(0, dtype=torch.int64), sigma_t=z(0, 3), albedo=z(0, 3),
        phase_type=z(0, dtype=torch.int64), phase_g=z(0),
        grid=torch.ones((1, 1, 1, 1), device=device), grid_slot=z(0, dtype=torch.int64),
        world_to_grid=z(0, 3, 4), grid_dims=torch.ones((0, 3), dtype=torch.int64,
                                                       device=device),
        majorant=z(0),
        shape_interior=torch.full((max(n_shapes, 1),), -1, dtype=torch.int64, device=device),
        emission=z(0, 3),
    )


def _rows(t, idx):
    """t[idx] through index_select (its backward is one index_add_)."""
    return m.gather_rows(t, idx)


# --------------------------------------------------------------------------
# Density lookup (gridvolume trilinear)
# --------------------------------------------------------------------------


class _GridGather(torch.autograd.Function):
    """flat[idx] whose backward makes one grid-sized buffer (counted)."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.n = flat.shape[0]
        return flat.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        global GRID_BUFFERS
        (idx,) = ctx.saved_tensors
        GRID_BUFFERS += 1
        out = g.new_zeros(ctx.n).index_add_(0, idx, g)
        return out, None


def _lookup(table: MediumTable, mid):
    """The per-lane grid bindings of media mid (>= 0): (world_to_grid
    (N, 3, 4), grid slot, dims (N, 3), heterogeneous). Gathered once a
    tracking loop, read every step."""
    return (_rows(table.world_to_grid, mid), table.grid_slot[mid], table.grid_dims[mid],
            table.m_type[mid] == HETEROGENEOUS)


def _lerp(a, b, t):
    return a * (1.0 - t) + b * t


def _density_at(grid, look, p):
    """Trilinear density at world points p (N, 3) of lanes bound by
    `look` (_lookup); 1 for homogeneous lanes, 0 outside a grid."""
    w2g, slot, dims, het = look
    g = (w2g[..., 0] * p[..., 0:1] + w2g[..., 1] * p[..., 1:2]
         + w2g[..., 2] * p[..., 2:3]) + w2g[..., 3]
    dims_f = dims.to(torch.float32)
    f = torch.clamp(g, 0.0, 1.0) * (dims_f - 1.0)
    i0 = torch.minimum(torch.clamp(torch.floor(f).to(torch.int64), min=0),
                       torch.clamp(dims - 2, min=0))
    t = f - i0
    i1 = torch.minimum(i0 + 1, dims - 1)
    _, gd, gh, gw = grid.shape
    zs = torch.stack([i0[:, 0], i1[:, 0]], -1)
    ys = torch.stack([i0[:, 1], i1[:, 1]], -1)
    xs = torch.stack([i0[:, 2], i1[:, 2]], -1)
    # the eight corners (z, y, x bits) of each lane, in one gather
    flat_i = (((slot[:, None, None, None] * gd + zs[:, :, None, None]) * gh
               + ys[:, None, :, None]) * gw + xs[:, None, None, :])
    flat = grid.reshape(-1)
    idx = flat_i.reshape(-1)
    if flat.requires_grad and torch.is_grad_enabled():
        vals = _GridGather.apply(flat, idx)
    else:
        vals = flat.index_select(0, idx)
    c = vals.reshape(-1, 2, 2, 2)
    tz, ty, tx = t[:, 0], t[:, 1], t[:, 2]
    c00 = _lerp(c[:, 0, 0, 0], c[:, 0, 0, 1], tx)
    c01 = _lerp(c[:, 0, 1, 0], c[:, 0, 1, 1], tx)
    c10 = _lerp(c[:, 1, 0, 0], c[:, 1, 0, 1], tx)
    c11 = _lerp(c[:, 1, 1, 0], c[:, 1, 1, 1], tx)
    dens = _lerp(_lerp(c00, c01, ty), _lerp(c10, c11, ty), tz)
    inside = ((g >= 0.0) & (g <= 1.0)).all(-1)
    return torch.where(het & inside, dens, torch.where(het, 0.0, 1.0))


def _density(table: MediumTable, mid, p):
    """Trilinear density at world p (N, 3) for heterogeneous lanes (1.0
    for homogeneous ones); mid (N,) must be >= 0."""
    return _density_at(table.grid, _lookup(table, mid), p)


def sigma_t_at(table: MediumTable, mid, p):
    """(N, 3) extinction at p; zero for vacuum lanes (mid < 0)."""
    safe = mid.clamp(min=0)
    val = _rows(table.sigma_t, safe) * _density(table, safe, p)[..., None]
    return torch.where((mid >= 0)[..., None], val, 0.0)


# --------------------------------------------------------------------------
# Free-flight RNG: hash stream over (seed, lane, dim_base + step)
# --------------------------------------------------------------------------


def _draw(seed, lane, dim):
    """Uniform in [0, 1) from hash_combine(hash_combine(seed, lane), dim)
    on uint32 (held in int64): bit-equal to the JAX package's. seed and
    dim: Python ints or int64 tensors."""
    return _draw_key(hash_combine(as_u32(seed, lane), lane), dim)


def _draw_key(key, dim):
    """_draw from a lane's key hash_combine(seed, lane), which every draw
    of a loop shares (dim a Python int)."""
    return _uniform_from_bits(hash_combine(key, dim & MASK32))


def _free_step(u):
    """-log(1 - u) for u clamped to [0, 1 - 1e-7]."""
    return -torch.log1p(-torch.clamp(u, 0.0, 1.0 - 1e-7))


def _tracking(kind, body, consts, carry, n_steps):
    """Run body(step, consts, carry) -> carry for n_steps steps over lanes
    whose carry[-1] (done) is False; done lanes are frozen by the body.
    Every CHECK_EVERY steps the lanes still going are read on the host
    (one sync); the loop ends when none is, and goes on with those lanes
    only. Returns the final carry over all lanes."""
    full = list(carry)
    idx = None  # the lanes of `cur`: all of them at first
    cur_c, cur = consts, tuple(carry)
    step = checks = 0
    n = carry[0].shape[0]
    while step < n_steps:
        for s in range(step, min(step + CHECK_EVERY, n_steps)):
            cur = body(s, cur_c, cur)
        step = min(step + CHECK_EVERY, n_steps)
        if idx is None:
            full = list(cur)
        else:
            full = [f.index_copy(0, idx, c) for f, c in zip(full, cur)]
        if step >= n_steps:
            break
        checks += 1
        live = (~full[-1]).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        idx = live
        cur_c = _gather_consts(consts, idx)
        cur = tuple(f.index_select(0, idx) for f in full)
    LOOPS.append((kind, n, step, checks))
    return tuple(full)


def _gather_consts(consts, idx):
    return tuple(c.index_select(0, idx) for c in consts)


def _scatter(n, idx, sub, fill):
    """An (n, ...) tensor holding `sub` at rows idx and `fill` elsewhere
    (out of place: differentiable in sub)."""
    base = torch.full((n,) + sub.shape[1:], fill, dtype=sub.dtype, device=sub.device)
    return base.index_copy(0, idx, sub)


# --------------------------------------------------------------------------
# Distance sampling
# --------------------------------------------------------------------------


class MediumSample(NamedTuple):
    """A free-flight sample along a ray segment inside medium `mid`.

    is_medium (N,) bool: scattered before t_max; t (N,) the distance;
    weight (N, 3): tr * sigma_s / pdf on a scatter, tr / pr_pass on a pass
    (the albedo included); emitted (N, 3): tr * sigma_a * Le / pdf at a
    real event (the collision estimator of emissive media), else 0.
    """

    is_medium: torch.Tensor
    t: torch.Tensor
    weight: torch.Tensor
    emitted: torch.Tensor


def sample_interaction(table: MediumTable, mid, ray_o, ray_d, t_max, seed, lane, dim_base,
                       ad_mode=False):
    """Sample a free-flight distance for lanes inside a medium (mitsuba3's
    estimators: homogeneous analytic with channel MIS, heterogeneous
    weighted delta tracking). Vacuum lanes (mid < 0) pass with weight 1.
    seed: Python int; lane: int64 (N,) uint32 lane ids; dim_base: Python
    int."""
    n, dev = ray_o.shape[0], ray_o.device
    if table.n_media == 0:
        zero = torch.zeros(n, device=dev)
        return MediumSample(is_medium=torch.zeros(n, dtype=torch.bool, device=dev), t=zero,
                            weight=torch.ones((n, 3), device=dev),
                            emitted=torch.zeros((n, 3), device=dev))
    in_medium = mid >= 0
    safe = mid.clamp(min=0)
    is_het = table.m_type[safe] == HETEROGENEOUS
    sig = _rows(table.sigma_t, safe)
    alb = _rows(table.albedo, safe)
    le = _rows(table.emission, safe)

    key = hash_combine(seed & MASK32, lane)

    # ---- homogeneous: analytic ----
    u_ch = _draw_key(key, dim_base)
    u_t = _draw_key(key, dim_base + 1)
    ch = torch.clamp((u_ch * 3).to(torch.int64), max=2)
    sig_ch = torch.where(ch == 0, sig[:, 0], torch.where(ch == 1, sig[:, 1], sig[:, 2]))
    t_hom = (_free_step(u_t) / torch.clamp(sig_ch, min=1e-20)).detach()
    scat_hom = t_hom < t_max
    tr_t = torch.exp(-sig * torch.minimum(t_hom, t_max)[:, None])
    pdf_scat = (sig * tr_t).mean(-1).detach()
    pdf_pass = tr_t.mean(-1).detach()
    base_hom = m.safe_div(tr_t * sig, pdf_scat[:, None])
    w_hom = torch.where(scat_hom[:, None], base_hom * alb,
                        m.safe_div(tr_t, pdf_pass[:, None]))
    em_hom = torch.where(scat_hom[:, None], base_hom * (1.0 - alb) * le, 0.0)

    # ---- heterogeneous: weighted delta tracking ----
    t_het = torch.zeros(n, device=dev)
    w_het = torch.ones((n, 3), device=dev)
    scat_het = torch.zeros(n, dtype=torch.bool, device=dev)
    need = (in_medium & is_het).nonzero().squeeze(1) if table.has_het else None
    if need is not None and need.numel():
        maj = torch.clamp(table.majorant[safe], min=1e-20).detach()
        consts = _gather_consts((ray_o, ray_d, t_max, sig, maj, key)
                                + _lookup(table, safe), need)

        def dt_body(step, c, state):
            o, d, tmax, sg, mj, ky, *look = c
            t, w, scat, done = state
            u1 = _draw_key(ky, dim_base + 2 + step * 2)
            u2 = _draw_key(ky, dim_base + 3 + step * 2)
            t_new = t + _free_step(u1) / mj
            passed = t_new >= tmax
            sig_p = sg * _density_at(table.grid, look, o + t_new[:, None] * d)[:, None]
            mean_sig = sig_p.mean(-1)
            p_real = torch.clamp(mean_sig / mj, 0.0, 1.0).detach()
            real = u2 < p_real
            w_real = m.safe_div(sig_p, mean_sig.detach()[:, None])
            w_null = m.safe_div(mj[:, None] - sig_p, (mj * (1.0 - p_real)).detach()[:, None])
            upd = ~done
            moved = upd & ~passed
            t = torch.where(upd, torch.where(passed, tmax, t_new), t)
            w = torch.where(moved[:, None], w * torch.where(real[:, None], w_real, w_null), w)
            scat = scat | (moved & real)
            done = done | passed | scat | (step >= MAX_TRACKING_STEPS)
            return t, w, scat, done

        k = need.shape[0]
        init = (torch.zeros(k, device=dev), torch.ones((k, 3), device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev))
        steps = AD_TRACKING_STEPS if ad_mode else MAX_TRACKING_STEPS + 1
        t_s, w_s, scat_s, _ = _tracking("delta", dt_body, consts, init, steps)
        t_het = _scatter(n, need, t_s, 0.0)
        w_het = _scatter(n, need, w_s, 1.0)
        scat_het = _scatter(n, need, scat_s, False)
    em_het = torch.where(scat_het[:, None], w_het * (1.0 - alb) * le, 0.0)
    w_het = torch.where(scat_het[:, None], w_het * alb, w_het)

    is_medium = in_medium & torch.where(is_het, scat_het, scat_hom)
    t_s = torch.where(is_het, t_het, t_hom)
    weight = torch.where(in_medium[:, None], torch.where(is_het[:, None], w_het, w_hom), 1.0)
    emitted = torch.where(in_medium[:, None], torch.where(is_het[:, None], em_het, em_hom),
                          0.0)
    return MediumSample(is_medium=is_medium, t=t_s, weight=weight, emitted=emitted)


# --------------------------------------------------------------------------
# Transmittance (shadow rays): analytic / ratio tracking
# --------------------------------------------------------------------------


def transmittance(table: MediumTable, mid, ray_o, ray_d, dist, seed, lane, dim_base,
                  ad_mode=False):
    """(N, 3) transmittance through medium `mid` over [0, dist]: 1 for
    vacuum lanes, exp(-sigma_t d) for homogeneous ones, ratio tracking
    (the majorant detached, the (1 - sigma / majorant) factors attached)
    for heterogeneous ones."""
    n, dev = ray_o.shape[0], ray_o.device
    if table.n_media == 0:
        return torch.ones((n, 3), device=dev)
    in_medium = mid >= 0
    safe = mid.clamp(min=0)
    is_het = table.m_type[safe] == HETEROGENEOUS
    sig = _rows(table.sigma_t, safe)
    d_fin = torch.where(torch.isfinite(dist), dist, 1e7)
    tr_hom = torch.exp(-sig * d_fin[:, None])

    tr_het = torch.ones((n, 3), device=dev)
    need = (in_medium & is_het).nonzero().squeeze(1) if table.has_het else None
    if need is not None and need.numel():
        maj = torch.clamp(table.majorant[safe], min=1e-20).detach()
        consts = _gather_consts((ray_o, ray_d, d_fin, sig, maj,
                                 hash_combine(seed & MASK32, lane)) + _lookup(table, safe), need)

        def rt_body(step, c, state):
            o, d, dmax, sg, mj, ky, *look = c
            t, w, done = state
            t_new = t + _free_step(_draw_key(ky, dim_base + step)) / mj
            passed = t_new >= dmax
            sig_p = sg * _density_at(table.grid, look, o + t_new[:, None] * d)[:, None]
            upd = ~done & ~passed
            w = torch.where(upd[:, None],
                            w * torch.clamp(1.0 - sig_p / mj[:, None], 0.0, 1.0), w)
            t = torch.where(done, t, t_new)
            done = done | passed | (step >= MAX_TRACKING_STEPS)
            return t, w, done

        k = need.shape[0]
        init = (torch.zeros(k, device=dev), torch.ones((k, 3), device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev))
        steps = AD_TRACKING_STEPS if ad_mode else MAX_TRACKING_STEPS + 1
        _, w_s, _ = _tracking("ratio", rt_body, consts, init, steps)
        tr_het = _scatter(n, need, w_s, 1.0)
    tr = torch.where(is_het[:, None], tr_het, tr_hom)
    return torch.where(in_medium[:, None], tr, 1.0)


# --------------------------------------------------------------------------
# Scene build
# --------------------------------------------------------------------------


@torch.no_grad()
def recompute_majorant(table: MediumTable):
    """The majorant of the channel-mean extinction from the current
    sigma_t and density grids (after params.update). It is only ever read
    detached, so it is computed without a graph."""
    mean_sig = table.sigma_t.mean(-1)
    if table.grid.numel() > 1 or table.grid_slot.numel():
        gmax = table.grid.reshape(table.grid.shape[0], -1).amax(-1)
        slot_max = gmax[table.grid_slot] if table.grid_slot.numel() else 1.0
        return torch.where(table.m_type == HETEROGENEOUS, mean_sig * slot_max, mean_sig)
    return mean_sig


def build_table(media_rows, shape_interior, n_shapes, *, device):
    """A MediumTable on `device` from the loader's rows: dicts with type
    ('homogeneous' | 'heterogeneous'), sigma_t (3,), albedo (3,),
    phase_type, phase_g, phase_S (6,) or None, emission (3,) or None,
    density (D, H, W) or None, to_world (4, 4) or None (the grid's world
    box: its inverse maps world to the unit cube); shape_interior: the
    medium id of each shape (-1 = vacuum)."""
    k = len(media_rows)
    if k == 0:
        return empty_table(n_shapes, device=device)
    m_type = np.zeros(k, np.int64)
    sigma_t = np.zeros((k, 3), np.float32)
    albedo = np.zeros((k, 3), np.float32)
    phase_type = np.zeros(k, np.int64)
    phase_g = np.zeros(k, np.float32)
    grid_slot = np.zeros(k, np.int64)
    world_to_grid = np.zeros((k, 3, 4), np.float32)
    grid_dims = np.ones((k, 3), np.int64)
    majorant = np.zeros(k, np.float32)
    emission = np.zeros((k, 3), np.float32)
    phase_S = None
    grids = []
    max_shape = (1, 1, 1)
    for i, row in enumerate(media_rows):
        m_type[i] = HETEROGENEOUS if row["type"] == "heterogeneous" else HOMOGENEOUS
        sigma_t[i] = np.asarray(row["sigma_t"], np.float32)
        albedo[i] = np.asarray(row["albedo"], np.float32)
        phase_type[i] = row.get("phase_type", 0)
        phase_g[i] = row.get("phase_g", 0.0)
        if row.get("emission") is not None:
            emission[i] = np.asarray(row["emission"], np.float32)
        if row.get("phase_S") is not None:
            if phase_S is None:
                phase_S = np.tile(np.asarray([1, 1, 1, 0, 0, 0], np.float32), (k, 1))
            phase_S[i] = np.asarray(row["phase_S"], np.float32)
        if m_type[i] == HETEROGENEOUS:
            dens = np.asarray(row["density"], np.float32)
            grid_slot[i] = len(grids)
            grid_dims[i] = dens.shape
            grids.append(dens)
            max_shape = tuple(max(a, b) for a, b in zip(max_shape, dens.shape))
            to_w = (np.asarray(row["to_world"], np.float64)
                    if row.get("to_world") is not None else np.eye(4))
            inv = np.linalg.inv(to_w)
            # world -> unit cube, then (x, y, z) -> (z, y, x) fractions
            perm = np.asarray([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float64)
            world_to_grid[i, :, :3] = (perm @ inv[:3, :3]).astype(np.float32)
            world_to_grid[i, :, 3] = (perm @ inv[:3, 3]).astype(np.float32)
            majorant[i] = float(np.mean(sigma_t[i]) * dens.max())
        else:
            majorant[i] = float(np.mean(sigma_t[i]))
    if not grids:
        grids = [np.ones((1, 1, 1), np.float32)]
        max_shape = (1, 1, 1)
    padded = np.zeros((len(grids),) + max_shape, np.float32)
    for gi, g in enumerate(grids):
        padded[gi, :g.shape[0], :g.shape[1], :g.shape[2]] = g
    si = np.full(max(n_shapes, 1), -1, np.int64)
    for s, mid in enumerate(shape_interior[:len(si)]):
        si[s] = mid

    def dev(a):
        return torch.as_tensor(a, device=device)

    return MediumTable(
        m_type=dev(m_type), sigma_t=dev(sigma_t), albedo=dev(albedo),
        phase_type=dev(phase_type), phase_g=dev(phase_g), grid=dev(padded),
        grid_slot=dev(grid_slot), world_to_grid=dev(world_to_grid),
        grid_dims=dev(grid_dims), majorant=dev(majorant), shape_interior=dev(si),
        emission=dev(emission), phase_S=None if phase_S is None else dev(phase_S),
        has_het=bool((m_type == HETEROGENEOUS).any()),
    )
