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
Outside ad_mode the loops are the kernels T1 (`delta_track`) and T2
(`ratio_track`, csrc/medium_track.cu), one thread a lane running its own
loop to its own end; their plain versions (`delta_track_plain`,
`ratio_track_plain`) run the loop in torch on the lanes in a
heterogeneous medium, reading on the host every CHECK_EVERY steps whether
any lane is still going (one sync) and going on with those lanes only. In
ad_mode the loops are the JAX package's masked scan in torch over all
lanes, with no host read: T1 / T2 at AD_TRACKING_STEPS steps forward and
their backward kernels T1-bwd / T2-bwd (`track_bwd`), which replay each
lane's steps from its key, through one autograd Function (`_Track`); on
CPU tensors the forward is `_scan`'s values and the backward its plain
version `track_bwd_plain`. The density grid's gradient of every tracking
call of a backward pass goes into one grid-sized buffer (the table's
`grid_sink`, made by params.update). The results are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.qmc import MASK32, as_u32, hash_combine
from mitsuba_customization_tpu_torch.core.sampler import _uniform_from_bits
from mitsuba_customization_tpu_torch.ops import build as kbuild

HOMOGENEOUS = 0
HETEROGENEOUS = 1

MAX_TRACKING_STEPS = 256
AD_TRACKING_STEPS = 48
CHECK_EVERY = 8
# T1-bwd / T2-bwd sum sigma_t's gradient in shared memory: media at most
MAX_BWD_MEDIA = 4096

SOURCE = "mitsuba_customization_tpu_torch/csrc/medium_track.cu"
# T1 / T2 launches and T1-bwd / T2-bwd launches (a replay of a captured
# frame launches without calling the wrappers: count those in its trace)
LAUNCHES = {"delta": 0, "ratio": 0}
LAUNCHES_BWD = {"delta": 0, "ratio": 0}
# None, or a list to which each tracking loop appends (kind, lanes, each
# lane's steps (lanes,) int32 on the lanes' device, host checks): set it
# to [] to record (chip_smoke and the frame profile do), and read the
# steps after the frame. The grid-sized gradient buffers made by backward
# passes since the count was last set to 0 (one a backward pass through
# the table's grid_sink).
LOOPS = None
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
    medium exists (a host fact); grid_sink: where the grid requires grad
    under grad mode, the merl_sorted.GradSink through which it enters
    autograd once (params.update), else None.
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
    grid_sink: object = None

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


def _corners(grid, look, p):
    """The flat indices into `grid` of the eight corners (z, y, x bits) of
    each lane's cell at world points p (N, 3) of lanes bound by `look`
    (_lookup), in one (N * 8,) tensor; the fractions (N, 3) in the cell;
    and whether p lies inside the grid's unit cube (N,)."""
    w2g, slot, dims, _ = look
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
    flat_i = (((slot[:, None, None, None] * gd + zs[:, :, None, None]) * gh
               + ys[:, None, :, None]) * gw + xs[:, None, None, :])
    return flat_i.reshape(-1), t, ((g >= 0.0) & (g <= 1.0)).all(-1)


def _density_at(grid, look, p):
    """Trilinear density at world points p (N, 3) of lanes bound by
    `look` (_lookup); 1 for homogeneous lanes, 0 outside a grid."""
    het = look[3]
    idx, t, inside = _corners(grid, look, p)
    flat = grid.reshape(-1)
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


def _channel_mean(x):
    """The mean of x's three channels, ((x0 + x1) + x2) / 3: a sum order
    and a true division that T1 writes out the same (torch's CUDA mean(-1)
    takes another order and multiplies by a rounded 1/3)."""
    return (x[:, 0] + x[:, 1] + x[:, 2]) / x.new_full((), 3.0)


def _tracking(body, consts, carry, n_steps):
    """Run body(step, consts, carry) -> carry for n_steps steps over lanes
    whose carry[-1] (done) is False; done lanes are frozen by the body.
    Every CHECK_EVERY steps the lanes still going are read on the host
    (one sync); the loop ends when none is, and goes on with those lanes
    only. Returns (the final carry over all lanes, host checks)."""
    full = list(carry)
    idx = None  # the lanes of `cur`: all of them at first
    cur_c, cur = consts, tuple(carry)
    step = checks = 0
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
    return tuple(full), checks


def _gather_consts(consts, idx):
    return tuple(c.index_select(0, idx) for c in consts)


def _scatter(n, idx, sub, fill):
    """An (n, ...) tensor holding `sub` at rows idx and `fill` elsewhere
    (out of place: differentiable in sub)."""
    base = torch.full((n,) + sub.shape[1:], fill, dtype=sub.dtype, device=sub.device)
    return base.index_copy(0, idx, sub)


def _record(kind, steps, checks):
    """Append a tracking loop to LOOPS when it records: (kind, lanes,
    each lane's steps, host checks)."""
    if LOOPS is not None:
        LOOPS.append((kind, steps.shape[0], steps, checks))


# --------------------------------------------------------------------------
# The tracking loops: T1 (delta), T2 (ratio) and their plain versions
# --------------------------------------------------------------------------


def _delta_body(grid, dim_base, keep=None):
    """Weighted delta tracking's step over lanes with consts (o, d, t_max,
    sigma_t rows, majorant, key, *lookup) and state (t, w, scat, steps,
    done): dt_body of the JAX package. `keep`: None, or a list to which
    each step appends (t_new, density, moved, real, passed here, the
    weight before the step) for the replay backward."""
    def body(step, c, state):
        o, d, tmax, sg, mj, ky, *look = c
        t, w, scat, steps, done = state
        u1 = _draw_key(ky, dim_base + 2 + step * 2)
        u2 = _draw_key(ky, dim_base + 3 + step * 2)
        t_new = t + _free_step(u1) / mj
        passed = t_new >= tmax
        dens = _density_at(grid, look, o + t_new[:, None] * d)
        sig_p = sg * dens[:, None]
        mean_sig = _channel_mean(sig_p)
        p_real = torch.clamp(mean_sig / mj, 0.0, 1.0).detach()
        real = u2 < p_real
        w_real = m.safe_div(sig_p, mean_sig.detach()[:, None])
        w_null = m.safe_div(mj[:, None] - sig_p, (mj * (1.0 - p_real)).detach()[:, None])
        upd = ~done
        moved = upd & ~passed
        if keep is not None:
            keep.append((t_new, dens, moved, real, upd & passed, w))
        t = torch.where(upd, torch.where(passed, tmax, t_new), t)
        w = torch.where(moved[:, None], w * torch.where(real[:, None], w_real, w_null), w)
        scat = scat | (moved & real)
        if steps is not None:
            steps = steps + upd.to(steps.dtype)
        done = done | passed | scat | (step >= MAX_TRACKING_STEPS)
        return t, w, scat, steps, done

    return body


def _ratio_body(grid, dim_base, keep=None):
    """Ratio tracking's step over lanes with consts (o, d, dist, sigma_t
    rows, majorant, key, *lookup) and state (t, w, steps, done): rt_body
    of the JAX package. `keep` as _delta_body's (real and passed False)."""
    def body(step, c, state):
        o, d, dmax, sg, mj, ky, *look = c
        t, w, steps, done = state
        t_new = t + _free_step(_draw_key(ky, dim_base + step)) / mj
        passed = t_new >= dmax
        dens = _density_at(grid, look, o + t_new[:, None] * d)
        sig_p = sg * dens[:, None]
        upd = ~done & ~passed
        if keep is not None:
            keep.append((t_new, dens, upd, torch.zeros_like(upd), torch.zeros_like(upd), w))
        w = torch.where(upd[:, None],
                        w * torch.clamp(1.0 - sig_p / mj[:, None], 0.0, 1.0), w)
        t = torch.where(done, t, t_new)
        if steps is not None:
            steps = steps + (~done).to(steps.dtype)
        done = done | passed | (step >= MAX_TRACKING_STEPS)
        return t, w, steps, done

    return body


def _consts(table, mid, ray_o, ray_d, t_max, key):
    """A loop's per-lane inputs (o, d, t_max, sigma_t rows, detached
    majorant, key, *lookup) and the lanes that track (in a heterogeneous
    medium)."""
    safe = mid.clamp(min=0)
    look = _lookup(table, safe)
    need = (mid >= 0) & look[3]
    maj = torch.clamp(table.majorant[safe], min=1e-20).detach()
    return (ray_o, ray_d, t_max, _rows(table.sigma_t, safe), maj, key) + look, need


def _init(n, dev, delta):
    """The loops' initial state but done: t 0, weight 1 (no scatter), 0
    steps."""
    state = (torch.zeros(n, device=dev), torch.ones((n, 3), device=dev))
    if delta:
        state += (torch.zeros(n, dtype=torch.bool, device=dev),)
    return state + (torch.zeros(n, dtype=torch.int32, device=dev),)


def _plain(kind, table, mid, ray_o, ray_d, t_max, key, dim_base):
    """The plain version of T1 / T2: the loop on the lanes in a
    heterogeneous medium, a host check every CHECK_EVERY steps (the lanes
    still going go on), the results scattered back; full state per lane."""
    n, dev = ray_o.shape[0], ray_o.device
    delta = kind == "delta"
    consts, need = _consts(table, mid, ray_o, ray_d, t_max, key)
    need = need.nonzero().squeeze(1)
    out = _init(n, dev, delta)
    checks = 0
    if need.numel():
        k = need.shape[0]
        body = (_delta_body if delta else _ratio_body)(table.grid, dim_base)
        init = _init(k, dev, delta) + (torch.zeros(k, dtype=torch.bool, device=dev),)
        sub, checks = _tracking(body, _gather_consts(consts, need), init,
                                MAX_TRACKING_STEPS + 1)
        fills = (0.0, 1.0, False, 0) if delta else (0.0, 1.0, 0)
        out = tuple(_scatter(n, need, x, f) for x, f in zip(sub[:-1], fills))
    _record(kind, out[-1], checks)
    return out


def delta_track_plain(table, mid, ray_o, ray_d, t_max, key, dim_base):
    """T1's plain version (delta_track's arguments and results)."""
    return _plain("delta", table, mid, ray_o, ray_d, t_max, key, dim_base)


def ratio_track_plain(table, mid, ray_o, ray_d, dist, key, dim_base):
    """T2's plain version (ratio_track's arguments and results)."""
    _, w, steps = _plain("ratio", table, mid, ray_o, ray_d, dist, key, dim_base)
    return w, steps


def _check_grad(table, *tensors):
    """The tracking loops are not differentiable outside ad_mode (the JAX
    package's while_loop is not reverse-differentiable): raise where an
    input requires grad under grad mode, as sdf.march does."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (table.sigma_t, table.grid, *tensors)):
        raise RuntimeError("the tracking loops have no gradient outside ad_mode (as the JAX "
                           "package's while_loop); render with ad_mode=True (render_ad) or "
                           "under torch.no_grad()")


def _check_cuda(table, mid, ray_o, ray_d, t_max, key, what):
    n = ray_o.shape[0]
    if (ray_o.shape != (n, 3) or ray_d.shape != (n, 3) or t_max.shape != (n,)
            or mid.shape != (n,) or key.shape != (n,)):
        raise ValueError(f"{what}: o, d must be (N, 3) and t_max, mid, key (N,)")
    floats = (ray_o, ray_d, t_max, table.sigma_t, table.majorant, table.world_to_grid,
              table.grid)
    ints = (mid, key, table.m_type, table.grid_slot, table.grid_dims)
    if (any(t.dtype != torch.float32 for t in floats)
            or any(t.dtype != torch.int64 for t in ints)):
        raise ValueError(f"{what}: rays, t_max and the table's values must be float32, mid, "
                         "key and the table's indices int64")
    if table.grid.dim() != 4:
        raise ValueError(f"{what}: the grid stack must be (Kg, D, H, W)")
    for t in floats + ints:
        if not t.is_cuda or t.device != ray_o.device:
            raise ValueError(f"{what}: rays and the medium table must be on one GPU")


def _table_ptrs(table):
    """The table's tensors as T1 / T2 and their backward read them."""
    p = kbuild.ptr
    grid = table.grid.contiguous()
    return [p(x.contiguous()) for x in (table.m_type, table.sigma_t, table.majorant,
                                         table.world_to_grid, table.grid_slot,
                                         table.grid_dims)] + [p(grid)], grid


def _launch(kind, table, mid, ray_o, ray_d, t_max, key, dim_base,
            n_steps=MAX_TRACKING_STEPS + 1):
    """Launch T1 (kind "delta") or T2 ("ratio") over all lanes, each
    tracked lane running at most n_steps updates."""
    what = f"medium {kind} tracking"
    _check_cuda(table, mid, ray_o, ray_d, t_max, key, what)
    n, dev = ray_o.shape[0], ray_o.device
    p = kbuild.ptr
    args = [p(x.contiguous()) for x in (ray_o, ray_d, t_max, mid, key)]
    tabs, grid = _table_ptrs(table)
    w = torch.empty((n, 3), device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    lib = kbuild.library()
    common = (*args, int(dim_base) & MASK32, n, int(n_steps), *tabs, *grid.shape[1:])
    if kind == "delta":
        t = torch.empty(n, device=dev)
        scat = torch.empty(n, dtype=torch.bool, device=dev)
        err = lib.mct_delta_track(*common, p(t), p(w), p(scat), p(steps), kbuild.stream_of(ray_o))
        out = (t, w, scat, steps)
    else:
        err = lib.mct_ratio_track(*common, p(w), p(steps), kbuild.stream_of(ray_o))
        out = (w, steps)
    kbuild.check(err, what)
    LAUNCHES[kind] += 1
    _record(kind, steps, 0)
    return out


def delta_track(table, mid, ray_o, ray_d, t_max, key, dim_base):
    """Weighted delta tracking of every lane in a heterogeneous medium (mid
    (N,) each lane's medium, -1 vacuum; key (N,) int64 hash_combine(seed,
    lane); dim_base a Python int): (t (N,), weight (N, 3), scattered (N,)
    bool, steps (N,) int32 the updates each lane made). A lane outside a
    heterogeneous medium gets t 0, weight 1, no scatter, 0 steps. CPU
    tensors run delta_track_plain; CUDA tensors launch T1. Not
    differentiable (raises where an input requires grad under grad
    mode): ad_mode runs the fixed-length scan (sample_interaction)."""
    _check_grad(table, ray_o, ray_d, t_max)
    if not ray_o.is_cuda:
        return delta_track_plain(table, mid, ray_o, ray_d, t_max, key, dim_base)
    return _launch("delta", table, mid, ray_o, ray_d, t_max, key, dim_base)


def ratio_track(table, mid, ray_o, ray_d, dist, key, dim_base):
    """Ratio tracking's transmittance (N, 3) over [0, dist] (finite) of
    every lane in a heterogeneous medium, and each lane's steps (N,)
    int32; 1 and 0 for the other lanes. CPU tensors run
    ratio_track_plain; CUDA tensors launch T2. Not differentiable, as
    delta_track."""
    _check_grad(table, ray_o, ray_d, dist)
    if not ray_o.is_cuda:
        return ratio_track_plain(table, mid, ray_o, ray_d, dist, key, dim_base)
    return _launch("ratio", table, mid, ray_o, ray_d, dist, key, dim_base)


def _scan(kind, table, mid, ray_o, ray_d, t_max, key, dim_base):
    """ad_mode's tracking: the JAX package's fixed AD_TRACKING_STEPS-step
    masked scan over all lanes (the lanes outside a heterogeneous medium
    done from the start, done lanes frozen), in torch ops with no host
    check, differentiable in the extinction and the grid (_GridGather).
    The lanes not tracked read a majorant of 1, so that their values,
    which the caller drops, stay finite (a NaN there would reach the
    gradients through the masks). Returns the final state but done."""
    n, dev = ray_o.shape[0], ray_o.device
    delta = kind == "delta"
    consts, need = _consts(table, mid, ray_o, ray_d, t_max, key)
    consts = consts[:4] + (torch.where(need, consts[4], 1.0),) + consts[5:]
    body = (_delta_body if delta else _ratio_body)(table.grid, dim_base)
    state = _init(n, dev, delta)
    if LOOPS is None:
        state = state[:-1] + (None,)
    state += (~need,)
    for step in range(AD_TRACKING_STEPS):
        state = body(step, consts, state)
    if LOOPS is not None:
        _record(kind, state[-2], 0)
    return state[:-1]


# --------------------------------------------------------------------------
# ad_mode's tracking: T1 / T2 forward, T1-bwd / T2-bwd backward
# --------------------------------------------------------------------------


def new_grid_grad(grid):
    """A zeroed float32 gradient of the grid stack's shape (counted in
    GRID_BUFFERS)."""
    global GRID_BUFFERS
    GRID_BUFFERS += 1
    return torch.zeros(grid.shape, dtype=torch.float32, device=grid.device)


def _scatter_grid(grid_out, idx, add):
    """grid_out's flat view += add at idx (one index_add_)."""
    grid_out.view(-1).index_add_(0, idx, add)


def _density_bwd(grid, look, p, g_dens, grid_out, need_p):
    """The backward of _density_at(grid, look, p) for heterogeneous lanes:
    g_dens (N,) spread over each lane's eight corners with the lerp weights
    into grid_out (the stack's shape, or None), and where need_p the
    gradient (N, 3) in p (zero outside the unit cube, the clamp and the
    floor passing none), else None."""
    idx, t, inside = _corners(grid, look, p)
    g = torch.where(inside, g_dens, 0.0)
    tz, ty, tx = t[:, 0], t[:, 1], t[:, 2]
    g_a, g_b = g * (1.0 - tz), g * tz
    g_zy = torch.stack([g_a * (1.0 - ty), g_a * ty, g_b * (1.0 - ty), g_b * ty], -1)
    if grid_out is not None:
        corner = torch.stack([g_zy * (1.0 - tx[:, None]), g_zy * tx[:, None]], -1)
        _scatter_grid(grid_out, idx, corner.reshape(-1))
    if not need_p:
        return None
    c = grid.reshape(-1).index_select(0, idx).reshape(-1, 4, 2)
    row = _lerp(c[:, :, 0], c[:, :, 1], tx[:, None])
    g_t = torch.stack([g * (_lerp(row[:, 2], row[:, 3], ty) - _lerp(row[:, 0], row[:, 1], ty)),
                       g_a * (row[:, 1] - row[:, 0]) + g_b * (row[:, 3] - row[:, 2]),
                       (g_zy * (c[:, :, 1] - c[:, :, 0])).sum(-1)], -1)
    w2g, _, dims, _ = look
    g_g = g_t * (dims.to(torch.float32) - 1.0)
    return (g_g[:, :, None] * w2g[:, :, :3]).sum(1)


def track_bwd_plain(kind, table, mid, ray_o, ray_d, t_max, key, dim_base, g_w, g_t=None, *,
                    grid_out=None, need_rays=False, need_t_max=False):
    """T1-bwd / T2-bwd's plain version: the reverse-mode gradient of _scan's
    weight (delta: and t) with cotangents g_w (N, 3) and g_t (N,) or None.
    It replays the AD_TRACKING_STEPS masked steps over all lanes (the same
    draws, flights, points, densities and real / passed decisions, which
    depend only on detached values), keeps each step's weight before it,
    and sweeps the steps in reverse, as autograd does through _scan:
    w_real = sig_p / mean and w_null = (maj - sig_p) / (maj (1 - p_real))
    (zero where the detached denominator is 0), or the ratio factor
    clamp(1 - sig_p / maj, 0, 1). Returns (sigma_t's gradient (K, 3), the
    gradients in ray_o and ray_d (N, 3) where need_rays else None, t_max's
    (N,) where need_t_max: g_t on delta's passed lanes, else None); the
    grid's gradient is added into grid_out (the stack's shape) where it is
    given. No host read."""
    delta = kind == "delta"
    n, dev = ray_o.shape[0], ray_o.device
    with torch.no_grad():
        consts, need = _consts(table, mid, ray_o, ray_d, t_max, key)
        consts = consts[:4] + (torch.where(need, consts[4], 1.0),) + consts[5:]
        keep = []
        body = (_delta_body if delta else _ratio_body)(table.grid, dim_base, keep)
        state = _init(n, dev, delta)[:-1] + (None, ~need)
        for step in range(AD_TRACKING_STEPS):
            state = body(step, consts, state)
        o, d, _, sg, mj, _, *look = consts
        g = g_w
        g_sig = torch.zeros_like(sg)
        g_p = torch.zeros((n, 3), device=dev) if need_rays else None
        g_d = torch.zeros((n, 3), device=dev) if need_rays else None
        passed_any = torch.zeros(n, dtype=torch.bool, device=dev)
        for t_new, dens, moved, real, passed, w_prev in reversed(keep):
            passed_any |= passed
            sig_p = sg * dens[:, None]
            g_f = g * w_prev
            if delta:
                mean = _channel_mean(sig_p)
                den = mj * (1.0 - torch.clamp(mean / mj, 0.0, 1.0))
                f = torch.where(real[:, None], m.safe_div(sig_p, mean[:, None]),
                                m.safe_div(mj[:, None] - sig_p, den[:, None]))
                g_s = torch.where(real[:, None], m.safe_div(g_f, mean[:, None]),
                                  -m.safe_div(g_f, den[:, None]))
            else:
                x = 1.0 - sig_p / mj[:, None]
                f = torch.clamp(x, 0.0, 1.0)
                g_s = torch.where((x >= 0.0) & (x <= 1.0), -g_f, 0.0) / mj[:, None]
            g_s = torch.where(moved[:, None], g_s, 0.0)
            g = torch.where(moved[:, None], g * f, g)
            g_sig = g_sig + dens[:, None] * g_s
            if grid_out is not None or need_rays:
                g_pt = _density_bwd(table.grid, look, o + t_new[:, None] * d,
                                    (sg * g_s).sum(-1), grid_out, need_rays)
                if need_rays:
                    g_p = g_p + g_pt
                    g_d = g_d + g_pt * t_new[:, None]
        safe = mid.clamp(min=0)
        g_sigma = torch.zeros_like(table.sigma_t).index_add_(
            0, safe, torch.where(need[:, None], g_sig, 0.0))
        g_tmax = None
        if need_t_max:
            g_tmax = (torch.where(passed_any, g_t, 0.0) if delta and g_t is not None
                      else torch.zeros(n, device=dev))
    return g_sigma, g_p, g_d, g_tmax


def _launch_bwd(kind, table, mid, ray_o, ray_d, t_max, key, dim_base, g_w, g_t, grid_out,
                need_rays, need_t_max):
    """Launch T1-bwd (kind "delta") or T2-bwd ("ratio"): one launch over
    every lane, which writes the ray and t_max gradients on every lane,
    behind the zeroing of sigma_t's: track_bwd_plain's results."""
    what = f"medium {kind} tracking backward"
    _check_cuda(table, mid, ray_o, ray_d, t_max, key, what)
    n, dev = ray_o.shape[0], ray_o.device
    k = table.sigma_t.shape[0]
    if n >= 2 ** 31 or k > MAX_BWD_MEDIA:
        raise ValueError(f"{what}: at most 2^31 - 1 lanes and {MAX_BWD_MEDIA} media")
    if (g_w.shape != (n, 3) or g_w.dtype != torch.float32 or not g_w.is_cuda
            or (g_t is not None and (g_t.shape != (n,) or g_t.dtype != torch.float32))
            or (grid_out is not None and (grid_out.shape != table.grid.shape
                                          or not grid_out.is_contiguous()))):
        raise ValueError(f"{what}: cotangents (N, 3) / (N,) float32 on the rays' GPU and a "
                         "contiguous grid-shaped output")
    p = kbuild.ptr
    tabs, grid = _table_ptrs(table)
    g_sigma = torch.zeros((k, 3), device=dev)
    g_o = torch.empty((n, 3), device=dev) if need_rays else None
    g_d = torch.empty((n, 3), device=dev) if need_rays else None
    g_tmax = torch.empty(n, device=dev) if need_t_max else None

    def opt(x):
        return p(x) if x is not None else None

    err = kbuild.library().mct_track_bwd(
        int(kind == "delta"), *[p(x.contiguous()) for x in (ray_o, ray_d, t_max, mid, key)],
        int(dim_base) & MASK32, n, AD_TRACKING_STEPS, k, *tabs, *grid.shape[1:],
        p(g_w.contiguous()), opt(None if g_t is None else g_t.contiguous()), p(g_sigma),
        opt(grid_out), opt(g_o), opt(g_d), opt(g_tmax), kbuild.stream_of(ray_o))
    kbuild.check(err, what)
    LAUNCHES_BWD[kind] += 1
    return g_sigma, g_o, g_d, g_tmax


def track_bwd(kind, table, mid, ray_o, ray_d, t_max, key, dim_base, g_w, g_t=None, *,
              grid_out=None, need_rays=False, need_t_max=False):
    """The backward of ad_mode's tracking (track_bwd_plain's arguments and
    results): CPU tensors run track_bwd_plain, CUDA tensors launch T1-bwd
    (kind "delta") or T2-bwd ("ratio")."""
    if not ray_o.is_cuda:
        return track_bwd_plain(kind, table, mid, ray_o, ray_d, t_max, key, dim_base, g_w, g_t,
                               grid_out=grid_out, need_rays=need_rays, need_t_max=need_t_max)
    return _launch_bwd(kind, table, mid, ray_o, ray_d, t_max, key, dim_base, g_w, g_t,
                       grid_out, need_rays, need_t_max)


class _Track(torch.autograd.Function):
    """ad_mode's tracking loop (kind "delta" -> t, weight, scattered; "ratio"
    -> the transmittance) at AD_TRACKING_STEPS steps, differentiable in
    sigma_t, the grid (`source`: the grid sink's token, whose buffer `buf`
    every backward of a pass adds into, or the grid itself with buf None,
    or None), ray_o, ray_d and t_max. CUDA tensors run T1 / T2 and T1-bwd /
    T2-bwd; CPU tensors _scan's values and track_bwd_plain."""

    @staticmethod
    def forward(ctx, sigma_t, source, ray_o, ray_d, t_max, kind, table, mid, key, dim_base,
                buf):
        if ray_o.is_cuda:
            out = _launch(kind, table, mid, ray_o, ray_d, t_max, key, dim_base,
                          AD_TRACKING_STEPS)[:-1]
        else:
            out = _scan(kind, table, mid, ray_o, ray_d, t_max, key, dim_base)
            out = out[:3] if kind == "delta" else out[1:2]
        ctx.kind, ctx.table, ctx.dim_base, ctx.buf = kind, table, dim_base, buf
        ctx.save_for_backward(mid, ray_o, ray_d, t_max, key)
        if kind == "delta":
            ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, *grads):
        mid, ray_o, ray_d, t_max, key = ctx.saved_tensors
        need = ctx.needs_input_grad
        table = ctx.table
        g_w = grads[1] if ctx.kind == "delta" else grads[0]
        g_t = grads[0] if ctx.kind == "delta" else None
        if g_w is None:
            g_w = torch.zeros_like(ray_o)
        grid_out = None
        if need[1]:
            if ctx.buf is None:
                grid_out = new_grid_grad(table.grid)
            else:
                if ctx.buf.grad is None:
                    ctx.buf.grad = new_grid_grad(table.grid)
                grid_out = ctx.buf.grad
        g_sigma, g_o, g_d, g_tmax = track_bwd(
            ctx.kind, table, mid, ray_o, ray_d, t_max, key, ctx.dim_base, g_w, g_t,
            grid_out=grid_out, need_rays=need[2] or need[3], need_t_max=need[4])
        g_source = None
        if need[1]:
            g_source = grid_out if ctx.buf is None else g_w.new_zeros(())
        return (g_sigma if need[0] else None, g_source, g_o if need[2] else None,
                g_d if need[3] else None, g_tmax) + (None,) * 6


def _track(kind, table, mid, ray_o, ray_d, t_max, key, dim_base):
    """ad_mode's tracking through _Track: (t, weight, scattered) for kind
    "delta", (weight,) for "ratio", as _scan's."""
    sink, buf = table.grid_sink, None
    if sink is not None:
        source, buf = sink.token, sink.buf
    else:
        source = table.grid if table.grid.requires_grad else None
    plain = table._replace(sigma_t=table.sigma_t.detach(), grid=table.grid.detach(),
                           grid_sink=None)
    return _Track.apply(table.sigma_t, source, ray_o, ray_d, t_max, kind, plain, mid, key,
                        dim_base, buf)


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
    weighted delta tracking: T1, or in ad_mode the masked scan). Vacuum
    lanes (mid < 0) pass with weight 1. seed: a Python int or a 0-d int64
    tensor; lane: int64 (N,) uint32 lane ids; dim_base: Python int."""
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
    if not table.has_het:
        t_het = torch.zeros(n, device=dev)
        w_het = torch.ones((n, 3), device=dev)
        scat_het = torch.zeros(n, dtype=torch.bool, device=dev)
    elif ad_mode:
        t_het, w_het, scat_het = _track("delta", table, mid, ray_o, ray_d, t_max, key,
                                        dim_base)
    else:
        t_het, w_het, scat_het, _ = delta_track(table, mid, ray_o, ray_d, t_max, key, dim_base)
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
    (T2, or in ad_mode the masked scan: the majorant detached, the (1 -
    sigma / majorant) factors attached) for heterogeneous ones."""
    n, dev = ray_o.shape[0], ray_o.device
    if table.n_media == 0:
        return torch.ones((n, 3), device=dev)
    in_medium = mid >= 0
    safe = mid.clamp(min=0)
    is_het = table.m_type[safe] == HETEROGENEOUS
    sig = _rows(table.sigma_t, safe)
    d_fin = torch.where(torch.isfinite(dist), dist, 1e7)
    tr_hom = torch.exp(-sig * d_fin[:, None])

    key = hash_combine(seed & MASK32, lane)
    if not table.has_het:
        tr_het = torch.ones((n, 3), device=dev)
    elif ad_mode:
        (tr_het,) = _track("ratio", table, mid, ray_o, ray_d, d_fin, key, dim_base)
    else:
        tr_het, _ = ratio_track(table, mid, ray_o, ray_d, d_fin, key, dim_base)
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
