"""Signed-distance-field grid shape (mitsuba3 src/shapes/sdfgrid.cpp).

PyTorch port of mitsuba_customization_tpu/render/sdf.py: a regular (Nx,
Ny, Nz) grid of signed distances over the local unit cube [0,1]^3, placed
by `to_world`, intersected by lock-step sphere tracing (every live lane
advances t += max(sdf(p), HIT_EPS) / |d_local| each step, at most
MAX_STEPS steps). The grid is its own acceleration structure: it does not
join the prim soup or the cluster set. Trilinear samples read the grid by
flat index (`index_select`).

The JAX package's loop stops once no lane is active. Here the march is
the kernel S1 (`march`, csrc/sdf_march.cu): one thread a lane marches its
own lane while it is active, at most MAX_STEPS steps, with no read back
to the host, so a captured frame holds it. Its plain version
(`march_plain`) runs the lock-step loop in torch and checks every
CHECK_EVERY steps whether any lane is active (a host sync each): a lane
that is no longer active does not change, so both give the JAX package's
t and hit flag. S1 reads the grid's corner layout (`corner_layout`, four
values a node, SDFGrid.corners), which `make` and params build beside
the values when a grid is made. The march is not differentiable: as `jax.grad` through
the JAX package's while_loop does, it raises where an input requires
grad under grad mode (medium.py's tracking loops follow the same rule).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.frame import Frame
from mitsuba_customization_tpu_torch.ops import build as kbuild
from mitsuba_customization_tpu_torch.render.records import Ray, SurfaceInteraction

MAX_STEPS = 128
HIT_EPS = 1e-4
CHECK_EVERY = 8

SOURCE = "mitsuba_customization_tpu_torch/csrc/sdf_march.cu"
# S1 launches (a replay of a captured frame launches without calling the
# wrapper: count those in its trace)
LAUNCHES = 0
# None, or a list to which each march appends each lane's steps ((N,)
# int32 on the lanes' device) and its host checks: set it to [] to record
# (chip_smoke and the frame profile do), and read the steps after the
# frame
MARCHES = None


class SDFGrid(NamedTuple):
    """One SDF grid shape: values (Nx, Ny, Nz) f32 signed distances at the
    grid nodes over the local unit cube (x-major); to_world, to_local (4,
    4); scale () the smallest axis scale of to_world; mat_id, shape_id ()
    int64; corners (Nx, Ny, Nz, 4) f32 corner_layout(values), which S1
    reads (derived: the JAX package's grid has no such field)."""

    values: torch.Tensor
    to_world: torch.Tensor
    to_local: torch.Tensor
    scale: torch.Tensor
    mat_id: torch.Tensor
    shape_id: torch.Tensor
    corners: torch.Tensor


def corner_layout(values):
    """S1's copy of a grid (Nx, Ny, Nz): (Nx, Ny, Nz, 4) f32 holding at each
    node (x, y, z) the values at (x, y, z), (x, y, z + 1), (x, y + 1, z) and
    (x, y + 1, z + 1), the last node of an axis standing in for the one past
    it (a cell's lower node is at most N - 2 on each axis, so those are
    never read). A cell's eight corners are then the four at its lower node
    and the four a step along x (cell_corners). 4x the grid's memory."""
    v = values.detach()
    v = torch.cat([v, v[:, :, -1:]], 2)
    v = torch.cat([v, v[:, -1:, :]], 1)
    return torch.stack([v[:, :-1, :-1], v[:, :-1, 1:], v[:, 1:, :-1], v[:, 1:, 1:]],
                       -1).contiguous()


def cell_corners(corners, x0, y0, z0):
    """The eight corner values of the cells with lower node (x0, y0, z0),
    read from a corner layout as S1 reads them (flat float4 index (x0 Ny +
    y0) Nz + z0 and that plus Ny Nz): (..., 8) in (dx, dy, dz) order 000,
    001, 010, 011, 100, 101, 110, 111."""
    _, ny, nz, _ = corners.shape
    flat = corners.reshape(-1, 4)
    node = (x0 * ny + y0) * nz + z0
    return torch.cat([flat[node], flat[node + ny * nz]], -1)


def make(values, to_world=None, mat_id=0, shape_id=0, *, device):
    """An SDFGrid on `device` from a numpy grid and placement."""
    tw = (np.eye(4, dtype=np.float32) if to_world is None
          else np.asarray(to_world, np.float32))
    tl = np.linalg.inv(tw.astype(np.float64)).astype(np.float32)
    axis_scale = np.linalg.norm(tw[:3, :3], axis=0)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    grid = dev(np.asarray(values, np.float32))
    return SDFGrid(
        values=grid,
        to_world=dev(tw),
        to_local=dev(tl),
        scale=dev(np.float32(axis_scale.min())),
        mat_id=dev(int(mat_id), torch.int64),
        shape_id=dev(int(shape_id), torch.int64),
        corners=corner_layout(grid),
    )


def cell(sdf: SDFGrid, p_local):
    """The flat index of each local position's cell corner (x0, y0, z0) in
    the x-major grid, and its fractions (fx, fy, fz), clamped to the grid
    support."""
    nx, ny, nz = sdf.values.shape

    def axis(a, n):  # the cell and fraction along axis a of n nodes
        u = p_local[..., a] * float(n - 1)
        i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 2)
        return i0, torch.clamp(u - i0, 0.0, 1.0)

    (x0, fx), (y0, fy), (z0, fz) = axis(0, nx), axis(1, ny), axis(2, nz)
    return (x0 * ny + y0) * nz + z0, fx, fy, fz


def sample(sdf: SDFGrid, p_local):
    """Trilinear SDF value at local positions (..., 3), clamped to the grid
    support; distances in local units."""
    _, ny, nz = sdf.values.shape
    base, fx, fy, fz = cell(sdf, p_local)
    flat = sdf.values.reshape(-1)

    def at(dx, dy, dz):
        idx = base + ((dx * ny + dy) * nz + dz)
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)

    c00 = at(0, 0, 0) * (1 - fz) + at(0, 0, 1) * fz
    c01 = at(0, 1, 0) * (1 - fz) + at(0, 1, 1) * fz
    c10 = at(1, 0, 0) * (1 - fz) + at(1, 0, 1) * fz
    c11 = at(1, 1, 0) * (1 - fz) + at(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def normal(sdf: SDFGrid, p_local):
    """World-space normal from central differences of the local SDF."""
    h = 1.0 / float(max(sdf.values.shape))
    e = torch.eye(3, dtype=torch.float32, device=p_local.device) * h

    def d(axis):
        return sample(sdf, p_local + e[axis]) - sample(sdf, p_local - e[axis])

    g_local = torch.stack([d(0), d(1), d(2)], -1)
    # normals transform by the inverse transpose of to_world
    g_world = g_local @ sdf.to_local[:3, :3]
    return m.normalize(g_world + 1e-20)


def march_plain(sdf: SDFGrid, o_l, d_l, t_start, t_end, d_norm, active):
    """S1's plain version: the lock-step sphere trace in torch, a host
    check every CHECK_EVERY steps. Returns (t (N,), hit (N,) bool, steps
    (N,) int32 each lane's active steps)."""
    with torch.no_grad():
        t, hit = t_start, torch.zeros_like(active)
        steps = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        done = checks = 0
        while done < MAX_STEPS:
            if done % CHECK_EVERY == 0:
                checks += 1
                if not bool(active.any()):
                    break
            dist = sample(sdf, o_l + t[..., None] * d_l)
            is_hit = active & (dist < HIT_EPS)
            # conservative march: local distance -> world t through |d_l|
            step = torch.clamp(dist, min=HIT_EPS) / d_norm
            steps = steps + active.to(torch.int32)
            t = torch.where(active & ~is_hit, t + step, t)
            active = active & ~is_hit & (t <= t_end)
            hit = hit | is_hit
            done += 1
    if MARCHES is not None:
        MARCHES.append((steps, checks))
    return t, hit, steps


def _check_cuda(sdf, tensors):
    n = tensors[0].shape[0]
    if (tensors[0].shape != (n, 3) or tensors[1].shape != (n, 3)
            or any(t.shape != (n,) for t in tensors[2:])):
        raise ValueError("sdf march: o, d must be (N, 3) and t_start, t_end, d_norm, active "
                         "(N,)")
    if (sdf.values.dim() != 3 or min(sdf.values.shape) < 2 or sdf.values.dtype != torch.float32
            or sdf.values.numel() >= 1 << 29
            or sdf.corners.shape != sdf.values.shape + (4,)
            or sdf.corners.dtype != torch.float32 or not sdf.corners.is_contiguous()
            or sdf.corners.data_ptr() % 16
            or any(t.dtype != torch.float32 for t in tensors[:5])
            or tensors[5].dtype != torch.bool):
        raise ValueError("sdf march: a float32 grid of 2 to 2^29 nodes with at least 2 an axis "
                         "and its contiguous, 16-byte aligned corner layout, float32 rays and a "
                         "bool active flag")
    for t in (sdf.values, sdf.corners, *tensors):
        if not t.is_cuda or t.device != tensors[0].device:
            raise ValueError("sdf march: rays and grid must be on one GPU")


def march(sdf: SDFGrid, o_l, d_l, t_start, t_end, d_norm, active):
    """The sphere trace of each lane through the grid (its ray o_l, d_l in
    the local frame, from t_start, active while t <= t_end; d_norm the
    local units per world t; active the lanes that enter the unit cube
    before maxt): (t (N,), hit (N,) bool, steps (N,) int32). CPU tensors
    run march_plain; CUDA tensors launch S1. Not differentiable: raises
    where the grid or a ray input requires grad under grad mode."""
    global LAUNCHES
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (sdf.values, o_l, d_l, t_start, t_end, d_norm)):
        raise RuntimeError("the SDF march has no gradient (as the JAX package's while_loop); "
                           "march rays and a grid that do not require grad, or run under "
                           "torch.no_grad()")
    if not o_l.is_cuda:
        return march_plain(sdf, o_l, d_l, t_start, t_end, d_norm, active)
    args = tuple(x.contiguous() for x in (o_l, d_l, t_start, t_end, d_norm, active))
    _check_cuda(sdf, args)
    n, dev = o_l.shape[0], o_l.device
    t = torch.empty(n, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    p = kbuild.ptr
    err = kbuild.library().mct_sdf_march(*map(p, args), n, p(sdf.corners), *sdf.values.shape,
                                         p(t), p(hit), p(steps), kbuild.stream_of(o_l))
    kbuild.check(err, "sdf march")
    LAUNCHES += 1
    if MARCHES is not None:
        MARCHES.append((steps, 0))
    return t, hit, steps


def intersect(sdf: SDFGrid, ray: Ray):
    """Sphere-trace the nearest hit (`march`). Returns (t_world, hit,
    p_local)."""
    rot = sdf.to_local[:3, :3]
    o_l = ray.o @ rot.T + sdf.to_local[:3, 3]
    d_l = ray.d @ rot.T  # not normalised: t stays in world units

    # clip to the local unit cube
    inv = 1.0 / torch.where(d_l.abs() < 1e-12, 1e-12, d_l)
    t0 = (0.0 - o_l) * inv
    t1 = (1.0 - o_l) * inv
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    enters = (near <= far) & (far > 0.0)
    t = torch.clamp(near, min=0.0) + 1e-5
    t_end = torch.minimum(far, ray.maxt)
    d_norm = torch.clamp(m.norm(d_l), min=1e-12)  # local units per world t
    t, hit, _ = march(sdf, o_l, d_l, t, t_end, d_norm, enters & (t < ray.maxt))
    p_local = o_l + t[..., None] * d_l
    return torch.where(hit, t, float("inf")), hit, p_local


def interaction(sdf: SDFGrid, ray: Ray, t, hit, p_local):
    """SurfaceInteraction of SDF hits. prim is 0 (as in the JAX package):
    an SDF is never an emitter, so emitter = -1 masks the prim lookups."""
    p = ray.o + ray.d * torch.where(hit, t, 0.0)[..., None]
    n = normal(sdf, p_local)
    # two-sided shading: flip toward the ray, as the mesh path does
    facing = m.dot(n, ray.d) < 0.0
    frame = Frame.from_normal(torch.where(facing[..., None], n, -n))
    zero = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
    return SurfaceInteraction(
        valid=hit, t=t, p=p, n=n, frame=frame,
        uv=torch.stack([p_local[..., 0], p_local[..., 1]], -1),
        wi=frame.to_local(-ray.d), prim=zero, mat_id=zero + sdf.mat_id,
        emitter=zero - 1, bary=torch.zeros(t.shape + (2,), device=t.device),
    )


def merge_interaction(si: SurfaceInteraction, si_sdf: SurfaceInteraction):
    """The nearer of a soup hit and an SDF hit, per lane."""
    closer = si_sdf.valid & (~si.valid | (si_sdf.t < si.t))

    def pick(a, b):
        if isinstance(a, Frame):
            return Frame(*(pick(x, y) for x, y in zip(a, b)))
        c = closer.reshape(closer.shape + (1,) * (a.dim() - closer.dim()))
        return torch.where(c, a, b)

    return SurfaceInteraction(*(pick(a, b) for a, b in zip(si_sdf, si)))


def sphere_sdf(n=32, center=(0.5, 0.5, 0.5), radius=0.35):
    """Analytic-sphere SDF grid (exact distances), numpy f32."""
    ax = (np.arange(n) + 0.0) / (n - 1)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    d = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                + (z - center[2]) ** 2) - radius
    return d.astype(np.float32)
