"""K3 and K4: closest-hit and any-hit ray queries over a two-level cluster
structure, one CUDA thread per ray.

PyTorch port of mitsuba_customization_tpu/ops/clusters.py. The host build
is ported as written: primitives are partitioned by recursive widest-axis
median split into CLUSTERS of at most L = 32 prims, emitted in DFS order,
and every GROUP = 16 consecutive clusters form a SUPERCLUSTER with a union
box. The partition, the cluster order and the boxes are the JAX package's;
only the slab layout differs: a cluster's slab is (L, NFIELDS) slot-major
(one 128-byte row of packed fields per prim) instead of the TPU's
(NFIELDS, 128) field-major tile, whose 96 padding lanes are dropped.

The kernels (csrc/cluster_closest.cu replaces `_closest_kernel`,
csrc/cluster_shadow.cu replaces `_shadow_kernel`) keep the TPU kernels'
semantics and epsilons: the root-box exit cap, maxt = inf clamped to 1e30,
lanes with maxt <= 0 returning at once, the slot tests of `_tri_test`,
`_sphere_test` and `_cyl_test`, and the miss fills. They visit
superclusters and clusters in index order; ties between prims at the same
t go to the lowest (cluster, slot), which the plain versions reproduce.

`intersect` and `occluded` pick by device: a CPU tensor goes to the plain
PyTorch versions `intersect_plain` / `occluded_plain`, a CUDA tensor to
the kernel (or it raises).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.ops import build as kbuild
from mitsuba_customization_tpu_torch.render import geometry as geo

SOURCES = {
    "closest": "mitsuba_customization_tpu_torch/csrc/cluster_closest.cu",
    "shadow": "mitsuba_customization_tpu_torch/csrc/cluster_shadow.cu",
}

# Kernel launches in this process (each wrapper adds one per launch).
LAUNCHES = {"closest": 0, "shadow": 0}

L = 32       # prims per cluster (slab slot count)
GROUP = 16   # clusters per supercluster

# Field columns of a slab row (one row per slot), as the JAX package's
# field rows.
F_TYPE = 0            # prim_type (-1 = empty slot)
F_P0 = 1              # 1..3
F_E1 = 4              # 4..6
F_E2 = 7              # 7..9
F_VN0 = 10            # 10..12
F_VN1 = 13            # 13..15
F_VN2 = 16            # 16..18
F_UV0 = 19            # 19..20
F_UV1 = 21            # 21..22
F_UV2 = 23            # 23..24
F_MAT = 25
F_EMIT = 26
F_SHAPE = 27
F_PRIM = 28
NFIELDS = 32          # row length (128 bytes)

BIG = 1e30
# The build's capacity: past it the scene loader raises (the JAX package
# falls back to its skip-link BVH, which the port does not have).
MAX_PRIMS = 1 << 20

# Slab row of a lane that hit nothing.
MISS_ROW = np.zeros(NFIELDS, np.float32)
MISS_ROW[[F_TYPE, F_EMIT, F_SHAPE, F_PRIM]] = -1.0


class ClusterSet(NamedTuple):
    """Device-resident cluster structure.

    sc_box:  (S, 8) f32 supercluster boxes [min xyz, max xyz, pad, pad]
    cl_box:  (C, 8) f32 cluster boxes (empty clusters: inverted box)
    cl_meta: (C,) i32, 1 = the cluster holds non-triangle prims
    slabs:   (C, L, NFIELDS) f32 packed per-prim fields, slot-major
    root:    (8,) f32 union of the supercluster boxes
    """

    sc_box: torch.Tensor
    cl_box: torch.Tensor
    cl_meta: torch.Tensor
    slabs: torch.Tensor
    root: torch.Tensor

    @property
    def n_super(self):
        return self.sc_box.shape[0]


def cluster_set(sc_box, cl_box, cl_meta, slabs, device):
    """ClusterSet on `device` from numpy arrays (slabs slot-major)."""
    sc_box = np.asarray(sc_box, np.float32)
    root = np.zeros(8, np.float32)
    root[0:3] = sc_box[:, 0:3].min(0)
    root[3:6] = sc_box[:, 3:6].max(0)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    return ClusterSet(sc_box=t(sc_box), cl_box=t(cl_box),
                      cl_meta=t(cl_meta, torch.int32), slabs=t(slabs),
                      root=t(root))


# ---------------------------------------------------------------------------
# Host-side build (numpy), as in the JAX package
# ---------------------------------------------------------------------------


def _partition(ids, bb_min, bb_max, out):
    """Recursive widest-axis median split to <= L prims, DFS order."""
    if len(ids) <= L:
        out.append(ids)
        return
    c = 0.5 * (bb_min[ids] + bb_max[ids])
    axis = int(np.argmax(c.max(0) - c.min(0)))
    order = np.argsort(c[:, axis], kind="stable")
    half = len(ids) // 2
    _partition(ids[order[:half]], bb_min, bb_max, out)
    _partition(ids[order[half:]], bb_min, bb_max, out)


def build_arrays(g):
    """Numpy cluster arrays (sc_box, cl_box, cl_meta, slabs) of a Geometry
    given as numpy fields (any object with the Geometry field names)."""
    prim_type = np.asarray(g.prim_type)
    p0, e1, e2 = (np.asarray(a, np.float32) for a in (g.p0, g.e1, g.e2))
    is_tri = prim_type == geo.TRI
    is_cyl = prim_type == geo.CYLINDER
    p1 = p0 + e1
    p2 = p0 + e2
    tri_min = np.minimum(p0, np.minimum(p1, p2))
    tri_max = np.maximum(p0, np.maximum(p1, p2))
    r = e1[:, 0:1]
    rc = e2[:, 0:1]
    bb_min = np.where(
        is_tri[:, None], tri_min,
        np.where(is_cyl[:, None], np.minimum(p0, p1) - rc, p0 - r),
    ).astype(np.float64)
    bb_max = np.where(
        is_tri[:, None], tri_max,
        np.where(is_cyl[:, None], np.maximum(p0, p1) + rc, p0 + r),
    ).astype(np.float64)
    n = prim_type.shape[0]

    clusters: list[np.ndarray] = []
    _partition(np.arange(n, dtype=np.int64), bb_min, bb_max, clusters)

    c_pad = max(GROUP, (len(clusters) + GROUP - 1) // GROUP * GROUP)
    s_count = c_pad // GROUP

    cl_box = np.zeros((c_pad, 8), np.float32)
    cl_box[:, 0:3] = BIG
    cl_box[:, 3:6] = -BIG
    cl_meta = np.zeros((c_pad,), np.int32)
    slabs = np.zeros((c_pad, L, NFIELDS), np.float32)
    slabs[:, :, F_TYPE] = -1.0
    cols = (
        (F_P0, "p0", 3), (F_E1, "e1", 3), (F_E2, "e2", 3),
        (F_VN0, "vn0", 3), (F_VN1, "vn1", 3), (F_VN2, "vn2", 3),
        (F_UV0, "uv0", 2), (F_UV1, "uv1", 2), (F_UV2, "uv2", 2),
        (F_MAT, "mat_id", 1), (F_EMIT, "emitter_id", 1),
        (F_SHAPE, "shape_id", 1),
    )
    fields = {name: np.asarray(getattr(g, name)).reshape(n, -1)
              for _, name, _ in cols}
    for ci, ids in enumerate(clusters):
        cl_box[ci, 0:3] = bb_min[ids].min(0)
        cl_box[ci, 3:6] = bb_max[ids].max(0)
        cl_meta[ci] = int((prim_type[ids] != geo.TRI).any())
        k = len(ids)
        slabs[ci, :k, F_TYPE] = prim_type[ids]
        for col, name, width in cols:
            slabs[ci, :k, col:col + width] = fields[name][ids]
        slabs[ci, :k, F_PRIM] = ids

    sc_box = np.zeros((s_count, 8), np.float32)
    for s in range(s_count):
        grp = cl_box[s * GROUP:(s + 1) * GROUP]
        sc_box[s, 0:3] = grp[:, 0:3].min(0)
        sc_box[s, 3:6] = grp[:, 3:6].max(0)
    return sc_box, cl_box, cl_meta, slabs


def build(g, device) -> ClusterSet:
    """Pack a numpy Geometry into the cluster structure on `device`."""
    return cluster_set(*build_arrays(g), device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
#
# They compute the kernels' function over the same ClusterSet, with the
# same arithmetic written component by component (no fused multiply-add
# on either side): a box test of every supercluster and cluster for a
# chunk of rays, slot tests on the (ray, cluster) pairs that pass, and a
# reduction to the minimum (t, cluster * L + slot). The kernels prune
# clusters against their running best hit; the plain versions test every
# cluster against the initial cap, which can differ only where a prim's
# t rounds below its own box's entry distance.

_RAY_CHUNK_ELEMS = 1 << 22   # rays x clusters per box-test chunk
_PAIR_CHUNK = 1 << 15        # (ray, cluster) pairs per slot-test chunk


def _inv_dir(d):
    return 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _root_cap(cs, o, inv, maxt):
    """Lane setup: (active, maxt clamped to BIG, t cap = min(maxt, root-box
    exit * 1.0001 + 1e-4))."""
    active = maxt > 0.0
    mt = torch.clamp(maxt, max=BIG)
    r = cs.root
    lo = (r[0:3] - o) * inv
    hi = (r[3:6] - o) * inv
    fk = torch.maximum(lo, hi)
    far = torch.minimum(torch.minimum(fk[:, 0], fk[:, 1]), fk[:, 2])
    t_exit = torch.where(far > 0.0, far * 1.0001 + 1e-4, 0.0)
    cap = torch.where(active, torch.clamp(torch.minimum(mt, t_exit), max=BIG), 0.0)
    return active, mt, cap


def _box_pass(box, o, inv, t_cap):
    """(n, B) slab test of rays against boxes: entry <= exit, exit > 0 and
    entry < t_cap."""
    lo = (box[:, 0:3] - o[:, None, :]) * inv[:, None, :]
    hi = (box[:, 3:6] - o[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(lo, hi)
    tmax = torch.maximum(lo, hi)
    near = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    far = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    return (near <= far) & (far > 0.0) & (near < t_cap[:, None])


def _pairs(cs, o, inv, t_cap, active):
    """(ray, cluster) index pairs of live rays whose supercluster and
    cluster boxes pass, in chunks: yields (ray_idx, cluster_idx) int64
    tensors."""
    n = o.shape[0]
    c = cs.cl_box.shape[0]
    chunk = max(1, _RAY_CHUNK_ELEMS // c)
    for a in range(0, n, chunk):
        sl = slice(a, min(n, a + chunk))
        sc_ok = _box_pass(cs.sc_box, o[sl], inv[sl], t_cap[sl])
        ok = sc_ok.repeat_interleave(GROUP, dim=1)[:, :c]
        ok = ok & _box_pass(cs.cl_box, o[sl], inv[sl], t_cap[sl])
        ok = ok & active[sl, None]
        ri, ci = ok.nonzero(as_tuple=True)
        for b in range(0, ri.shape[0], _PAIR_CHUNK):
            yield ri[b:b + _PAIR_CHUNK] + a, ci[b:b + _PAIR_CHUNK]


def _slot_tests(rows, o, d):
    """Slot tests of the JAX package's `_tri_test`, `_sphere_test` and
    `_cyl_test`: rows (..., NFIELDS) against rays o, d (..., 3). Returns
    (t, u, v) with t = BIG on a miss and u = v = 0 off triangles."""
    typ = rows[..., F_TYPE]
    p0x, p0y, p0z = rows[..., F_P0], rows[..., F_P0 + 1], rows[..., F_P0 + 2]
    e1x, e1y, e1z = rows[..., F_E1], rows[..., F_E1 + 1], rows[..., F_E1 + 2]
    e2x, e2y, e2z = rows[..., F_E2], rows[..., F_E2 + 1], rows[..., F_E2 + 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    # triangle (Moller-Trumbore)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = _dot3(e1x, e1y, e1z, px, py, pz)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    u = _dot3(tx, ty, tz, px, py, pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = _dot3(dx, dy, dz, qx, qy, qz) * inv_det
    t_tri = _dot3(e2x, e2y, e2z, qx, qy, qz) * inv_det
    ok = ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t_tri > 0.0))
    t_tri = torch.where(ok, t_tri, BIG)

    # sphere: p0 = centre, e1x = radius
    b = _dot3(tx, ty, tz, dx, dy, dz)
    cc = _dot3(tx, ty, tz, tx, ty, tz) - e1x * e1x
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t_s = torch.where(t0 > 1e-7, t0, t1)
    t_sph = torch.where((disc >= 0.0) & (t_s > 1e-7), t_s, BIG)

    # cylinder: p0 = base, e1 = axis, e2x = radius
    length = torch.sqrt(torch.clamp(_dot3(e1x, e1y, e1z, e1x, e1y, e1z), min=1e-24))
    nx, ny, nz = e1x / length, e1y / length, e1z / length
    d_par = _dot3(dx, dy, dz, nx, ny, nz)
    oc_par = _dot3(tx, ty, tz, nx, ny, nz)
    ddx, ddy, ddz = dx - d_par * nx, dy - d_par * ny, dz - d_par * nz
    oox, ooy, ooz = tx - oc_par * nx, ty - oc_par * ny, tz - oc_par * nz
    qa = _dot3(ddx, ddy, ddz, ddx, ddy, ddz)
    qb = _dot3(ddx, ddy, ddz, oox, ooy, ooz)
    qc = _dot3(oox, ooy, ooz, oox, ooy, ooz) - e2x * e2x
    disc_c = qb * qb - qa * qc
    sq_c = torch.sqrt(torch.clamp(disc_c, min=0.0))
    inv_a = 1.0 / torch.where(qa < 1e-12, 1e-12, qa)
    tc0 = (-qb - sq_c) * inv_a
    tc1 = (-qb + sq_c) * inv_a

    def on_seg(t):
        s = oc_par + t * d_par
        return (t > 1e-7) & (s >= 0.0) & (s <= length)

    ok0, ok1 = on_seg(tc0), on_seg(tc1)
    t_c = torch.where(ok0, tc0, torch.where(ok1, tc1, BIG))
    t_cyl = torch.where((disc_c >= 0.0) & (qa > 1e-12) & (ok0 | ok1), t_c, BIG)

    is_tri = typ == float(geo.TRI)
    t = torch.where(is_tri, t_tri, BIG)
    t = torch.where(typ == float(geo.SPHERE), t_sph, t)
    t = torch.where(typ == float(geo.CYLINDER), t_cyl, t)
    return t, torch.where(is_tri, u, 0.0), torch.where(is_tri, v, 0.0)


def _rays(ray):
    o = ray.o.to(torch.float32).reshape(-1, 3)
    d = ray.d.to(torch.float32).reshape(-1, 3)
    maxt = torch.broadcast_to(ray.maxt, ray.o.shape[:-1]).to(torch.float32).reshape(-1)
    return o, d, maxt


def intersect_plain(cs: ClusterSet, ray):
    """Plain PyTorch K3 -> (t, u, v, fields): t (N,) = +inf on a miss,
    u, v (N,) = 0 on a miss, fields (N, NFIELDS) the winning slab row
    (MISS_ROW on a miss)."""
    o, d, maxt = _rays(ray)
    n = o.shape[0]
    dev = o.device
    inv = _inv_dir(d)
    active, _, t_cap = _root_cap(cs, o, inv, maxt)
    # best (t, code) per lane as one int64 key: t > 0, so its float bits
    # order like the float; the code breaks ties toward the lowest
    # (cluster, slot), the order in which the kernel visits them
    none = torch.iinfo(torch.int64).max
    best = torch.full((n,), none, dtype=torch.int64, device=dev)
    slot_iota = torch.arange(L, device=dev)
    for ri, ci in _pairs(cs, o, inv, t_cap, active):
        rows = cs.slabs[ci]                                    # (P, L, NF)
        t, _, _ = _slot_tests(rows, o[ri][:, None, :], d[ri][:, None, :])
        t_c = t.amin(-1)
        slot = torch.where(t == t_c[:, None], slot_iota, L).amin(-1)
        ok = t_c < t_cap[ri]
        key = (t_c.view(torch.int32).to(torch.int64) << 32) | (ci * L + slot)
        key = torch.where(ok, key, none)
        best.scatter_reduce_(0, ri, key, reduce="amin")
    hit = best != none
    code = torch.where(hit, best & 0xFFFFFFFF, 0)
    t_hit = (best >> 32).to(torch.int32).view(torch.float32)
    rows = cs.slabs[code // L, code % L]                       # (N, NF)
    _, u, v = _slot_tests(rows, o, d)
    miss_row = torch.as_tensor(MISS_ROW, device=dev)
    return (
        torch.where(hit, t_hit, float("inf")),
        torch.where(hit, u, 0.0),
        torch.where(hit, v, 0.0),
        torch.where(hit[:, None], rows, miss_row),
    )


def occluded_plain(cs: ClusterSet, ray):
    """Plain PyTorch K4: (N,) bool, any hit with t < maxt (maxt <= 0:
    False)."""
    o, d, maxt = _rays(ray)
    inv = _inv_dir(d)
    active, mt, t_cap = _root_cap(cs, o, inv, maxt)
    occ = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    for ri, ci in _pairs(cs, o, inv, t_cap, active):
        t, _, _ = _slot_tests(cs.slabs[ci], o[ri][:, None, :], d[ri][:, None, :])
        hit = (t < mt[ri][:, None]).any(-1).to(torch.int32)
        occ.scatter_reduce_(0, ri, hit, reduce="amax")
    return occ > 0


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_cuda(cs, o, d, maxt, what):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or maxt.shape != (n,):
        raise ValueError(f"{what}: rays must be o, d (N, 3) and maxt (N,)")
    c = cs.cl_box.shape[0]
    if (cs.slabs.shape != (c, L, NFIELDS) or cs.sc_box.shape != (c // GROUP, 8)
            or cs.slabs.dtype != torch.float32 or cs.cl_meta.dtype != torch.int32):
        raise ValueError(f"{what}: malformed ClusterSet")
    for t in (d, maxt, *cs):
        if not t.is_cuda or t.device != o.device:
            raise ValueError(f"{what}: rays and ClusterSet must be on one GPU")


def _unpack(t, u, v, fld):
    """(t, prim, u, v, g) from the per-lane outputs (fields as floats)."""
    prim = fld[:, F_PRIM].to(torch.int64)

    def col(c, w):
        return fld[:, c:c + w]

    g = geo.Geometry(
        prim_type=fld[:, F_TYPE].to(torch.int64),
        p0=col(F_P0, 3), e1=col(F_E1, 3), e2=col(F_E2, 3),
        vn0=col(F_VN0, 3), vn1=col(F_VN1, 3), vn2=col(F_VN2, 3),
        uv0=col(F_UV0, 2), uv1=col(F_UV1, 2), uv2=col(F_UV2, 2),
        mat_id=torch.clamp(fld[:, F_MAT], min=0.0).to(torch.int64),
        emitter_id=fld[:, F_EMIT].to(torch.int64),
        shape_id=torch.clamp(fld[:, F_SHAPE], min=0.0).to(torch.int64),
    )
    return t, prim, u, v, g


def intersect(cs: ClusterSet, ray):
    """Closest hit -> (t, prim, u, v, g): g is the per-lane winner Geometry
    row (fields read in the kernel, no gather pass); t = +inf and prim = -1
    on a miss, with mat_id and shape_id 0 and the other fields filled as
    MISS_ROW. CPU tensors run intersect_plain; CUDA tensors launch K3."""
    o, d, maxt = _rays(ray)
    if not o.is_cuda:
        return _unpack(*intersect_plain(cs, ray))
    o, d, maxt = o.contiguous(), d.contiguous(), maxt.contiguous()
    _check_cuda(cs, o, d, maxt, "cluster intersect")
    n = o.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)
    fld = torch.empty((n, NFIELDS), dtype=torch.float32, device=o.device)
    err = kbuild.library().mct_cluster_closest(
        kbuild.ptr(o), kbuild.ptr(d), kbuild.ptr(maxt), n,
        kbuild.ptr(cs.root), kbuild.ptr(cs.sc_box), cs.n_super,
        kbuild.ptr(cs.cl_box), kbuild.ptr(cs.cl_meta), cs.cl_box.shape[0],
        kbuild.ptr(cs.slabs), kbuild.ptr(out[0]), kbuild.ptr(out[1]),
        kbuild.ptr(out[2]), kbuild.ptr(fld), kbuild.stream_of(o),
    )
    kbuild.check(err, "cluster_closest")
    LAUNCHES["closest"] += 1
    return _unpack(out[0], out[1], out[2], fld)


def occluded(cs: ClusterSet, ray):
    """Any hit with t < maxt -> (N,) bool (Scene.ray_test). CPU tensors run
    occluded_plain; CUDA tensors launch K4."""
    o, d, maxt = _rays(ray)
    if not o.is_cuda:
        return occluded_plain(cs, ray)
    o, d, maxt = o.contiguous(), d.contiguous(), maxt.contiguous()
    _check_cuda(cs, o, d, maxt, "cluster occluded")
    n = o.shape[0]
    out = torch.empty((n,), dtype=torch.uint8, device=o.device)
    err = kbuild.library().mct_cluster_shadow(
        kbuild.ptr(o), kbuild.ptr(d), kbuild.ptr(maxt), n,
        kbuild.ptr(cs.root), kbuild.ptr(cs.sc_box), cs.n_super,
        kbuild.ptr(cs.cl_box), kbuild.ptr(cs.cl_meta), cs.cl_box.shape[0],
        kbuild.ptr(cs.slabs), kbuild.ptr(out), kbuild.stream_of(o),
    )
    kbuild.check(err, "cluster_shadow")
    LAUNCHES["shadow"] += 1
    return out.bool()
