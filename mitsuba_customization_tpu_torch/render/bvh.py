"""Skip-link BVH: binned-SAH build, and closest-hit (B1) and any-hit (B2)
traversal, one CUDA thread a ray on the card.

PyTorch port of mitsuba_customization_tpu/render/bvh.py, the JAX package's
intersector for scenes past ops/clusters.MAX_PRIMS. The tree is the JAX
package's, array for array: binned SAH over the prim boxes
(geometry.aabbs), leaves of at most LEAF_SIZE prims (slots padded with
-1), nodes in depth-first order, each with the index of the node to visit
when its subtree is done or its box is missed (its skip link).

`build` gives the JAX numpy builder's arrays, but splits every node of a
depth at once (segment reductions over the prims sorted by node), so no
Python runs per node; pre-order indices and skip links are then assigned
top-down from the subtree sizes. It runs in torch, on the scene's device
past DEVICE_BUILD_MIN prims: on an H100 a 7.2M-prim tree takes 3 s, where
the numpy build took 89 s on its host's CPU. `intersect_plain` / `occluded_plain` are
the JAX lock-step walk in torch (every lane carries one node cursor;
only the live lanes step, and the loop checks on the host every
CHECK_EVERY steps), with the prim tests of geometry._intersect_prims in
its gathered form. `walk_work` counts each lane's node visits and prim
tests of the same walk (the kernels' bound).

`intersect` and `occluded` pick by device: a CPU tensor runs the plain
walk, a CUDA tensor launches csrc/bvh_traverse.cu (B1 `bvh_closest`, B2
`bvh_any`), one thread a ray, or raises. The JAX package has no Pallas
kernel here (its walk is an XLA while_loop). The kernels read the tree
and the geometry packed (`pack_nodes`, `pack_prims`): a node as one
32-byte record with explicit first-child and skip slots, a node's two
children side by side; a prim as one 48-byte record, the leaves' prims
in walk order. `packed` keeps the packs of a (tree, geometry) pair while
neither changes; the loader makes them for a scene traced on the BVH on
the card, and any other pair packs on its first call.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.ops import build as kbuild
from mitsuba_customization_tpu_torch.ops.clusters import _inv_dir, _rays
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.utils import log

LEAF_SIZE = 4
N_BINS = 16
# `build` runs on the scene's device past this many prims, else on the host
DEVICE_BUILD_MIN = 1 << 17

SOURCE = "mitsuba_customization_tpu_torch/csrc/bvh_traverse.cu"
# Kernel launches in this process (each wrapper adds one per launch).
LAUNCHES = {"closest": 0, "any": 0}
# the plain walk's lanes go on stepping this many times between host
# checks for finished lanes
CHECK_EVERY = 8


class BVH(NamedTuple):
    """Flattened BVH in depth-first order with skip links.

    bb_min/bb_max: (N, 3) f32 node bounds
    skip:          (N,) i32 node to visit after this one's subtree (or on
                   a missed box); N past the last
    leaf_prims:    (N, LEAF_SIZE) i32 prim ids, -1 padded; all -1 for
                   internal nodes (whose children follow in depth-first
                   order)
    """

    bb_min: torch.Tensor
    bb_max: torch.Tensor
    skip: torch.Tensor
    leaf_prims: torch.Tensor

    @property
    def n_nodes(self):
        return self.skip.shape[0]


def bvh_from_numpy(bb_min, bb_max, skip, leaf_prims, device) -> BVH:
    """A BVH on `device` from its four numpy arrays."""
    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return BVH(bb_min=t(bb_min, torch.float32), bb_max=t(bb_max, torch.float32),
               skip=t(skip, torch.int32), leaf_prims=t(leaf_prims, torch.int32))


# ---------------------------------------------------------------------------
# Build (torch, on the scene's device)
# ---------------------------------------------------------------------------


def _box_areas(lo, hi):
    """Surface areas of boxes (..., 3) as the JAX builder computes them
    (inf where an extent is not finite)."""
    e = torch.clamp(hi - lo, min=0)
    area = 2 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 0] * e[..., 2])
    return torch.where(torch.isfinite(e).all(-1), area, float("inf"))


def _segment(x, seg, k, how):
    """The least ("amin") or greatest ("amax") row of x (m, 3) in each of k
    segments (seg (m,) the segment of each row), as (k, 3)."""
    init = float("inf") if how == "amin" else float("-inf")
    out = torch.full((k, x.shape[1]), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg[:, None].expand(-1, x.shape[1]), x, how)


def _split_level(ids, cnt, bb_min, bb_max, centroid):
    """Split the internal nodes of one depth: `ids` holds their prims, node
    after node, each node's in its JAX prim_ids order, `cnt` (k,) how many
    each has (all > LEAF_SIZE). Returns (ids reordered so that each node's
    left prims precede its right ones, in the JAX left_ids / right_ids
    order; each node's left count)."""
    dev = ids.device
    k, m = cnt.shape[0], ids.shape[0]
    offs = torch.cumsum(cnt, 0) - cnt
    seg = torch.repeat_interleave(torch.arange(k, device=dev), cnt, output_size=m)
    pos = torch.arange(m, device=dev) - offs[seg]
    c = centroid[ids]
    c_lo = _segment(c, seg, k, "amin")
    ext = _segment(c, seg, k, "amax") - c_lo
    axis = torch.argmax(ext, 1)  # the first widest axis, as np.argmax
    ext_a = ext.gather(1, axis[:, None]).squeeze(1)
    flat = ext_a <= 1e-12          # degenerate: median split in place
    ax = axis[seg][:, None]
    ca = c.gather(1, ax).squeeze(1)
    rel = (ca - c_lo.gather(1, axis[:, None]).squeeze(1)[seg]) / ext_a[seg]
    if bool((torch.isnan(rel) & ~flat[seg]).any()):
        # a centroid past float range has no bin; the JAX builder's
        # np.bincount fails on the key it leaves, with this error
        raise ValueError("'list' argument must have no negative elements")
    bins = torch.where(flat[seg], 0, torch.clamp((rel * N_BINS).to(torch.int64),
                                                 max=N_BINS - 1))

    # per (node, bin): count and box, then prefix / suffix box areas
    key = seg * N_BINS + bins
    counts = torch.bincount(key, minlength=k * N_BINS).reshape(k, N_BINS)
    b_lo = _segment(bb_min[ids], key, k * N_BINS, "amin").reshape(k, N_BINS, 3)
    b_hi = _segment(bb_max[ids], key, k * N_BINS, "amax").reshape(k, N_BINS, 3)
    areas_l = _box_areas(torch.cummin(b_lo, 1).values, torch.cummax(b_hi, 1).values)
    areas_r = _box_areas(torch.cummin(b_lo.flip(1), 1).values.flip(1),
                         torch.cummax(b_hi.flip(1), 1).values.flip(1))
    nl = torch.cumsum(counts, 1)[:, :-1]
    nr = cnt[:, None] - nl
    cost = areas_l[:, :-1] * nl + areas_r[:, 1:] * nr
    # the first split of least cost below inf, among those with prims on
    # both sides
    cost = torch.where((nl > 0) & (nr > 0) & ~torch.isnan(cost), cost, float("inf"))
    best = torch.argmin(cost, 1)
    sah = ~flat & (cost.gather(1, best[:, None]).squeeze(1) < float("inf"))

    # no split below inf: stable sort by the centroid, then a median split
    for j in torch.nonzero(~flat & ~sah).squeeze(1).tolist():
        sl = slice(int(offs[j]), int(offs[j] + cnt[j]))
        order = torch.sort(ca[sl], stable=True).indices
        ids[sl] = ids[sl][order]
    right = torch.where(sah[seg], bins > best[seg], pos >= (cnt // 2)[seg])

    # stable partition of each node's prims: left ones first
    left = (~right).to(torch.int64)
    n_left = torch.bincount(seg[~right], minlength=k)
    before = torch.cumsum(left, 0) - left  # left prims before each prim
    left_rank = before - before[offs][seg]
    dest = offs[seg] + torch.where(right, n_left[seg] + pos - left_rank, left_rank)
    out = torch.empty_like(ids)
    out[dest] = ids
    return out, n_left


def _build_arrays(bb_min, bb_max):
    """((nodes_min, nodes_max, skip, leaf_prims) of the BVH over prim boxes
    (P, 3) given as float64 tensors, on their device: the JAX numpy
    builder's arrays for the same boxes; the tree's depth in edges from the
    root to its deepest leaf)."""
    dev, n = bb_min.device, bb_min.shape[0]
    if n == 0:
        return (torch.zeros((0, 3), device=dev), torch.zeros((0, 3), device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((0, LEAF_SIZE), dtype=torch.int32, device=dev)), 0
    centroid = 0.5 * (bb_min + bb_max)

    # breadth-first levels: each node's prims (a segment of `ids`), its box,
    # its leaf slots; every internal node's two children are consecutive
    # in the next level, the left one first
    levels = []
    ids = torch.arange(n, device=dev)
    cnt = torch.full((1,), n, dtype=torch.int64, device=dev)
    while True:
        k, m = cnt.shape[0], ids.shape[0]
        offs = torch.cumsum(cnt, 0) - cnt
        seg = torch.repeat_interleave(torch.arange(k, device=dev), cnt, output_size=m)
        lo = _segment(bb_min[ids], seg, k, "amin")
        hi = _segment(bb_max[ids], seg, k, "amax")
        is_leaf = cnt <= LEAF_SIZE
        slots = torch.full((k, LEAF_SIZE), -1, dtype=torch.int64, device=dev)
        in_leaf = is_leaf[seg]
        slots[seg[in_leaf], (torch.arange(m, device=dev) - offs[seg])[in_leaf]] = ids[in_leaf]
        levels.append((lo, hi, is_leaf, slots))
        inner = ~is_leaf
        if not bool(inner.any()):
            break
        ids, n_left = _split_level(ids[~in_leaf], cnt[inner], bb_min, bb_max, centroid)
        cnt = torch.stack([n_left, cnt[inner] - n_left], 1).reshape(-1)

    # subtree sizes, bottom-up
    sizes = [None] * len(levels)
    below = torch.zeros(0, dtype=torch.int64, device=dev)
    for li in range(len(levels) - 1, -1, -1):
        is_leaf = levels[li][2]
        size = torch.ones(is_leaf.shape[0], dtype=torch.int64, device=dev)
        size[~is_leaf] += below[0::2] + below[1::2]
        sizes[li] = below = size

    # pre-order indices and skip links, top-down
    n_nodes = int(sizes[0][0])
    nodes_min = torch.empty((n_nodes, 3), device=dev)
    nodes_max = torch.empty((n_nodes, 3), device=dev)
    skip = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    leaf = torch.empty((n_nodes, LEAF_SIZE), dtype=torch.int32, device=dev)
    idx = torch.zeros(1, dtype=torch.int64, device=dev)
    nxt = torch.full((1,), n_nodes, dtype=torch.int64, device=dev)
    for li, (lo, hi, is_leaf, slots) in enumerate(levels):
        nodes_min[idx] = lo.to(torch.float32)
        nodes_max[idx] = hi.to(torch.float32)
        skip[idx] = nxt.to(torch.int32)
        leaf[idx] = slots.to(torch.int32)
        if li + 1 == len(levels):
            break
        inner = ~is_leaf
        left_idx = idx[inner] + 1
        right_idx = left_idx + sizes[li + 1][0::2]
        idx = torch.stack([left_idx, right_idx], 1).reshape(-1)
        nxt = torch.stack([right_idx, nxt[inner]], 1).reshape(-1)
    return (nodes_min, nodes_max, skip, leaf), len(levels) - 1


def build(geom, device) -> BVH:
    """Binned-SAH BVH over a Geometry's prims (tensors on any device, or
    numpy arrays), on `device`: the prim boxes on the host, as the JAX
    builder takes them; the splits in float64 torch operations, which round
    as its numpy ones on any device, on `device` past DEVICE_BUILD_MIN
    prims. Sets the Statistics counters bvh.prims, bvh.nodes and bvh.depth
    to the tree's."""
    g = SimpleNamespace(prim_type=torch.as_tensor(geom.prim_type).cpu(), **{
        f: torch.as_tensor(getattr(geom, f)).cpu().to(torch.float32) for f in ("p0", "e1", "e2")})
    boxes = geo.aabbs(g)
    n = boxes[0].shape[0]
    # on the card a build's ~1,600 small launches cost ~0.7 s, whatever the
    # size: the host builds a tree of fewer prims sooner
    where = device if n > DEVICE_BUILD_MIN else "cpu"
    tree, depth = _build_arrays(*(b.to(device=where, dtype=torch.float64) for b in boxes))
    st = log.Statistics.get()
    st.set("bvh.prims", n)
    st.set("bvh.nodes", tree[2].shape[0])
    st.set("bvh.depth", depth)
    return BVH(*(t.to(device) for t in tree))


# ---------------------------------------------------------------------------
# Plain PyTorch walk (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def _slab_test(bb_min, bb_max, o, inv_d, t_best):
    """Ray-box slab test (the JAX `_slab_test`); returns the hit mask."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return (near <= far) & (far > 0.0) & (near < t_best)


class Work(NamedTuple):
    """What the walk did (`walk_work`): per lane, node visits (box tests)
    and prim tests, (N,) int64; per call, the nodes and prims some lane
    read, (n_nodes,) and (P,) bool."""

    visits: torch.Tensor
    tests: torch.Tensor
    nodes: torch.Tensor
    prims: torch.Tensor


def _walk(tree: BVH, geom, ray, cylinders, any_hit, count=False):
    """The JAX lock-step skip-link walk (bvh.intersect / bvh.occluded),
    stepping only the lanes still walking. A lane with maxt <= 0 (or NaN)
    hits nothing and does not walk: no prim test can pass below it.
    The rays are detached: the results carry no gradient, as the kernels'
    do not. Returns ((t, prim, u, v) or occluded, Work or None)."""
    o, d, maxt = (x.detach() for x in _rays(ray))
    n, dev = o.shape[0], o.device
    n_nodes = tree.n_nodes
    inv_d = _inv_dir(d)
    t_out = maxt.clone()
    prim_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_out = torch.zeros(n, device=dev)
    v_out = torch.zeros(n, device=dev)
    hit_out = torch.zeros(n, dtype=torch.bool, device=dev)
    work = None
    if count:
        work = Work(torch.zeros(n, dtype=torch.int64, device=dev),
                    torch.zeros(n, dtype=torch.int64, device=dev),
                    torch.zeros(n_nodes, dtype=torch.bool, device=dev),
                    torch.zeros(geom.prim_type.shape[0], dtype=torch.bool, device=dev))
    lane = (maxt > 0).nonzero().squeeze(1) if n_nodes else torch.zeros(0, dtype=torch.int64,
                                                                        device=dev)
    # the live lanes' state
    node = torch.zeros(lane.shape[0], dtype=torch.int64, device=dev)
    o_l, d_l, inv_l, mt_l = o[lane], d[lane], inv_d[lane], maxt[lane]
    t_l = mt_l.clone()
    p_l = torch.full_like(node, -1)
    u_l = torch.zeros_like(t_l)
    v_l = torch.zeros_like(t_l)
    h_l = torch.zeros_like(node, dtype=torch.bool)
    slot_iota = torch.arange(LEAF_SIZE, device=dev)
    while lane.shape[0]:
        for _ in range(CHECK_EVERY):
            active = node < n_nodes
            ns = torch.clamp(node, max=n_nodes - 1)
            hit_box = _slab_test(tree.bb_min[ns], tree.bb_max[ns], o_l, inv_l, t_l) & active
            leaf = tree.leaf_prims[ns].to(torch.int64)
            is_leaf = leaf[:, 0] >= 0
            # the prims of the leaves entered, the slots tested in order
            sel = (hit_box & is_leaf).nonzero().squeeze(1)
            pid = leaf[sel]
            valid = pid >= 0
            psafe = torch.clamp(pid, min=0)
            t_i, u_i, v_i = geo._intersect_prims(
                geom, o_l[sel, None, :], d_l[sel, None, :], psafe, cylinders)
            ok = valid & (t_i < mt_l[sel, None])
            if any_hit:
                hit_s = ok.any(1)
                h_l[sel] |= hit_s
                stop = torch.where(ok, slot_iota, LEAF_SIZE).amin(1)
                n_tested = torch.where(hit_s, stop + 1, valid.sum(1))
            else:
                # the first slot of least t: slot after slot with a strict <
                tt = torch.where(ok, t_i, float("inf"))
                t_min = tt.amin(1)
                first = torch.where(tt == t_min[:, None], slot_iota, LEAF_SIZE).amin(1)
                closer = t_min < t_l[sel]
                pick = torch.clamp(first, max=LEAF_SIZE - 1)[:, None]
                upd = sel[closer]
                t_l[upd] = t_min[closer]
                p_l[upd] = psafe.gather(1, pick).squeeze(1)[closer]
                u_l[upd] = u_i.gather(1, pick).squeeze(1)[closer]
                v_l[upd] = v_i.gather(1, pick).squeeze(1)[closer]
                n_tested = valid.sum(1)
            if count:
                work.visits[lane] += active
                work.tests[lane[sel]] += n_tested
                work.nodes[ns[active]] = True
                if any_hit:
                    valid = valid & (slot_iota <= stop[:, None])
                work.prims[pid[valid]] = True
            nxt = torch.where(hit_box & ~is_leaf, ns + 1, tree.skip[ns].to(torch.int64))
            if any_hit:
                nxt = torch.where(h_l, n_nodes, nxt)
            node = torch.where(active, nxt, node)
        done = node >= n_nodes
        fin = lane[done]
        if any_hit:
            hit_out[fin] = h_l[done]
        else:
            t_out[fin], prim_out[fin] = t_l[done], p_l[done]
            u_out[fin], v_out[fin] = u_l[done], v_l[done]
        keep = ~done
        lane, node, o_l, d_l, inv_l, mt_l = (x[keep] for x in (lane, node, o_l, d_l, inv_l,
                                                               mt_l))
        t_l, p_l, u_l, v_l, h_l = (x[keep] for x in (t_l, p_l, u_l, v_l, h_l))
    if any_hit:
        return hit_out, work
    miss = prim_out < 0
    return (torch.where(miss, float("inf"), t_out), prim_out, u_out, v_out), work


def intersect_plain(tree: BVH, geom, ray, cylinders=True):
    """Plain B1: nearest hit -> (t, prim, u, v), each (N,): t = +inf, prim =
    -1 and u = v = 0 on a miss, as JAX bvh.intersect returns them."""
    return _walk(tree, geom, ray, cylinders, any_hit=False)[0]


def occluded_plain(tree: BVH, geom, ray, cylinders=True):
    """Plain B2: any hit with t < maxt -> (N,) bool (JAX bvh.occluded)."""
    return _walk(tree, geom, ray, cylinders, any_hit=True)[0]


def walk_work(tree: BVH, geom, ray, cylinders=True, any_hit=False):
    """(result, Work) of the walk over these rays: the plain version's
    result and, per lane, the node visits and prim tests it made (B2's up
    to its first hit), with the nodes and prims some lane read."""
    return _walk(tree, geom, ray, cylinders, any_hit, count=True)


# ---------------------------------------------------------------------------
# The kernels' packed storage
# ---------------------------------------------------------------------------


class NodePack(NamedTuple):
    """The kernels' storage of a BVH's nodes (`pack_nodes`): one 32-byte
    record a node.

    nodes: (N, 8) i32 records by storage slot: bb_min.xyz (float bits) and
           `first` (an internal node's first child's slot; a leaf's
           ~(start << 3 | count), its prims in the prim pack), then
           bb_max.xyz and the skip link's slot (-1 past the last node)
    order: (N,) i64, the storage slot of each pre-order node: the root at
           0, then each internal node's two children side by side, the
           pairs in their parents' pre-order
    depth: the tree's depth, in edges from the root to the deepest leaf
    """

    nodes: torch.Tensor
    order: torch.Tensor
    depth: int


def _i32(x):
    """The bits of a float32 tensor as int32 (a contiguous copy)."""
    return x.detach().to(torch.float32).contiguous().view(torch.int32)


def pack_nodes(tree: BVH) -> NodePack:
    """The kernels' node records of `tree`, on its device. The records
    encode the tree's pre-order skip-link walk through explicit slots;
    only the storage differs from the pre-order numbering: a node's two
    children sit side by side (B2 loads both boxes at once)."""
    dev, n = tree.skip.device, tree.n_nodes
    if n == 0:
        return NodePack(torch.zeros((0, 8), dtype=torch.int32, device=dev),
                        torch.zeros(0, dtype=torch.int64, device=dev), 0)
    skip = tree.skip.to(torch.int64)
    slots = tree.leaf_prims.to(torch.int64)
    is_leaf = slots[:, 0] >= 0
    inner = (~is_leaf).nonzero().squeeze(1)  # pre-order
    left = inner + 1
    right = skip[left]
    pair = torch.arange(inner.shape[0], device=dev)
    order = torch.zeros(n, dtype=torch.int64, device=dev)
    order[left] = 1 + 2 * pair
    order[right] = 2 + 2 * pair
    # depth by pointer jumping over the parent links
    up = torch.zeros(n, dtype=torch.int64, device=dev)
    up[left] = inner
    up[right] = inner
    depth = (torch.arange(n, device=dev) > 0).to(torch.int64)
    while bool((up > 0).any()):
        depth, up = depth + depth[up], up[up]

    count = (slots >= 0).sum(1)
    start = torch.cumsum(count, 0) - count
    if int(start[-1] + count[-1]) >= 1 << 28:
        raise ValueError("pack_nodes: more than 2**28 prims")
    nxt = order[torch.clamp(torch.arange(n, device=dev) + 1, max=n - 1)]
    first = torch.where(is_leaf, -(start * 8 + count) - 1, nxt)
    skip_slot = torch.where(skip < n, order[torch.clamp(skip, max=n - 1)], -1)
    recs = torch.cat([_i32(tree.bb_min), first[:, None].to(torch.int32), _i32(tree.bb_max),
                      skip_slot[:, None].to(torch.int32)], 1)
    nodes = torch.empty_like(recs)
    nodes[order] = recs
    return NodePack(nodes, order, int(depth.max()))


def pack_prims(tree: BVH, geom) -> torch.Tensor:
    """(P, 12) i32: one 48-byte record a prim of the tree's leaves, in walk
    order (leaf after leaf in pre-order, slot order kept): p0.xyz (float
    bits) and the prim type, e1.xyz and the prim's id, e2.xyz and 0."""
    slots = tree.leaf_prims.to(torch.int64)
    ids = slots[slots >= 0]
    dev = slots.device
    return torch.cat([_i32(geom.p0[ids]), geom.prim_type[ids].to(torch.int32)[:, None],
                      _i32(geom.e1[ids]), ids.to(torch.int32)[:, None], _i32(geom.e2[ids]),
                      torch.zeros((ids.shape[0], 1), dtype=torch.int32, device=dev)], 1)


# (kind, (id, _version) of each tensor keyed on) -> (weak references to
# those tensors, the pack). An in-place edit bumps a version, so the pack
# is made anew; an entry goes when one of its tensors is freed, and the
# least recently used go past PACK_CACHE_SIZE entries.
_PACKS: OrderedDict = OrderedDict()
PACK_CACHE_SIZE = 8


def _cached(kind, tensors, make):
    key = (kind,) + tuple((id(t), t._version) for t in tensors)
    hit = _PACKS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        _PACKS.move_to_end(key)
        return hit[1]
    out = make()

    def drop(_, key=key):
        _PACKS.pop(key, None)

    _PACKS[key] = (tuple(weakref.ref(t, drop) for t in tensors), out)
    while len(_PACKS) > PACK_CACHE_SIZE:
        _PACKS.popitem(last=False)
    return out


def packed(tree: BVH, geom):
    """(NodePack, prim pack) of the tree and a geometry, made once and kept
    while neither changes (the loader makes them for a scene traced on the
    BVH on the card, so that no frame of it packs)."""
    nodes = _cached("nodes", tuple(tree), lambda: pack_nodes(tree))
    prims = _cached("prims", (tree.leaf_prims, geom.prim_type, geom.p0, geom.e1, geom.e2),
                    lambda: pack_prims(tree, geom))
    return nodes, prims


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_cuda(tree, geom, o, d, maxt, what):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or maxt.shape != (n,):
        raise ValueError(f"{what}: rays must be o, d (N, 3) and maxt (N,)")
    k = tree.n_nodes
    if (tree.bb_min.shape != (k, 3) or tree.bb_max.shape != (k, 3)
            or tree.leaf_prims.shape != (k, LEAF_SIZE) or tree.bb_min.dtype != torch.float32
            or tree.bb_max.dtype != torch.float32 or tree.skip.dtype != torch.int32
            or tree.leaf_prims.dtype != torch.int32):
        raise ValueError(f"{what}: malformed BVH")
    p = geom.prim_type.shape[0]
    if (geom.prim_type.dtype != torch.int64
            or any(f.shape != (p, 3) or f.dtype != torch.float32
                   for f in (geom.p0, geom.e1, geom.e2))):
        raise ValueError(f"{what}: the geometry's prim_type must be int64 (P,) and p0, e1, "
                         "e2 float32 (P, 3)")
    for t in (d, maxt, *tree, geom.prim_type, geom.p0, geom.e1, geom.e2):
        if not t.is_cuda or t.device != o.device:
            raise ValueError(f"{what}: rays, BVH and geometry must be on one GPU")


def _launch(kind, tree, geom, o, d, maxt, cylinders, out):
    """Launch B1 (kind "closest", out (t, u, v, prim)) or B2 ("any", out
    the occlusion bytes) on the packed storage of (tree, geom)."""
    nodes, prims = packed(tree, geom)
    p = kbuild.ptr
    args = (p(o), p(d), p(maxt), o.shape[0], p(nodes.nodes), tree.n_nodes, p(prims),
            int(bool(cylinders)))
    lib = kbuild.library()
    if kind == "closest":
        err = lib.mct_bvh_closest(*args, *map(p, out), kbuild.stream_of(o))
    else:
        err = lib.mct_bvh_any(*args, nodes.depth, p(out), kbuild.stream_of(o))
    kbuild.check(err, "bvh_" + kind)
    LAUNCHES[kind] += 1


def intersect(tree: BVH, geom, ray, cylinders=True):
    """Nearest hit -> (t, prim, u, v) as intersect_plain returns them. CPU
    tensors run intersect_plain; CUDA tensors launch B1."""
    o, d, maxt = _rays(ray)
    if not o.is_cuda:
        return intersect_plain(tree, geom, ray, cylinders)
    o, d, maxt = o.contiguous(), d.contiguous(), maxt.contiguous()
    _check_cuda(tree, geom, o, d, maxt, "bvh intersect")
    n = o.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    _launch("closest", tree, geom, o, d, maxt, cylinders, (out[0], out[1], out[2], prim))
    return out[0], prim.to(torch.int64), out[1], out[2]


def occluded(tree: BVH, geom, ray, cylinders=True):
    """Any hit with t < maxt -> (N,) bool (Scene.ray_test). CPU tensors run
    occluded_plain; CUDA tensors launch B2."""
    o, d, maxt = _rays(ray)
    if not o.is_cuda:
        return occluded_plain(tree, geom, ray, cylinders)
    o, d, maxt = o.contiguous(), d.contiguous(), maxt.contiguous()
    _check_cuda(tree, geom, o, d, maxt, "bvh occluded")
    out = torch.empty(o.shape[0], dtype=torch.uint8, device=o.device)
    _launch("any", tree, geom, o, d, maxt, cylinders, out)
    return out.bool()
