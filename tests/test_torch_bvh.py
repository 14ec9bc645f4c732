"""The port's skip-link BVH (render/bvh.py) against the JAX package's
(mitsuba_customization_tpu/render/bvh.py).

The build against the JAX numpy builder (the JAX package's C++ builder
switched off in the test): every array equal, on random soups of
triangles, spheres and cylinders, a degenerate one (coplanar prims, half
of them coincident: the median split of a node without extent) and single
prims. The plain walks (the CPU path and the CUDA kernels' reference)
against JAX `bvh.intersect` / `bvh.occluded` on the same tree and rays,
and against the brute-force intersectors; `walk_work` against a scalar
walk. The loader past a lowered `clusters.MAX_PRIMS` against the JAX
loader, and 16x16 frames on the "bvh" intersector against the JAX frames
and the port's cluster frames, on a path scene and a volpath scene with a
null cube (shadow rays walk the tree over the shadow geometry). The CUDA
kernels B1 / B2 themselves run only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: the builders' arrays equal. The walks visit the same nodes
and test the same prims, so prims and occlusion are equal; t, u and v
differ by rounding, as the port's gathered prim tests round every product
and sum on its own where XLA fuses the JAX dot products and crosses into
FMAs and reorders their sums: t within rtol 1e-4 / atol 1e-6 (measured at
most 3.2e-4 relative, on a hit at t = 6e-6, and 1.8e-5 on a sphere's
grazing hit), u and v within atol 1e-5 (measured 3.6e-6). Against brute
force the prim agrees on >= 99.5 % of lanes (ties), as JAX
`test_bvh_matches_brute` holds. Frames: per-channel means within 1 % (2 %
for the volpath frame, as tests/test_torch_volpath.py) and the per-pixel
Z-test of tests/reference_renderer.ztest_images.
"""

import dataclasses
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu import native
from mitsuba_customization_tpu.ops import clusters as jcl
from mitsuba_customization_tpu.render import bvh as jbvh
from mitsuba_customization_tpu.render import geometry as jgeo
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu.render.records import Ray as JRay
from mitsuba_customization_tpu_torch.ops import clusters as tcl
from mitsuba_customization_tpu_torch.render import bvh as tbvh
from mitsuba_customization_tpu_torch.render import geometry as tgeo
from mitsuba_customization_tpu_torch.render import integrator as tint
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.render.scene import geometry_from_numpy
from mitsuba_customization_tpu_torch.scenes import matpreview_dict
from mitsuba_customization_tpu_torch.utils.meshgen import icosphere_blob
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_volpath import scene_dict as volpath_scene_dict

T_RTOL, T_ATOL, UV_ATOL = 1e-4, 1e-6, 1e-5
BRUTE_AGREE = 0.995


@pytest.fixture
def numpy_builder(monkeypatch):
    """The JAX package builds with its numpy builder (the reference), not
    its C++ one."""
    monkeypatch.setattr(native, "available", lambda: False)


def _soup(rng, n_tri=0, n_sph=0, n_cyl=0, degenerate=False):
    """Numpy Geometry fields of a random soup in [-1, 1]^3: small
    triangles, spheres (radius in e1.x) and cylinders (axis e1, radius in
    e2.x). degenerate: the triangles lie in z = 0 and the first half of
    them coincide."""
    tri = [rng.uniform(a, b, (n_tri, 3)) for a, b in ((-1, 1), (-0.2, 0.2), (-0.2, 0.2))]
    if degenerate:
        for x in tri:
            x[:, 2] = 0.0
            x[: n_tri // 2] = x[0]
    pad = np.zeros((n_sph, 2))
    sph = [rng.uniform(-1, 1, (n_sph, 3)),
           np.concatenate([rng.uniform(0.05, 0.2, (n_sph, 1)), pad], 1), np.zeros((n_sph, 3))]
    cyl = [rng.uniform(-1, 1, (n_cyl, 3)), rng.uniform(-0.3, 0.3, (n_cyl, 3)),
           np.concatenate([rng.uniform(0.02, 0.1, (n_cyl, 1)), np.zeros((n_cyl, 2))], 1)]
    p = n_tri + n_sph + n_cyl
    f = {k: np.concatenate([tri[i], sph[i], cyl[i]]).astype(np.float32)
         for i, k in enumerate(("p0", "e1", "e2"))}
    f["prim_type"] = np.repeat(np.array([jgeo.TRI, jgeo.SPHERE, jgeo.CYLINDER], np.int32),
                               [n_tri, n_sph, n_cyl])
    for k in ("vn0", "vn1", "vn2"):
        f[k] = np.zeros((p, 3), np.float32)
    for k in ("uv0", "uv1", "uv2"):
        f[k] = np.zeros((p, 2), np.float32)
    f["mat_id"] = np.zeros(p, np.int32)
    f["emitter_id"] = np.full(p, -1, np.int32)
    f["shape_id"] = np.zeros(p, np.int32)
    return f


def _both(f):
    """(JAX Geometry, port Geometry on the CPU) of numpy fields."""
    return (jgeo.Geometry(**{k: jnp.asarray(v) for k, v in f.items()}),
            geometry_from_numpy(f, "cpu"))


def _rays(rng, n, maxt_kind="mixed"):
    """(o, d, maxt) numpy: origins in [-2, 2]^3, unit directions (the first
    64 with a zero y component); maxt inf, or mixed: a third of the lanes
    capped in [0.2, 2], every 17th 0."""
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:64, 1] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(n, np.inf, np.float32)
    if maxt_kind == "mixed":
        cap = np.arange(n) % 3 == 0
        maxt[cap] = rng.uniform(0.2, 2.0, int(cap.sum()))
        maxt[::17] = 0.0
    return o, d, maxt


SOUPS = {
    "triangles_spheres": dict(n_tri=600, n_sph=60),
    "cylinders": dict(n_tri=40, n_cyl=200),
    "degenerate": dict(n_tri=400, degenerate=True),
    "single_triangle": dict(n_tri=1),
    "single_sphere": dict(n_sph=1),
    "one_leaf_and_a_split": dict(n_tri=3, n_sph=2, n_cyl=1),
}


@pytest.mark.parametrize("soup", sorted(SOUPS))
def test_build_matches_the_jax_numpy_builder(soup, numpy_builder):
    """Every array of the tree equal: boxes, skip links, leaf slots (the
    left/right prim order and the slot order decide the walk's ties)."""
    jg, tg = _both(_soup(np.random.default_rng(7), **SOUPS[soup]))
    want = jbvh.build(jg)
    got = tbvh.build(tg, "cpu")
    assert got.n_nodes == want.n_nodes
    for f, a, b in zip(tbvh.BVH._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert got.skip.dtype == got.leaf_prims.dtype == torch.int32
    if soup == "degenerate":
        # a node of coincident prims has no extent: split at the median
        # in place, as the JAX builder does
        slots = got.leaf_prims.numpy()
        coincident = (slots[:, 0] >= 0) & (slots < 200).all(1)
        assert int(coincident.sum()) >= 200 // tbvh.LEAF_SIZE


def test_build_refuses_an_infinite_box_as_the_jax_builder_does(numpy_builder):
    """A prim box past float range gives a centroid the binning cannot
    place: both builders raise the same error (so the JAX builder's
    non-finite-area guard and its median fallback for a node without a
    finite split are never reached by boxes that build)."""
    f = _soup(np.random.default_rng(1), n_tri=20)
    f["e1"][3] = [np.inf, 0.0, 0.0]
    jg, tg = _both(f)
    with pytest.raises(ValueError) as want:
        jbvh.build(jg)
    with pytest.raises(ValueError) as got:
        tbvh.build(tg, "cpu")
    assert str(got.value) == str(want.value)


def test_split_without_a_finite_cost_sorts_and_halves():
    """The median fallback of a node whose every split costs inf (boxes of
    infinite area with finite centroids, which only a direct call can
    give): its prims stably sorted by the split axis's centroid, the first
    half left, as the JAX builder's `best_split is None` branch does."""
    rng = np.random.default_rng(3)
    n = 12
    centroid = rng.uniform(-1, 1, (n, 3))
    centroid[:, 0] *= 4.0          # x is the widest axis
    centroid[5, 0] = centroid[2, 0]  # a tie, kept in order
    bb_min = np.full((n, 3), -np.inf)
    bb_max = np.full((n, 3), np.inf)
    ids = rng.permutation(n)
    out, n_left = tbvh._split_level(*(torch.tensor(a) for a in (ids, [n], bb_min, bb_max,
                                                                 centroid)))
    order = ids[np.argsort(centroid[ids, 0], kind="stable")]
    np.testing.assert_array_equal(out, order)
    assert n_left.tolist() == [n // 2]


@pytest.mark.parametrize("soup", ["triangles_spheres", "cylinders", "degenerate"])
def test_plain_walks_match_jax(soup, numpy_builder):
    """intersect_plain / occluded_plain against JAX bvh.intersect /
    bvh.occluded on the same tree and rays (a third capped, every 17th
    maxt 0): prims and occlusion equal, t / u / v within rounding; and
    against the brute-force intersectors (both packages')."""
    rng = np.random.default_rng(11)
    f = _soup(rng, **SOUPS[soup])
    jg, tg = _both(f)
    tree = tbvh.build(tg, "cpu")
    o, d, maxt = _rays(rng, 3000)
    jray = JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt))
    ray = Ray(torch.tensor(o), torch.tensor(d), torch.tensor(maxt))
    has_cyl = bool((f["prim_type"] == jgeo.CYLINDER).any())

    want = [np.asarray(x) for x in jax.jit(jbvh.intersect)(jbvh.build(jg), jg, jray)]
    got = [x.numpy() for x in tbvh.intersect(tree, tg, ray, has_cyl)]
    t, prim, u, v = got
    hit = prim >= 0
    np.testing.assert_array_equal(hit, want[1] >= 0)
    same = prim == want[1]
    if soup == "degenerate":
        # coplanar overlapping triangles: the nearest of several hits at
        # the same t up to rounding, which the two packages round apart
        assert same.mean() >= 0.999
    else:
        assert same.all()
    assert 30 <= hit.sum() <= 0.9 * hit.size and not hit[::17].any()
    assert np.isinf(t[~hit]).all() and (u[~hit] == 0).all() and (v[~hit] == 0).all()
    np.testing.assert_allclose(t[hit], want[0][hit], rtol=T_RTOL, atol=T_ATOL)
    both = hit & same
    np.testing.assert_allclose(u[both], want[2][both], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(v[both], want[3][both], rtol=0, atol=UV_ATOL)
    brute = [x.numpy() for x in tgeo.intersect_brute(tg, ray, has_cyl)]
    assert (brute[1] == prim).mean() >= BRUTE_AGREE
    assert (np.asarray(jgeo.intersect_brute(jg, jray)[1]) == prim).mean() >= BRUTE_AGREE
    np.testing.assert_allclose(t[hit], brute[0][hit], rtol=T_RTOL, atol=T_ATOL)

    occ = tbvh.occluded(tree, tg, ray, has_cyl).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jax.jit(jbvh.occluded)(jbvh.build(jg), jg,
                                                                         jray)))
    assert occ.any() and not occ[::17].any()
    assert (occ == tgeo.occluded_brute(tg, ray, has_cyl).numpy()).mean() >= BRUTE_AGREE


def _scalar_walk(tree, tg, o, d, maxt, any_hit, seq=None):
    """One lane's skip-link walk in plain Python over the numpy tree, prim
    tests one at a time: (prim or hit, node visits, prim tests). seq: a
    list the visited nodes are appended to."""
    bb_min, bb_max, skip, leaf = (x.numpy() for x in tree)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.float32(1e-12), d)
    node, visits, tests, best, t_best = 0, 0, 0, -1, maxt
    while maxt > 0 and node < tree.n_nodes:
        visits += 1
        if seq is not None:
            seq.append(int(node))
        t0, t1 = (bb_min[node] - o) * inv, (bb_max[node] - o) * inv
        near, far = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
        if not (near <= far and far > 0 and near < t_best):
            node = skip[node]
            continue
        if leaf[node, 0] < 0:
            node += 1
            continue
        for pid in leaf[node]:
            if pid < 0:
                continue
            tests += 1
            t = float(tgeo._intersect_prims(tg, torch.tensor(o)[None], torch.tensor(d)[None],
                                            torch.tensor([pid]))[0][0])
            if t < t_best and t < maxt:
                best = pid
                if any_hit:
                    return True, visits, tests
                t_best = t
        node = skip[node]
    return (best >= 0) if any_hit else best, visits, tests


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walk_work_counts_the_walk(any_hit):
    """walk_work's result is the plain version's, and its per-lane node
    visits and prim tests (B2: up to the first hit) are a scalar walk's;
    the nodes and prims it marks read are those some lane visited or
    tested."""
    rng = np.random.default_rng(5)
    _, tg = _both(_soup(rng, n_tri=300, n_sph=30, n_cyl=30))
    tree = tbvh.build(tg, "cpu")
    o, d, maxt = _rays(rng, 60)
    ray = Ray(torch.tensor(o), torch.tensor(d), torch.tensor(maxt))
    res, work = tbvh.walk_work(tree, tg, ray, True, any_hit)
    plain = (tbvh.occluded_plain if any_hit else tbvh.intersect_plain)(tree, tg, ray)
    for a, b in zip((res,) if any_hit else res, (plain,) if any_hit else plain):
        assert torch.equal(a, b)
    for i in range(o.shape[0]):
        want = _scalar_walk(tree, tg, o[i], d[i], maxt[i], any_hit)
        got = (bool(res[i]) if any_hit else int(res[1][i]), int(work.visits[i]),
               int(work.tests[i]))
        assert got == want, i
    assert int(work.nodes.sum()) <= tree.n_nodes and bool(work.nodes[0])
    assert 0 < int(work.prims.sum()) <= int(work.tests.sum())


def _unpack(pack, prims):
    """The records of the kernels' packed storage as tensors: node bounds,
    first-child / leaf codes and skip slots by storage slot; the prims as a
    Geometry-like namespace by walk-order position, and their ids."""
    def f32(cols):
        return cols.contiguous().view(torch.float32)

    rec = pack.nodes
    nodes = SimpleNamespace(lo=f32(rec[:, 0:3]), hi=f32(rec[:, 4:7]), first=rec[:, 3].long(),
                            skip=rec[:, 7].long())
    geom = SimpleNamespace(prim_type=prims[:, 3].long(), p0=f32(prims[:, 0:3]),
                           e1=f32(prims[:, 4:7]), e2=f32(prims[:, 8:11]))
    return nodes, geom, prims[:, 7].long()


def _packed_walk(pack, prims, ray, cylinders, any_hit, trace=0):
    """tbvh._walk over the kernels' packed storage, step for step: a lane's
    cursor is a storage slot; a node's record gives its box, its first
    child's slot or its leaf's prims (start and count in the prim pack)
    and its skip link's slot (-1 past the last node). Returns ((t, prim,
    u, v) or occluded, node visits per lane, the pre-order nodes the first
    `trace` lanes visited, lane by lane)."""
    nodes, pg, ids = _unpack(pack, prims)
    n_nodes = pack.order.shape[0]
    pre = torch.empty_like(pack.order)
    pre[pack.order] = torch.arange(n_nodes)
    o, d, maxt = tcl._rays(ray)
    n = o.shape[0]
    inv_d = tcl._inv_dir(d)
    t_out, prim_out = maxt.clone(), torch.full((n,), -1, dtype=torch.int64)
    u_out, v_out = torch.zeros(n), torch.zeros(n)
    hit_out = torch.zeros(n, dtype=torch.bool)
    visits = torch.zeros(n, dtype=torch.int64)
    seqs = [[] for _ in range(trace)]
    lane = (maxt > 0).nonzero().squeeze(1) if n_nodes else torch.zeros(0, dtype=torch.int64)
    node = torch.zeros(lane.shape[0], dtype=torch.int64)
    o_l, d_l, inv_l, mt_l = o[lane], d[lane], inv_d[lane], maxt[lane]
    t_l, p_l = mt_l.clone(), torch.full_like(node, -1)
    u_l, v_l = torch.zeros_like(t_l), torch.zeros_like(t_l)
    h_l = torch.zeros_like(node, dtype=torch.bool)
    slot_iota = torch.arange(tbvh.LEAF_SIZE)
    while lane.shape[0]:
        for _ in range(tbvh.CHECK_EVERY):
            active = node >= 0
            ns = torch.clamp(node, min=0)
            visits[lane] += active
            shown = active & (lane < trace)
            for i, k in zip(lane[shown].tolist(), pre[ns[shown]].tolist()):
                seqs[i].append(k)
            hit_box = tbvh._slab_test(nodes.lo[ns], nodes.hi[ns], o_l, inv_l, t_l) & active
            code = nodes.first[ns]
            is_leaf = code < 0
            sel = (hit_box & is_leaf).nonzero().squeeze(1)
            packed_leaf = ~code[sel]
            valid = slot_iota < (packed_leaf & 7)[:, None]
            pos = torch.where(valid, (packed_leaf >> 3)[:, None] + slot_iota, 0)
            t_i, u_i, v_i = tgeo._intersect_prims(pg, o_l[sel, None, :], d_l[sel, None, :], pos,
                                                  cylinders)
            ok = valid & (t_i < mt_l[sel, None])
            if any_hit:
                h_l[sel] |= ok.any(1)
            else:
                tt = torch.where(ok, t_i, float("inf"))
                t_min = tt.amin(1)
                first = torch.where(tt == t_min[:, None], slot_iota, tbvh.LEAF_SIZE).amin(1)
                closer = t_min < t_l[sel]
                pick = torch.clamp(first, max=tbvh.LEAF_SIZE - 1)[:, None]
                upd = sel[closer]
                t_l[upd] = t_min[closer]
                p_l[upd] = ids[pos.gather(1, pick).squeeze(1)][closer]
                u_l[upd] = u_i.gather(1, pick).squeeze(1)[closer]
                v_l[upd] = v_i.gather(1, pick).squeeze(1)[closer]
            nxt = torch.where(hit_box & ~is_leaf, code, nodes.skip[ns])
            if any_hit:
                nxt = torch.where(h_l, -1, nxt)
            node = torch.where(active, nxt, node)
        done = node < 0
        fin = lane[done]
        hit_out[fin] = h_l[done]
        t_out[fin], prim_out[fin] = t_l[done], p_l[done]
        u_out[fin], v_out[fin] = u_l[done], v_l[done]
        keep = ~done
        lane, node, o_l, d_l, inv_l, mt_l = (x[keep] for x in (lane, node, o_l, d_l, inv_l,
                                                               mt_l))
        t_l, p_l, u_l, v_l, h_l = (x[keep] for x in (t_l, p_l, u_l, v_l, h_l))
    if any_hit:
        return hit_out, visits, seqs
    miss = prim_out < 0
    return (torch.where(miss, float("inf"), t_out), prim_out, u_out, v_out), visits, seqs


@pytest.mark.parametrize("soup", sorted(SOUPS))
def test_packs_round_trip_to_the_tree_and_the_geometry(soup):
    """pack_nodes / pack_prims hold the BVH's arrays and the geometry bit
    for bit: each pre-order node's record at its slot has its bounds, its
    first child's slot (a leaf: its prims' start and count), its skip
    link's slot; the slots are a permutation with the root first and
    every node's children side by side, in their parents' pre-order;
    every prim once, in leaf order, with its type, id and fields; the
    depth is the tree's."""
    _, tg = _both(_soup(np.random.default_rng(7), **SOUPS[soup]))
    tree = tbvh.build(tg, "cpu")
    pack = tbvh.pack_nodes(tree)
    prims = tbvh.pack_prims(tree, tg)
    n = tree.n_nodes
    nodes, pg, ids = _unpack(pack, prims)
    order = pack.order
    assert torch.equal(torch.sort(order).values, torch.arange(n)) and int(order[0]) == 0
    assert torch.equal(nodes.lo[order].view(torch.int32), tree.bb_min.view(torch.int32))
    assert torch.equal(nodes.hi[order].view(torch.int32), tree.bb_max.view(torch.int32))
    skip = tree.skip.long()
    want_skip = torch.where(skip < n, order[torch.clamp(skip, max=n - 1)], -1)
    assert torch.equal(nodes.skip[order], want_skip)
    slots = tree.leaf_prims.long()
    is_leaf = slots[:, 0] >= 0
    code = nodes.first[order]
    assert torch.equal(code < 0, is_leaf)
    inner = (~is_leaf).nonzero().squeeze(1)
    assert torch.equal(code[inner], order[inner + 1])
    # children side by side, the pairs in their parents' pre-order
    assert torch.equal(order[inner + 1], 1 + 2 * torch.arange(inner.shape[0]))
    assert torch.equal(order[skip[inner + 1]], order[inner + 1] + 1)
    leaf_code = ~code[is_leaf]
    for k, (start, count) in enumerate(zip((leaf_code >> 3).tolist(), (leaf_code & 7).tolist())):
        row = slots[is_leaf][k]
        assert ids[start:start + count].tolist() == row[row >= 0].tolist()
    # every prim once, leaf after leaf, slot order kept
    assert torch.equal(ids, slots[slots >= 0])
    assert torch.equal(torch.sort(ids).values, torch.arange(tg.prim_type.shape[0]))
    assert torch.equal(pg.prim_type, tg.prim_type[ids])
    for f in ("p0", "e1", "e2"):
        assert torch.equal(getattr(pg, f).view(torch.int32), getattr(tg, f)[ids].view(torch.int32))
    assert bool((prims[:, 11] == 0).all())
    depth = torch.zeros(n, dtype=torch.int64)
    for i in inner.tolist():  # pre-order: a parent precedes its children
        depth[i + 1] = depth[skip[i + 1]] = depth[i] + 1
    assert pack.depth == int(depth.max())


@pytest.mark.parametrize("soup", ["triangles_spheres", "cylinders", "degenerate",
                                  "single_triangle"])
def test_the_packed_walk_is_the_plain_walk(soup):
    """A walk over the packed storage (the kernels' records, read by slot,
    following their explicit child and skip slots) visits the pre-order
    nodes of the skip-link
    walk in its order, as many per lane as walk_work counts, and returns
    intersect_plain's t, prim, u, v bit for bit and occluded_plain's
    occlusion."""
    rng = np.random.default_rng(11)
    f = _soup(rng, **SOUPS[soup])
    _, tg = _both(f)
    tree = tbvh.build(tg, "cpu")
    o, d, maxt = _rays(rng, 2000)
    maxt[5::23] = np.nan
    ray = Ray(torch.tensor(o), torch.tensor(d), torch.tensor(maxt))
    has_cyl = bool((f["prim_type"] == jgeo.CYLINDER).any())
    pack, prims = tbvh.pack_nodes(tree), tbvh.pack_prims(tree, tg)
    for any_hit in (False, True):
        got, visits, seqs = _packed_walk(pack, prims, ray, has_cyl, any_hit, trace=40)
        want, work = tbvh.walk_work(tree, tg, ray, has_cyl, any_hit)
        if any_hit:
            assert torch.equal(got, want) and torch.equal(got, tbvh.occluded_plain(tree, tg, ray,
                                                                                  has_cyl))
        else:
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                   b.view(torch.int32) if b.is_floating_point() else b)
        assert torch.equal(visits, work.visits)
        for i in range(40):
            seq = []
            _scalar_walk(tree, tg, o[i], d[i], maxt[i], any_hit, seq)
            assert seqs[i] == seq, i


def test_packs_follow_an_in_place_edit():
    """packed() keeps a pack while the tree and the geometry are unchanged,
    and makes it anew after an in-place edit of either: no stale pack; a
    freed geometry's pack goes with it."""
    _, tg = _both(_soup(np.random.default_rng(2), n_tri=200, n_sph=20))
    tree = tbvh.build(tg, "cpu")
    nodes, prims = tbvh.packed(tree, tg)
    again = tbvh.packed(tree, tg)
    assert again[0] is nodes and again[1] is prims
    pid = int(tree.leaf_prims[tree.leaf_prims >= 0][5])
    tg.e1[pid, 1] += 0.25
    nodes2, prims2 = tbvh.packed(tree, tg)
    assert nodes2 is nodes and prims2 is not prims
    assert float(prims2[5, 4:7].contiguous().view(torch.float32)[1]) == float(tg.e1[pid, 1])
    assert torch.equal(prims2, tbvh.pack_prims(tree, tg))
    tree.bb_max[0, 2] += 1.0
    nodes3, _ = tbvh.packed(tree, tg)
    assert nodes3 is not nodes and torch.equal(nodes3.nodes, tbvh.pack_nodes(tree).nodes)
    assert float(nodes3.nodes[0, 6].view(torch.float32)) == float(tree.bb_max[0, 2])
    other = tg._replace(e2=tg.e2.clone())
    assert tbvh.packed(tree, other)[1] is not prims2
    # the cache holds no tensor alive: freeing one drops its entries
    before = len(tbvh._PACKS)
    del other
    assert len(tbvh._PACKS) == before - 1


def _blob_dict(n_sub):
    v, f = icosphere_blob(n_sub=n_sub)
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 8, "height": 8}},
        "blob": {"type": "mesh", "vertices": v, "faces": f, "bsdf": {"type": "diffuse"}},
        "sky": {"type": "constant", "radiance": [1, 1, 1]},
    }


def test_loader_takes_the_bvh_past_max_prims_as_jax(monkeypatch, caplog, numpy_builder):
    """With MAX_PRIMS below an 80-face blob both loaders trace it on the
    BVH (no cluster set) and warn; use_bvh equal at 20 and 80 faces, and
    the port's tree equal to the JAX loader's."""
    monkeypatch.setattr(tcl, "MAX_PRIMS", 79)
    monkeypatch.setattr(jcl, "MAX_PRIMS", 79)
    with caplog.at_level(logging.WARNING, "mitsuba_customization_tpu"), \
            caplog.at_level(logging.WARNING, "mitsuba_customization_tpu_torch"):
        own, ref = mt.load_dict(_blob_dict(1), "cpu"), mct.load_dict(_blob_dict(1))
    for sc in (own, ref):
        assert sc.config.intersector == "bvh" and sc.clusters is None and sc.config.use_bvh
    warned = [r.name for r in caplog.records if "capacity contract" in r.getMessage()]
    assert sorted(warned) == ["mitsuba_customization_tpu", "mitsuba_customization_tpu_torch"]
    for f, a, b in zip(tbvh.BVH._fields, own.bvh, ref.bvh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for n_sub in (0, 1):  # 20 and 80 faces
        own, ref = mt.load_dict(_blob_dict(n_sub), "cpu"), mct.load_dict(_blob_dict(n_sub))
        assert own.config.use_bvh == ref.config.use_bvh == (n_sub == 1)
        assert (own.bvh is None) == (n_sub == 0)


def _on_bvh(scene):
    """The scene traced on its BVH (the JAX package's
    scripts/profile_mesh.py switch)."""
    assert scene.config.use_bvh and scene.bvh is not None
    return dataclasses.replace(scene, config=dataclasses.replace(scene.config,
                                                                 intersector="bvh"))


def _frames_agree(d, spp, means_rtol):
    """The port's frame on the "bvh" intersector against the JAX frame (on
    the CPU the JAX package traces any mesh scene on its BVH) and the
    port's cluster frame: per-channel means within means_rtol and the
    per-pixel Z-test (variance from the port's frames at two seeds)."""
    scene = mt.load_dict(d, "cpu")
    assert scene.config.intersector == "cluster"
    on_bvh = _on_bvh(scene)
    got = mt.render(on_bvh, spp, 0).numpy()
    other = mt.render(on_bvh, spp, 1).numpy()
    clustered = mt.render(scene, spp, 0).numpy()
    want = np.asarray(jax.jit(lambda s: jax_render(s, spp, 0))(mct.load_dict(d)))
    assert got.shape == want.shape and np.isfinite(got).all()
    var = 0.5 * (got - other) ** 2 * spp + 1e-4
    for ref in (want, clustered):
        np.testing.assert_allclose(got.mean((0, 1)), ref.mean((0, 1)), rtol=means_rtol)
        ok, z = ztest_images(got, var, ref, var, spp, spp)
        assert ok, z


def test_path_frame_on_the_bvh_matches_jax_and_clusters():
    """The matpreview scene (a 320-triangle blob in 2 MERL bands, the
    roughconductor floor, the area light) at 16x16, 4 spp, depth 3."""
    _frames_agree(matpreview_dict(16, 4, 3, n_sub=2, n_materials=2), 4, 0.01)


def test_volpath_frame_on_the_bvh_matches_jax_and_clusters():
    """tests/test_torch_volpath.py's homogeneous medium in a null cube,
    beside an 80-triangle diffuse blob (past the brute-force threshold):
    shadow rays walk the tree built on the geometry over the shadow
    geometry, in which the cube's prims are degenerate. 16x16, 8 spp,
    depth 4."""
    d = volpath_scene_dict("homogeneous", boundary="cube", res=16, spp=8)
    v, f = icosphere_blob(n_sub=1)
    d["blob"] = {"type": "mesh", "vertices": v * 0.4 + np.float32([1.2, -0.6, 0.0]),
                 "faces": f, "bsdf": {"type": "diffuse", "reflectance": [0.5, 0.4, 0.3]}}
    scene = mt.load_dict(d, "cpu")
    assert scene.shadow_geometry is not None
    _frames_agree(d, 8, 0.02)


def test_every_tracer_reaches_the_bvh_through_the_scene(monkeypatch):
    """The integrators need nothing of the BVH: path (under a compaction
    schedule, whose spatial sort is cluster-only), volpath, ptracer and
    bdpt, and integrator.render_rows (parallel/mesh's slab), trace it
    through Scene.ray_intersect / ray_test, and no cluster query runs."""
    calls = {"bvh.intersect": 0, "bvh.occluded": 0, "clusters": 0}

    def count(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tbvh, "intersect", count("bvh.intersect", tbvh.intersect))
    monkeypatch.setattr(tbvh, "occluded", count("bvh.occluded", tbvh.occluded))
    monkeypatch.setattr(tcl, "intersect", count("clusters", tcl.intersect))
    monkeypatch.setattr(tcl, "occluded", count("clusters", tcl.occluded))
    d = matpreview_dict(8, 2, 3, n_sub=2, n_materials=2, compact=(1.0, 0.8, 0.6))
    del d["sky"]  # the light tracers start on area lights only
    scene = _on_bvh(mt.load_dict(d, "cpu"))
    for integrator in ("path", "volpath", "ptracer", "bdpt"):
        before = dict(calls)
        img = mt.render(scene, 2, 0, integrator)
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all()), integrator
        assert calls["bvh.intersect"] > before["bvh.intersect"], integrator
        assert calls["bvh.occluded"] > before["bvh.occluded"], integrator
    before = calls["bvh.intersect"]
    rows, _ = tint.render_rows(scene, 2, 0, "path", 3, False, 0, 8)
    assert rows.shape == (8, 8, 3) and calls["bvh.intersect"] > before
    assert calls["clusters"] == 0
