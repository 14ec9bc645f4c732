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
    out, n_left = tbvh._split_level(ids.copy(), np.array([n]), bb_min, bb_max, centroid)
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


def _scalar_walk(tree, tg, o, d, maxt, any_hit):
    """One lane's skip-link walk in plain Python over the numpy tree, prim
    tests one at a time: (prim or hit, node visits, prim tests)."""
    bb_min, bb_max, skip, leaf = (x.numpy() for x in tree)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.float32(1e-12), d)
    node, visits, tests, best, t_best = 0, 0, 0, -1, maxt
    while maxt > 0 and node < tree.n_nodes:
        visits += 1
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
