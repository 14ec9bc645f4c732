"""The port's cluster structure and the plain versions of K3 and K4 against
the JAX package.

The build (ops/clusters.build) against JAX `clusters.build` on one
Geometry; the plain closest-hit and any-hit traversals against the JAX
Pallas kernels in interpret mode (one call of each, module-scoped: each
takes ~25-40 s on the CPU) and against JAX's brute-force intersector at
the larger n_sub = 3 mesh (1,284 prims, 4 superclusters). The CUDA kernels
themselves run only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: hit/miss equal; t within rtol 1e-4 / atol 1e-5; the prim
equal on >= 99 % of hit lanes (ties on shared mesh edges may pick either
prim, and the JAX kernel visits superclusters in another order); u, v
within 2e-4 where the prims agree; occlusion equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.ops import clusters as jcl
from mitsuba_customization_tpu.render import geometry as jgeo
from mitsuba_customization_tpu.render.records import Ray as JRay
from mitsuba_customization_tpu_torch.ops import clusters as tcl
from mitsuba_customization_tpu_torch.render.records import Ray
from test_clusters import _mesh_geometry, _rays
from test_torch_kernels import one_torch_thread  # noqa: F401

N_INTERP = 2048  # lanes of the one interpret-mode call of each JAX kernel


def _np_geometry(g):
    return type(g)(*(np.asarray(f) for f in g))


def _torch_ray(jray, maxt=None):
    mt_ = np.asarray(jray.maxt) if maxt is None else maxt
    return Ray(o=torch.tensor(np.asarray(jray.o)), d=torch.tensor(np.asarray(jray.d)),
               maxt=torch.tensor(np.broadcast_to(mt_, jray.o.shape[:1]).copy()))


def _port_set(g):
    return tcl.build(_np_geometry(g), "cpu")


def _half_capped(t_hit, n):
    """maxt: half the lanes that hit capped at 0.5 x their hit distance,
    1e30 elsewhere."""
    capped = np.isfinite(t_hit) & (np.arange(n) % 2 == 0)
    return np.where(capped, t_hit * 0.5, 1e30).astype(np.float32), capped


def _assert_hits_agree(got, t_ref, prim_ref, u_ref, v_ref):
    t, prim, u, v, _ = (x.numpy() if isinstance(x, torch.Tensor) else x for x in got)
    assert ((prim >= 0) == (prim_ref >= 0)).all()
    hit = prim >= 0
    assert np.isinf(t[~hit]).all() and (u[~hit] == 0).all() and (v[~hit] == 0).all()
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-4, atol=1e-5)
    assert (prim[hit] == prim_ref[hit]).mean() >= 0.99
    same = hit & (prim == prim_ref)
    np.testing.assert_allclose(u[same], u_ref[same], atol=2e-4)
    np.testing.assert_allclose(v[same], v_ref[same], atol=2e-4)


def _assert_winner_rows(g_np, got):
    """The winner fields are the Geometry row of the returned prim; a miss
    carries the miss fills."""
    _, prim, _, _, gg = got
    prim = prim.numpy()
    hit = prim >= 0
    safe = np.maximum(prim, 0)
    for field in ("p0", "e1", "e2", "vn0", "vn1", "vn2", "uv0", "uv1", "uv2",
                  "prim_type", "mat_id", "emitter_id", "shape_id"):
        ref = getattr(g_np, field)[safe][hit]
        np.testing.assert_array_equal(getattr(gg, field).numpy()[hit], ref, field)
    assert (gg.prim_type.numpy()[~hit] == -1).all()
    assert (gg.emitter_id.numpy()[~hit] == -1).all()
    assert (gg.mat_id.numpy()[~hit] == 0).all()
    assert (gg.shape_id.numpy()[~hit] == 0).all()
    assert (gg.p0.numpy()[~hit] == 0).all()


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sub,extra_analytic", [(3, False), (2, True)])
def test_build_matches_jax(n_sub, extra_analytic):
    g = _mesh_geometry(n_sub=n_sub, extra_analytic=extra_analytic)
    ref = jcl.build(g)
    sc_box, cl_box, cl_meta, slabs = tcl.build_arrays(_np_geometry(g))
    if n_sub == 3:
        assert sc_box.shape == (4, 8)  # two levels: 4 superclusters
    np.testing.assert_array_equal(sc_box, np.asarray(ref.sc_box))
    np.testing.assert_array_equal(cl_box, np.asarray(ref.cl_box))
    np.testing.assert_array_equal(cl_meta, np.asarray(ref.cl_meta))
    # per (cluster, slot): the port's row = the JAX slab's column
    ref_slabs = np.asarray(ref.slabs)
    np.testing.assert_array_equal(slabs, ref_slabs.transpose(0, 2, 1)[:, :tcl.L])
    assert (ref_slabs[:, :, tcl.L:] == np.where(
        np.arange(tcl.NFIELDS) == tcl.F_TYPE, -1.0, 0.0)[None, :, None]).all()
    cs = _port_set(g)
    np.testing.assert_array_equal(cs.root[:3].numpy(), sc_box[:, :3].min(0))
    np.testing.assert_array_equal(cs.root[3:6].numpy(), sc_box[:, 3:6].max(0))


# ---------------------------------------------------------------------------
# Plain K3 / K4 against the JAX kernels (interpret mode), all prim types
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def interp():
    """One interpret-mode call of each JAX kernel on the mesh with a
    sphere and a cylinder: 2,048 rays (half aimed at the mesh), half of
    the hitting lanes capped at 0.5 x their hit distance for the shadow
    query."""
    g = _mesh_geometry(n_sub=2, extra_analytic=True)
    cs = jcl.build(g)
    jray = _rays(N_INTERP, seed=1)
    closest = [np.asarray(x) for x in jcl.intersect(cs, jray, interpret=True,
                                                    tile_rows=16)[:4]]
    tb = np.asarray(jgeo.intersect_brute(g, jray)[0])
    maxt, capped = _half_capped(tb, N_INTERP)
    jray2 = JRay(o=jray.o, d=jray.d, maxt=jnp.asarray(maxt))
    occ = np.asarray(jcl.occluded(cs, jray2, interpret=True, tile_rows=16))
    return dict(g=g, jray=jray, closest=closest, maxt=maxt, capped=capped,
                occ=occ)


def test_intersect_plain_matches_jax_kernel(interp):
    g_np = _np_geometry(interp["g"])
    cs = _port_set(interp["g"])
    got = tcl.intersect(cs, _torch_ray(interp["jray"]))
    t_ref, prim_ref, u_ref, v_ref = interp["closest"]
    assert (prim_ref >= 0).mean() > 0.3 and (prim_ref < 0).mean() > 0.1
    types = g_np.prim_type[prim_ref[prim_ref >= 0]]
    assert {0, 1, 2} <= set(types.tolist())  # triangles, sphere, cylinder hit
    _assert_hits_agree(got, t_ref, prim_ref, u_ref, v_ref)
    _assert_winner_rows(g_np, got)


def test_occluded_plain_matches_jax_kernel(interp):
    cs = _port_set(interp["g"])
    occ = tcl.occluded(cs, _torch_ray(interp["jray"], interp["maxt"])).numpy()
    np.testing.assert_array_equal(occ, interp["occ"])
    assert not occ[interp["capped"]].any() and occ.any()


# ---------------------------------------------------------------------------
# Plain K3 / K4 against JAX brute force at n_sub = 3 (two-level structure)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh3():
    g = _mesh_geometry(n_sub=3, extra_analytic=True)
    jray = _rays(8192, seed=2)
    ref = [np.asarray(x) for x in jgeo.intersect_brute(g, jray)]
    return g, jray, ref


def test_intersect_plain_matches_brute(mesh3):
    g, jray, (tb, pb, ub, vb) = mesh3
    cs = _port_set(g)
    assert cs.sc_box.shape[0] == 4
    got = tcl.intersect(cs, _torch_ray(jray))
    _assert_hits_agree(got, tb, pb, ub, vb)
    _assert_winner_rows(_np_geometry(g), got)


def test_occluded_plain_matches_brute(mesh3):
    g, jray, (tb, _, _, _) = mesh3
    maxt, capped = _half_capped(tb, tb.shape[0])
    jray2 = JRay(o=jray.o, d=jray.d, maxt=jnp.asarray(maxt))
    ref = np.asarray(jgeo.occluded_brute(g, jray2))
    occ = tcl.occluded(_port_set(g), _torch_ray(jray, maxt)).numpy()
    np.testing.assert_array_equal(occ, ref)
    assert not occ[capped].any()


def test_capped_and_dead_lanes(mesh3):
    """maxt below the hit distance misses; maxt <= 0 (dead lanes, lanes
    without an NEE sample) and NaN return a miss at once; maxt = inf is
    the same query as 1e30."""
    g, jray, (tb, pb, _, _) = mesh3
    cs = _port_set(g)
    n = tb.shape[0]
    maxt, capped = _half_capped(tb, n)
    maxt[1::4] = 0.0
    maxt[3::8] = -1.0
    maxt[7::16] = np.nan
    t, prim, _, _, _ = tcl.intersect(cs, _torch_ray(jray, maxt))
    dead = ~(maxt > 0)
    assert (prim.numpy()[capped | dead] == -1).all()
    assert not tcl.occluded(cs, _torch_ray(jray, maxt)).numpy()[dead].any()
    live = ~(capped | dead)
    np.testing.assert_array_equal(prim.numpy()[live] >= 0, pb[live] >= 0)
    t_inf = tcl.intersect(cs, _torch_ray(jray, np.float32(np.inf)))[0]
    t_big = tcl.intersect(cs, _torch_ray(jray, np.float32(1e30)))[0]
    torch.testing.assert_close(t_inf, t_big, rtol=0, atol=0)


def test_plain_chunking_does_not_change_results(mesh3, monkeypatch):
    """The plain versions chunk rays and (ray, cluster) pairs; the result
    is the same for any chunk size."""
    g, jray, _ = mesh3
    cs = _port_set(g)
    ray = _torch_ray(jray)
    ref = tcl.intersect_plain(cs, ray)
    monkeypatch.setattr(tcl, "_RAY_CHUNK_ELEMS", 64 * 100)
    monkeypatch.setattr(tcl, "_PAIR_CHUNK", 333)
    for a, b in zip(tcl.intersect_plain(cs, ray), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def _blob_scene(n_sub):
    from mitsuba_customization_tpu_torch.utils.meshgen import icosphere_blob

    v, f = icosphere_blob(n_sub=n_sub)
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 8, "height": 8}},
        "blob": {"type": "mesh", "vertices": v, "faces": f,
                 "bsdf": {"type": "diffuse"}},
        "sky": {"type": "constant", "radiance": [1, 1, 1]},
    }


def test_loader_builds_clusters_and_takes_the_bvh_past_max_prims(monkeypatch, caplog):
    """Past 64 prims the loader builds the BVH (use_bvh) and the cluster
    set; past MAX_PRIMS it traces on the BVH alone, with the JAX loader's
    capacity warning."""
    import logging

    small = mt.load_dict(_blob_scene(1), "cpu")  # 80 faces > 64
    assert small.config.intersector == "cluster" and small.clusters is not None
    assert small.config.use_bvh and small.bvh is not None
    monkeypatch.setattr(tcl, "MAX_PRIMS", 79)
    with caplog.at_level(logging.WARNING, "mitsuba_customization_tpu_torch"):
        big = mt.load_dict(_blob_scene(1), "cpu")
    assert big.config.intersector == "bvh" and big.clusters is None
    assert big.config.use_bvh and big.bvh is not None
    assert any("capacity contract" in r.message for r in caplog.records)
    brute = mt.load_dict(_blob_scene(0), "cpu")  # 20 faces
    assert brute.config.intersector == "brute" and brute.clusters is None
    assert not brute.config.use_bvh and brute.bvh is None
