"""The matpreview slice of the port against the JAX package: the scene
loader (mesh, area light, cluster structure), the area emitter, wavefront
compaction and the whole frame.

The scene is the repository's headline matpreview scene at a small size:
res 16, spp 2, depth 3, a 1,280-triangle blob (n_sub 3, 4 superclusters)
in 3 MERL bands, compaction schedule (1, 1, 1). On the CPU the JAX package
traces it with its BVH (its own tests hold that equal to its cluster
kernels) and the port with the plain versions of K3 and K4.

Tolerances: emitter quantities within rtol 1e-5 / atol 1e-5 (one float32
pipeline on each side); frames by per-channel means within 1 % and >= 95 %
of pixels within atol 1e-3 + rtol 1e-3 (the sampler is bit-identical, so
frames part only where a lane branches on an ulp-level gap), and the ray
counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.core.frame import Frame as JFrame
from mitsuba_customization_tpu.render import emitters as jem
from mitsuba_customization_tpu.render import integrator as jint
from mitsuba_customization_tpu.render.records import Ray as JRay
from mitsuba_customization_tpu.render.records import SurfaceInteraction as JSI
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.render import emitters as tem
from mitsuba_customization_tpu_torch.render import integrator as tint
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.scenes import matpreview_dict
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_render import _arrays

RES, SPP, DEPTH = 16, 2, 3
SMALL = dict(n_sub=3, n_materials=3, compact=(1.0, 1.0, 1.0))


@pytest.fixture(scope="module")
def jax_scene():
    from __graft_entry__ import _matpreview_scene

    return _matpreview_scene(RES, SPP, DEPTH, **SMALL)


@pytest.fixture(scope="module")
def port_scene(jax_scene):
    return scene_from_numpy(_arrays(jax_scene), jax_scene.config)


@pytest.fixture(scope="module")
def own_scene():
    return mt.load_dict(matpreview_dict(RES, SPP, DEPTH, **SMALL), "cpu")


@pytest.fixture(scope="module")
def jax_frame(jax_scene):
    img, stats = jax.jit(
        lambda s: jint.render(s, SPP, 0, return_stats=True)
    )(jax_scene)
    return np.asarray(img), float(stats["rays_traced"])


def _assert_frames_agree(got, want):
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    close = (np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)).all(-1)
    assert close.mean() >= 0.95, close.mean()


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def test_own_loader_matches_jax_scene(jax_scene, port_scene, own_scene):
    """matpreview_dict through the port's load_dict builds the JAX scene:
    the same prims, cluster structure, materials, emissive prims and area
    pmfs, and the same config."""
    ref, own = port_scene, own_scene
    assert own.config == ref.config
    assert own.config.intersector == "cluster" and own.config.compact == (1.0, 1.0, 1.0)
    assert own.geometry.p0.shape[0] == 1284
    for a, b in zip(own.geometry, ref.geometry):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(own.clusters, ref.clusters):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(own.bsdfs.mat_type, ref.bsdfs.mat_type)
    torch.testing.assert_close(own.bsdfs.mat_slot, ref.bsdfs.mat_slot)
    # three BSDF kinds: the GGX floor, the light's default diffuse, MERL
    assert own.bsdfs.present_kernels == ref.bsdfs.present_kernels == [
        tbsdf.DIFFUSE, tbsdf.ROUGHCONDUCTOR, tbsdf.TABULATED]
    assert own.bsdfs.stacks[tbsdf.DIFFUSE].reflectance.shape == (1, 3)
    torch.testing.assert_close(own.bsdfs.stacks[tbsdf.TABULATED].table,
                               ref.bsdfs.stacks[tbsdf.TABULATED].table,
                               rtol=0, atol=0)
    em, em_ref = own.emitters, ref.emitters
    for name in ("em_type", "radiance", "em_prims", "prim_area", "prim_to_q"):
        torch.testing.assert_close(getattr(em, name), getattr(em_ref, name),
                                   rtol=0, atol=0, check_dtype=False)
    for a, b in zip(em.prim_dist, em_ref.prim_dist):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert em.background_index == em_ref.background_index == 1


def test_sky_selection_weight_is_zero(jax_scene, own_scene):
    """Beside the area light the port gives the constant sky NEE weight
    exactly 0; the JAX package gives it 1e-20 (a lane drawing it would be
    weighted by ~1e20)."""
    np.testing.assert_array_equal(own_scene.emitters.select.pmf.numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(own_scene.emitters.select.cdf.numpy(), [1.0, 1.0])
    np.testing.assert_allclose(np.asarray(jax_scene.emitters.select.pmf),
                               [1.0, 1e-20], rtol=1e-6)
    # no sky draws, and escaped BSDF rays carry no sky NEE density
    u = torch.linspace(0.0, 1.0 - 1e-7, 1001)
    k, _ = own_scene.emitters.select.sample_reuse(u)
    assert (k == 0).all()
    d = torch.tensor([[0.0, 1.0, 0.0]])
    assert float(tem.pdf_miss_direction(own_scene.emitters, d)[0]) == 0.0


# ---------------------------------------------------------------------------
# The area emitter
# ---------------------------------------------------------------------------


def _emitter_inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-2.0, -1.2, -2.0], [2.0, 2.0, 2.0], (n, 3)).astype(np.float32)
    u3 = rng.random((n, 3), dtype=np.float32)
    return p, u3


def test_sample_direction_matches_jax(jax_scene, port_scene):
    p, u3 = _emitter_inputs()
    ref = jax.jit(jem.sample_direction)(
        jax_scene.emitters, jax_scene.geometry, jnp.asarray(p), jnp.asarray(u3))
    got = tem.sample_direction(port_scene.emitters, port_scene.geometry,
                               torch.tensor(p), torch.tensor(u3))
    for name in ("d", "dist", "pdf", "radiance"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(ref.delta))
    assert (np.asarray(ref.pdf) > 0).mean() > 0.3  # the light faces down


def test_pdf_hit_and_eval_hit_match_jax(jax_scene, port_scene):
    """Rays from random points toward random points of the light and of the
    blob: the port's interaction fed to both packages' pdf_hit_direction
    and eval_hit."""
    p, u3 = _emitter_inputs(seed=1)
    ds = tem.sample_direction(port_scene.emitters, port_scene.geometry,
                              torch.tensor(p), torch.tensor(u3))
    d = torch.where(torch.arange(len(p))[:, None] % 3 == 0,
                    -torch.tensor(p) / torch.tensor(p).norm(dim=-1, keepdim=True), ds.d)
    d = torch.where(d.norm(dim=-1, keepdim=True) > 0, d, torch.tensor([0.0, 1.0, 0.0]))
    ray = Ray.make(torch.tensor(p), d)
    si = port_scene.ray_intersect(ray)
    assert (si.emitter >= 0).float().mean() > 0.2
    jsi = JSI(*(jnp.asarray(x.numpy()) if not isinstance(x, tuple)
                else JFrame(*(jnp.asarray(y.numpy()) for y in x))
                for x in si))
    ref_pdf = jem.pdf_hit_direction(jax_scene.emitters, jax_scene.geometry, jsi,
                                    jnp.asarray(p))
    ref_rad = jem.eval_hit(jax_scene.emitters, jsi)
    got_pdf = tem.pdf_hit_direction(port_scene.emitters, port_scene.geometry, si,
                                    torch.tensor(p))
    got_rad = tem.eval_hit(port_scene.emitters, si)
    np.testing.assert_allclose(got_pdf.numpy(), np.asarray(ref_pdf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_rad.numpy(), np.asarray(ref_rad), rtol=1e-5, atol=1e-5)
    assert (got_pdf > 0).any() and (got_rad > 0).any()


# ---------------------------------------------------------------------------
# Compaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,fracs,depth", [
    (1 << 21, (1.0, 0.7, 0.4, 0.2), 8), (8192, (1.0, 0.3), 3), (512, (1.0,), 4),
    (1 << 20, (), 5),
])
def test_compact_caps_match_jax(n, fracs, depth):
    assert tint._compact_caps(n, fracs, depth) == jint._compact_caps(n, fracs, depth)


@pytest.mark.parametrize("live,cap,u", [
    (0.9, 4096, 0.3), (0.2, 4096, 0.99), (0.6, 2048, 0.0), (1.0, 6144, 0.5),
])
def test_systematic_survive_matches_jax(live, cap, u):
    rng = np.random.default_rng(int(live * 100) + cap)
    active = rng.random(8192) < live
    ref_s, ref_p = jint._systematic_survive(jnp.asarray(active), cap, jnp.float32(u))
    got_s, got_p = tint._systematic_survive(torch.tensor(active), cap,
                                            torch.tensor(u, dtype=torch.float32))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert float(got_p) == float(ref_p)
    assert got_s.sum() <= cap


def test_harvest_only_compaction_is_exact(own_scene):
    """With caps above the live counts nothing is thinned: the spatial
    re-sort and the final unsort leave the frame exactly as uncompacted
    (the JAX package's test_harvest_only_schedule_exact)."""
    import dataclasses

    plain = dataclasses.replace(own_scene, config=dataclasses.replace(
        own_scene.config, compact=None))
    ref, ref_st = mt.render(plain, spp=SPP, seed=3, return_stats=True)
    got, got_st = mt.render(own_scene, spp=SPP, seed=3, return_stats=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert got_st == ref_st


def test_binding_schedule_keeps_the_mean():
    """A schedule that thins live lanes (cap 4,096 of 16,384 lanes after
    bounce 0) keeps the image mean within 5 %."""
    d = matpreview_dict(32, 16, 3, n_sub=2, n_materials=2)
    plain = mt.load_dict(d, "cpu")
    d["integrator"]["compact"] = (1.0, 0.25)
    thin = mt.load_dict(d, "cpu")
    ref, ref_st = mt.render(plain, spp=16, seed=5, return_stats=True)
    got, got_st = mt.render(thin, spp=16, seed=5, return_stats=True)
    assert got_st["rays_traced"] < 0.8 * ref_st["rays_traced"]  # it thinned
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.mean().item(), ref.mean().item(), rtol=0.05)


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------


def test_frame_matches_jax(port_scene, jax_frame):
    """Whole frame on the JAX scene's arrays (sky NEE weight 1e-20 as the
    JAX package has it)."""
    img, stats = mt.render(port_scene, spp=SPP, seed=0, return_stats=True)
    _assert_frames_agree(img.numpy(), jax_frame[0])
    assert stats["rays_traced"] == jax_frame[1]


def test_frame_own_loader_matches_jax(own_scene, jax_frame):
    """Whole frame through the port's own load_dict -> render, with the sky
    NEE weight 0. It moves nothing: the sky is drawn by no lane in either
    package, and its 1e-20 density changes no MIS weight in float32."""
    img, stats = mt.render(own_scene, spp=SPP, seed=0, return_stats=True)
    _assert_frames_agree(img.numpy(), jax_frame[0])
    assert stats["rays_traced"] == jax_frame[1]
