"""The port's volumetric path tracer against the JAX package's.

32x32 volpath frames of one scene family (a diffuse floor, an area light
and a dim sky around a null-bounded medium) through both packages' own
loaders at the same seed: a homogeneous medium, a heterogeneous one in the
gridvolume form, an emissive one, an SGGX phase, the homogeneous medium
under the `path` integrator (the JAX dispatch sends any scene with media
to the volumetric tracer), and the medium bounded by an 80-triangle null
mesh (past the brute-force threshold: the port's cluster intersector, the
JAX package's BVH on the CPU; the medium switches at each prim's shape
id). The sampler is bit-identical and the free-flight draws are too, so
the frames differ only where a lane branches on an ulp-level gap: image
means within 2 %, and the per-pixel Z-test of tests/reference_renderer
(the variance from the spread of the port's frames at two seeds). Then the media-free case (volpath reduces to path), traverse /
update of the medium keys, and the gradients of a 16x16 volpath frame
against jax.grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import params as jparams
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu.utils.meshgen import icosphere_blob
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import medium as tmed
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.scenes import fog_dict, smooth_volume
from mitsuba_customization_tpu.models import phase as jph
from reference_renderer import ztest_images
from test_torch_phase import jax_sggx_sample_paper
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401

RES, SPP, DEPTH = 32, 16, 4


MEDIA = {
    "homogeneous": {"type": "homogeneous", "sigma_t": [0.8, 0.9, 1.0], "albedo": [0.7] * 3},
    "heterogeneous": {"type": "heterogeneous", "sigma_t": [2.0, 2.2, 2.4],
                      "albedo": [0.8, 0.7, 0.6], "phase": {"type": "hg", "g": 0.6},
                      "density": {"grid": 0.1 + smooth_volume(np.random.default_rng(3), 12),
                                  "to_world": {"scale": 1.4, "translate": [-0.7, -0.7, -0.7]}}},
    "emissive": {"type": "homogeneous", "sigma_t": [0.8] * 3, "albedo": [0.3] * 3,
                 "radiance": [2.0, 1.5, 1.0], "phase": {"type": "rayleigh"}},
    "sggx": {"type": "homogeneous", "sigma_t": [1.2] * 3, "albedo": [0.9] * 3,
             "phase": {"type": "sggx", "S": [1.0, 0.09, 0.25, 0.0, 0.0, 0.1]}},
}


def scene_dict(medium="homogeneous", integrator="volpath", boundary="sphere", res=RES,
               spp=SPP, depth=DEPTH):
    d = {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": {"look_at": {"origin": [0, 1.0, -4.0], "target": [0, 0, 0]}},
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.6] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 5.0,
                               "translate": [0, -1.0, 0]}},
        "light": {"type": "rectangle", "emitter": {"type": "area", "radiance": [8.0] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90},
                               "translate": [0.5, 2.5, -0.5]}},
        "sky": {"type": "constant", "radiance": [0.1, 0.12, 0.15]},
    }
    if medium is None:
        d["ball"] = {"type": "sphere", "radius": 0.7,
                     "bsdf": {"type": "diffuse", "reflectance": [0.4, 0.5, 0.6]}}
        return d
    if boundary == "sphere":
        d["fog"] = {"type": "sphere", "radius": 0.8, "bsdf": {"type": "null"},
                    "interior": MEDIA[medium]}
    elif boundary == "cube":
        d["fog"] = {"type": "cube", "bsdf": {"type": "null"}, "interior": MEDIA[medium],
                    "to_world": {"scale": 0.7}}
    else:  # a named medium inside an 80-triangle null mesh
        v, f = icosphere_blob(n_sub=1, bump=0.0)
        d["fog_medium"] = MEDIA[medium]
        d["fog"] = {"type": "mesh", "vertices": v * 0.8, "faces": f, "bsdf": {"type": "null"},
                    "interior": "fog_medium"}
    return d


CASES = {
    "homogeneous": dict(medium="homogeneous"),
    "heterogeneous": dict(medium="heterogeneous", boundary="cube"),
    "emissive": dict(medium="emissive"),
    "sggx": dict(medium="sggx"),
    "path_integrator": dict(medium="homogeneous", integrator="path"),
    "mesh_boundary": dict(medium="homogeneous", boundary="mesh"),
}


def _jax(d, seed=0):
    scene = mct.load_dict(d)
    return np.asarray(jax.jit(lambda s: jax_render(s, SPP, seed))(scene))


@pytest.mark.parametrize("case", sorted(CASES))
def test_volpath_frame_matches_jax(case, monkeypatch):
    """Image means within 2 %; the per-pixel Z-test at 4 sigma on >= 99.5 %
    of pixels, the variance from the spread of the port's own frames at
    two seeds (each an SPP-sample mean). The SGGX case's JAX frame samples
    its phase with the paper's basis, as the port does (the JAX package's
    own SGGX sampler is biased: test_torch_chi2)."""
    if case == "sggx":
        monkeypatch.setattr(jph, "sggx_sample", jax_sggx_sample_paper)
    d = scene_dict(**CASES[case])
    scene = mt.load_dict(d, "cpu")
    if case == "mesh_boundary":
        assert scene.config.intersector == "cluster"
    assert scene.media.n_media == 1
    got = mt.render(scene, SPP, 0).numpy()
    other = mt.render(scene, SPP, 1).numpy()
    want = _jax(d)
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    var = 0.5 * (got - other) ** 2 * SPP + 1e-4
    ok, z = ztest_images(got, var, want, var, SPP, SPP)
    assert ok, z


def test_volpath_no_media_matches_path():
    """volpath on a scene without media is the surface path tracer (the
    JAX package's test of that name, on the port): atol 5e-3, and the
    JAX volpath frame's mean within 2 %."""
    d = scene_dict(medium=None)
    scene = mt.load_dict(d, "cpu")
    img_path = mt.render(scene, SPP, 2, "path").numpy()
    img_vol = mt.render(scene, SPP, 2, "volpath").numpy()
    np.testing.assert_allclose(img_vol, img_path, atol=5e-3)
    want = _jax(dict(d, integrator={"type": "volpath", "max_depth": DEPTH}), seed=2)
    np.testing.assert_allclose(img_vol.mean((0, 1)), want.mean((0, 1)), rtol=0.02)


MEDIUM_KEYS = ("medium.sigma_t", "medium.albedo", "medium.phase_g", "medium.density")


def test_media_traverse_update_roundtrip():
    """traverse names the four medium keys with the JAX traverse's values;
    update writes them in uncopied and recomputes the majorants as the JAX
    update does (rtol 1e-6)."""
    d = scene_dict(**CASES["heterogeneous"])
    js, ts = mct.load_dict(d), mt.load_dict(d, "cpu")
    want, got = jparams.traverse(js), tparams.traverse(ts)
    assert set(got) == set(want) and set(MEDIUM_KEYS) <= set(got)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    rng = np.random.default_rng(4)
    new = {"medium.sigma_t": np.asarray(want["medium.sigma_t"]) * 2.0,
           "medium.density": rng.random(np.asarray(want["medium.density"]).shape
                                        ).astype(np.float32) * 1.5}
    jsc = jparams.update(js, {k: jnp.asarray(v) for k, v in new.items()})
    p = tparams.params_from_numpy(new, "cpu")
    tsc = tparams.update(ts, p)
    assert tsc.media.sigma_t is p["medium.sigma_t"] and tsc.media.grid is p["medium.density"]
    np.testing.assert_allclose(tsc.media.majorant.numpy(), np.asarray(jsc.media.majorant),
                               rtol=1e-6)
    with pytest.raises(KeyError):
        tparams.update(mt.load_dict(scene_dict(medium=None), "cpu"),
                       {"medium.sigma_t": torch.zeros(1, 3)})


def _grad_scene(res=16, spp=4, depth=3):
    """The heterogeneous cube beside a MERL sphere (the table gradient)."""
    d = scene_dict(**CASES["heterogeneous"], res=res, spp=spp, depth=depth)
    d["fog"]["to_world"] = {"scale": 0.7, "translate": [0.6, 0, 0]}
    d["ball"] = {"type": "sphere", "center": [-0.9, -0.3, 0.2], "radius": 0.5,
                 "bsdf": {"type": "merl", "table": smooth_table(np.random.default_rng(7))}}
    return d


GRAD_KEYS = ("bsdf.tabulated.table",) + MEDIUM_KEYS


def test_volpath_gradients_match_jax():
    """jax.grad of the JAX volpath render (ad_mode) against the port's
    grad_render on the same scene and seed (16x16, 4 spp, depth 3; MSE
    against a zero image), for the MERL table and the four medium keys.
    The paths and the 48-step tracking cut agree, so the gradients differ
    by rounding and where a lane branches on an ulp: loss within rtol
    1e-5, each gradient within 1e-3 relative L2 error. The density
    gradient is one grid-sized buffer a backward pass (medium.GRID_BUFFERS:
    the tracking calls' backward add into the grid sink's buffer)."""
    d = _grad_scene()
    js, ts = mct.load_dict(d), mt.load_dict(d, "cpu")
    full = jparams.traverse(js)

    def loss(p):
        img = jax_render(jparams.update(js, p), spp=4, seed=0, ad_mode=True)
        return jnp.mean(img ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss))({k: full[k] for k in GRAD_KEYS})
    p = tparams.params_from_numpy({k: np.asarray(full[k]) for k in GRAD_KEYS}, "cpu")
    tmed.GRID_BUFFERS = 0
    tl, tg = ad.grad_render(ts, p, torch.zeros((16, 16, 3)), spp=4, seed=0)
    assert tmed.GRID_BUFFERS == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in GRAD_KEYS:
        got, want = tg[k].numpy(), np.asarray(jg[k])
        assert np.isfinite(got).all() and (want != 0).any(), k
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-3, (k, err)


@pytest.mark.slow  # as the JAX package's test_sigma_t_grad_matches_analytic
def test_sigma_t_grad_matches_analytic():
    """Absorbing fog: d(center) / d(sigma scale) = -sigma chord T L, within
    4 standard errors of the Bernoulli estimator + 0.02."""
    sigma, radius, rad, spp = 1.0, 0.8, 2.0, 256
    scene = mt.load_dict(fog_dict([sigma] * 3, [0.0] * 3, radius, rad, depth=4), "cpu")
    sig = tparams.traverse(scene)["medium.sigma_t"]
    scale = torch.ones((), requires_grad=True)
    img = ad.render_ad(scene, {"medium.sigma_t": sig * scale}, spp=spp, seed=7)
    (g,) = torch.autograd.grad(img[11:13, 11:13].mean(), scale)
    chord = 2.0 * radius
    expect = -sigma * chord * np.exp(-sigma * chord) * rad
    p = np.exp(-sigma * chord)
    stderr = rad * sigma * chord * np.sqrt(p * (1 - p) / (4 * spp * 3))
    assert abs(float(g) - expect) < 4.0 * stderr + 0.02, (float(g), expect)


@pytest.mark.slow  # as the JAX package's test_volume_recovery_sigma
def test_volume_recovery_sigma():
    """Recover a fog's extinction (0.6 -> 1.6) by Adam (lr 0.15, clamped
    at 0.01) on medium.sigma_t: the loss drops below 35 % of its start and
    sigma lands in (1.1, 2.2), the JAX test's bounds."""
    target = mt.render(mt.load_dict(fog_dict([1.6] * 3, [0.0] * 3, depth=4), "cpu"),
                       spp=96, seed=1)
    scene = mt.load_dict(fog_dict([0.6] * 3, [0.0] * 3, depth=4), "cpu")
    sig = tparams.traverse(scene)["medium.sigma_t"].clone().requires_grad_(True)
    opt = torch.optim.Adam([sig], lr=0.15)
    loss0 = None
    for it in range(8):
        loss, grads = ad.grad_render(scene, {"medium.sigma_t": sig}, target, spp=48, seed=it)
        loss0 = float(loss) if loss0 is None else loss0
        sig.grad = grads["medium.sigma_t"]
        opt.step()
        with torch.no_grad():
            sig.clamp_(min=0.01)
    with torch.no_grad():
        final = float(torch.mean((ad.render_ad(scene, {"medium.sigma_t": sig}, spp=48,
                                               seed=99) - target) ** 2))
    assert final < 0.35 * loss0, (loss0, final)
    assert 1.1 < float(sig.detach().mean()) < 2.2
