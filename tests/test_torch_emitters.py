"""The port's emitters against the JAX package: the envmap's sampling
distribution at envmap size, every emitter type's NEE sample, miss pdf,
background and hit radiance on the same scene arrays, whole frames of the
JAX tests' emitter scenes, and the gradients of a textured, envmap-lit
frame against jax.grad.

The same numpy inputs, made from a seed, go through both packages (one
torch thread); tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.core.distr import Marginal2D as JMarginal2D
from mitsuba_customization_tpu.render import emitters as jem
from mitsuba_customization_tpu.render import params as jparams
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu.render.records import Ray as JRay
from mitsuba_customization_tpu_torch.core.distr import Marginal2D
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import emitters as tem
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.render.records import Ray
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_render import _arrays


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _sky(rng, h, w):
    """An HDR lat-long sky: a vertical gradient, noise, and a sun disc
    ~1e3 brighter."""
    y = (np.arange(h) + 0.5) / h
    img = (0.2 + 0.8 * (1 - y))[:, None, None] * np.float32([0.5, 0.7, 1.0])
    img = img + 0.05 * rng.random((h, w, 3))
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sun = (yy - 0.3 * h) ** 2 + (xx - 0.6 * w) ** 2 < (0.03 * h) ** 2 + 1
    img[sun] = [900.0, 850.0, 700.0]
    return img.astype(np.float32)


def test_env_distribution_at_envmap_size():
    """build_env_distribution of a 1024 x 2048 sky: the port's pdf and CDFs
    within float32 rounding of the JAX package's (rtol 1e-5, atol 2e-6;
    the two cumsums round differently). On the JAX CDFs, sample and
    eval_pdf give the JAX positions within 1e-6 and equal pdfs on all but
    <= 0.2 % of lanes: XLA's cumsum leaves some rows decreasing by an ulp
    (the port's binary search assumes nondecreasing rows, as the masked
    reduction does not)."""
    img = _sky(np.random.default_rng(0), 1024, 2048)
    want = jem.build_env_distribution(jnp.asarray(img))
    got = tem.build_env_distribution(_t(img))
    for name, g, w in zip(Marginal2D._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-6,
                                   err_msg=name)
    assert bool((got.cdf_cond[:, 1:] >= got.cdf_cond[:, :-1]).all())
    same = Marginal2D(*(_t(np.asarray(f)) for f in want))
    u = np.random.default_rng(1).random((20000, 2)).astype(np.float32)
    jpos, jpdf = JMarginal2D.sample(want, jnp.asarray(u))
    pos, pdf = same.sample(_t(u))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    assert np.mean(pdf.numpy() == np.asarray(jpdf)) >= 0.998
    np.testing.assert_array_equal(same.eval_pdf(_t(np.asarray(jpos))).numpy(),
                                  np.asarray(want.eval_pdf(jpos)))


def _floor_dict(emitters, res=24, spp=16, depth=2, cam=None):
    """The JAX tests' floor scene (tests/test_plugins4.py::_floor_scene):
    a diffuse floor seen from the side, under `emitters`."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": mt.look_at([0, 3.9, -2.6], [0, 0, 0], [0, 1, 0])
                   if cam is None else cam,
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle",
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 6.0},
                  "bsdf": {"type": "diffuse", "reflectance": [0.8, 0.8, 0.8]}},
        **emitters,
    }


def _projector_texture():
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0  # left half red
    tex[:, 4:, 2] = 1.0  # right half blue
    return tex


EMITTERS = {
    "point": {"light": {"type": "point", "position": [0, 3, 0], "intensity": [10, 10, 10]}},
    "spot": {"light": {"type": "spot", "intensity": [30, 25, 20], "cutoff_angle": 35,
                       "beam_width": 20,
                       "to_world": mt.look_at([0.5, 3, 0], [0, 0, 0.3], [0, 0, 1])}},
    "directional": {"sun": {"type": "directional", "direction": [0.3, -1, 0.2],
                            "irradiance": [2.0, 1.8, 1.5]}},
    "directionalarea": {"panel": {
        "type": "rectangle",
        "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "translate": [0, 2.0, 0]},
        "emitter": {"type": "directionalarea", "radiance": [4.0, 4.0, 4.0]}}},
    "projector": {"beam": {"type": "projector", "fov": 30, "bitmap": _projector_texture(),
                           "scale": 40.0,
                           "to_world": mt.look_at([0, 3.0, 0], [0, 0, 0], [0, 0, 1])}},
    "envmap": {"env": {"type": "envmap", "bitmap": _sky(np.random.default_rng(2), 32, 64),
                       "scale": 0.5, "to_world": {"rotate": {"axis": [0, 1, 0], "angle": 40}}}},
    "mixed": {"light": {"type": "point", "position": [1, 2, 0], "intensity": [5, 5, 5]},
              "sky": {"type": "constant", "radiance": [0.1, 0.1, 0.1]},
              "lamp": {"type": "sphere", "center": [-1, 1.5, 0.5], "radius": 0.3,
                       "emitter": {"type": "area", "radiance": [10, 10, 10]}},
              "sun": {"type": "directional", "direction": [0, -1, 0.5]}},
}


@pytest.mark.parametrize("name", list(EMITTERS))
def test_emitter_queries_match_jax(name):
    """On scene_from_numpy of the JAX scene: sample_direction at floor
    points (d, dist, pdf, radiance, delta), pdf_miss_direction and
    eval_background over the sphere of directions, and eval_hit of camera
    hits: rtol 1e-5 (atol 1e-6; directions atol 1e-5, NEE pdfs rtol 2e-5,
    the envmap's miss pdf near its poles rtol 1e-3). The port's tables equal its own
    loader's, but for the constant sky's NEE weight (0 beside other
    emitters, 1e-20 in the JAX package: ROADMAP §3)."""
    d = _floor_dict(EMITTERS[name])
    js = mct.load_dict(d)
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    own = mt.load_dict(d, "cpu").emitters
    assert own.present == ts.emitters.present and own.env_index == ts.emitters.env_index
    for f in ("em_type", "radiance", "position", "direction", "cutoff_cos", "beam_cos",
              "env_image", "proj_image", "env_to_world", "proj_to_world"):
        torch.testing.assert_close(getattr(own, f), getattr(ts.emitters, f), rtol=0, atol=0,
                                   msg=f)
    torch.testing.assert_close(own.select.pmf, ts.emitters.select.pmf, rtol=0, atol=1e-19)
    rng = np.random.default_rng(3)
    n = 4000
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 1.5, n), rng.uniform(-3, 3, n)],
                 -1).astype(np.float32)
    u = rng.random((n, 3)).astype(np.float32)
    want = jem.sample_direction(js.emitters, js.geometry, jnp.asarray(p), jnp.asarray(u))
    got = tem.sample_direction(ts.emitters, ts.geometry, _t(p), _t(u))
    assert got.pdf.gt(0).any()
    for f in ("d", "dist", "pdf", "radiance", "delta"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        # a solid-angle pdf divides by the emitter's cosine: rtol 2e-5
        # (measured 1.04e-5 on a grazing area-light sample)
        tol = {"d": dict(rtol=0, atol=1e-5), "pdf": dict(rtol=2e-5, atol=1e-6)}.get(
            f, dict(rtol=1e-5, atol=1e-6))
        np.testing.assert_allclose(g, w, err_msg=f, **tol)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    # within 0.1 rad of the envmap's poles the miss pdf's 1 / sin(theta)
    # magnifies an ulp of the rotated direction (torch's and XLA's 3x3
    # products round apart on ~30 % of lanes): rtol 1e-3 there
    polar = np.abs(dirs @ np.asarray(js.emitters.env_to_world)[:, 2]) > np.cos(0.1)
    for fn in ("pdf_miss_direction", "eval_background"):
        g = getattr(tem, fn)(ts.emitters, _t(dirs)).numpy()
        w = np.asarray(getattr(jem, fn)(js.emitters, jnp.asarray(dirs)))
        np.testing.assert_allclose(g[~polar], w[~polar], rtol=1e-5, atol=1e-6, err_msg=fn)
        np.testing.assert_allclose(g[polar], w[polar], rtol=1e-3, atol=1e-6, err_msg=fn)
    o = np.tile(np.float32([0, 3.9, -2.6]), (n, 1))
    jsi = js.ray_intersect(JRay.make(jnp.asarray(o), jnp.asarray(dirs)))
    tsi = ts.ray_intersect(Ray.make(_t(o), _t(dirs)))
    np.testing.assert_allclose(tem.eval_hit(ts.emitters, tsi).numpy(),
                               np.asarray(jem.eval_hit(js.emitters, jsi)), rtol=1e-5)


def _frames(d, spp):
    want = np.asarray(jax.jit(lambda s: jax_render(s, spp, 0))(mct.load_dict(d)))
    scene = mt.load_dict(d, "cpu")
    got = mt.render(scene, spp, 0).numpy()
    mom = mt.render(scene, spp, 1, "moment").numpy()
    return got, np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0), want


def _envmap_sphere():
    """A MERL-free envmap frame: a roughconductor sphere and a textured
    floor under a rotated HDR sky with a sun."""
    d = _floor_dict(EMITTERS["envmap"], res=24, spp=16, depth=3,
                    cam=mt.look_at([0, 1.5, -4], [0, 0.3, 0], [0, 1, 0]))
    d["ball"] = {"type": "sphere", "center": [0, 0.8, 0], "radius": 0.8,
                 "bsdf": {"type": "roughconductor", "alpha": 0.2}}
    return d


@pytest.mark.parametrize("name", ["point", "spot", "directionalarea", "projector", "envmap"])
def test_emitter_frame_matches_jax(name):
    """Whole frames (24x24, 16 spp): per-channel means within 1 % and the
    Z-test (4 sigma on >= 99.5 % of pixels); and the JAX tests' own
    expectations: the point light's inverse square under it
    (tests/test_render.py::test_point_light_inverse_square), the
    directionalarea footprint and the projector's left-red / right-blue
    pattern (tests/test_plugins4.py)."""
    if name == "envmap":
        d = _envmap_sphere()
    elif name == "point":
        d = _floor_dict(EMITTERS["point"], res=32, cam=mt.look_at([0, 2, -4], [0, 0, 0],
                                                                  [0, 1, 0]))
        d["sensor"]["fov"] = 40
        d["floor"]["to_world"]["scale"] = 10.0
        d["floor"]["bsdf"]["reflectance"] = [1.0, 1.0, 1.0]
    elif name == "directionalarea":
        # from below the panel: seen from above (the JAX test's camera),
        # the panel's own points project onto it at t = +-1e-7, whose sign
        # the two packages round apart (its expectations are checked on
        # the port's frame from that camera below)
        d = _floor_dict(EMITTERS[name], cam=mt.look_at([0, 1.5, -4], [0, 0.5, 0], [0, 1, 0]))
    else:
        d = _floor_dict(EMITTERS[name])
    got, var, want = _frames(d, 16)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    ok, z = ztest_images(got, var, want, var, 16, 16)
    assert ok, z
    res = got.shape[0]
    mid = res // 2
    if name == "point":
        expected = 10 / (np.pi * 9)
        assert abs(got[16:20, 14:18].mean() - expected) / expected < 0.1
    elif name == "directionalarea":
        got = mt.render(mt.load_dict(_floor_dict(EMITTERS[name]), "cpu"), 32, 0).numpy()
        expected = 0.8 / np.pi * 4.0
        assert abs(got[mid, mid, 0] - expected) < 0.15 * expected
        assert got[1, 1, 0] < 0.02 * expected
    elif name == "projector":
        left, right = got[mid, mid - 2], got[mid, mid + 2]
        assert left[0] > 5 * max(left[2], 1e-6) and right[2] > 5 * max(right[0], 1e-6)
        assert got[1, 1].max() < 0.05 * max(left[0], right[2])


def test_textured_envmap_gradients_match_jax():
    """jax.grad of the JAX render (ad_mode, MSE against a zero image) of a
    bitmap-textured floor and a checkerboard sphere under an envmap and a
    spot, at 16x16, 4 spp, depth 3, against the port's grad_render on the
    same scene arrays and seed, for `bsdf.textured_diffuse.images` and
    `emitter.env_image`: the loss within rtol 1e-5, each gradient within
    1e-3 relative L2 error (measured 1.2e-6 and 9.6e-6). The envmap's
    gradient includes the path through its sampling distribution, which
    update() rebuilds from the image, as the JAX package does."""
    rng = np.random.default_rng(4)
    d = _floor_dict({"env": EMITTERS["envmap"]["env"], "spot": EMITTERS["spot"]["light"]},
                    res=16, spp=4, depth=3, cam=mt.look_at([0, 1.5, -4], [0, 0.3, 0], [0, 1, 0]))
    d["floor"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "bitmap", "bitmap": rng.random((8, 12, 3)), "uv_scale": [3, 3]}}
    d["ball"] = {"type": "sphere", "center": [0, 0.8, 0], "radius": 0.8,
                 "bsdf": {"type": "diffuse", "reflectance": {"type": "checkerboard"}}}
    keys = ("bsdf.textured_diffuse.images", "emitter.env_image")
    js = mct.load_dict(d)
    full = jparams.traverse(js)

    def loss(p):
        img = jax_render(jparams.update(js, p), spp=4, seed=0, ad_mode=True)
        return jnp.mean(img ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss))({k: full[k] for k in keys})
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    p = tparams.params_from_numpy({k: np.asarray(full[k]) for k in keys}, "cpu")
    tl, tg = ad.grad_render(ts, p, torch.zeros((16, 16, 3)), spp=4, seed=0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in keys:
        got, want = tg[k].numpy(), np.asarray(jg[k])
        assert got.shape == want.shape and np.isfinite(got).all() and (want != 0).any()
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want), k
