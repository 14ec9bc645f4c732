"""The port's reconstruction filters and film against the JAX package's
render/film.py: the filter weights, `splat`, `splat_slab` and `develop`,
every non-box filter and every sampler through load_dict -> render against
the JAX render, and the gradient of a thinlens, gaussian-filtered,
multijittered frame against jax.grad.

Inputs are made from a seed with numpy (one torch thread). Tolerances:
filter weights within rtol 1e-6, atol 1e-7; splat images and weight sums
within rtol 1e-5, atol 1e-6 (sums in another order); frames: per-channel
means within 1 % and the Z-test of tests/reference_renderer.ztest_images
(16x16 JAX frames, jitted); the gradient: loss within rtol 1e-4, the
table gradient within 1e-3 relative L2 error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import film as jfilm
from mitsuba_customization_tpu.render import params as jparams
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import film as tfilm
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.render.integrator import render_lanes
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.scenes import flagship_dict
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_render import _arrays
from test_torch_sensors import CAM, _scene_dict

FILTERS = list(tfilm.FILTER_NAMES)


@pytest.mark.parametrize("name", FILTERS)
def test_filter_weight_matches_jax(name):
    """100,000 offsets in [-2.5, 2.5]^2 (0 and the support edges among
    them): the port's weights are the JAX package's."""
    rng = np.random.default_rng(0)
    dxy = rng.uniform(-2.5, 2.5, (2, 100_000)).astype(np.float32)
    dxy[:, :6] = [[0, 0.5, -0.5, 1, 2, 1e-7], [0, 0.5, 1, -1, 2, 0]]
    ft = tfilm.FILTER_NAMES[name]
    got = tfilm._filter_weight(ft, torch.as_tensor(dxy[0]), torch.as_tensor(dxy[1]))
    want = jfilm._filter_weight(ft, jnp.asarray(dxy[0]), jnp.asarray(dxy[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _samples(n=20_000, h=12, w=16, c=3):
    rng = np.random.default_rng(1)
    values = rng.random((n, c)).astype(np.float32)
    xy = (rng.random((n, 2)) * [w, h]).astype(np.float32)
    xy[:4] = [[0, 0], [w - 1e-3, h - 1e-3], [0.5, 0.5], [w / 2, 0]]
    return values, xy


@pytest.mark.parametrize("slab", [False, True], ids=["splat", "splat_slab"])
@pytest.mark.parametrize("name", FILTERS)
def test_splat_matches_jax(name, slab):
    """20,000 seeded samples on a 16x12 film (corners and edges among
    them): the splat's image and weight sums, and for splat_slab those of
    rows [5, 12) of the film, equal the JAX package's within rtol 1e-5,
    atol 1e-6; develop divides them."""
    values, xy = _samples()
    ft = tfilm.FILTER_NAMES[name]
    tv, txy = torch.as_tensor(values), torch.as_tensor(xy)
    if slab:
        got = tfilm.splat_slab(tv, txy, 5, 7, 12, 16, ft)
        want = jfilm.splat_slab(jnp.asarray(values), jnp.asarray(xy), 5, 7, 12, 16, ft)
    else:
        got = tfilm.splat(tv, txy, 12, 16, ft)
        want = jfilm.splat(jnp.asarray(values), jnp.asarray(xy), 12, 16, ft)
        np.testing.assert_allclose(
            tfilm.develop(tv, txy, 12, 16, ft).numpy(),
            np.asarray(jfilm.develop(jnp.asarray(values), jnp.asarray(xy), 12, 16, ft)),
            rtol=1e-5, atol=1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_slabs_sum_to_the_full_splat():
    """splat_slab over the row slabs [0, 6) and [6, 12), stacked, is the
    full film's splat: a sample's footprint rows outside a slab go to the
    other slab."""
    values, xy = _samples()
    tv, txy = torch.as_tensor(values), torch.as_tensor(xy)
    full, wfull = tfilm.splat(tv, txy, 12, 16, tfilm.GAUSSIAN)
    top, wtop = tfilm.splat_slab(tv, txy, 0, 6, 12, 16, tfilm.GAUSSIAN)
    bot, wbot = tfilm.splat_slab(tv, txy, 6, 6, 12, 16, tfilm.GAUSSIAN)
    torch.testing.assert_close(torch.cat([top, bot]), full, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([wtop, wbot]), wfull, rtol=1e-6, atol=1e-6)


def _flagship(rfilter="box", sampler="independent", sensor=None, res=16, spp=16, depth=3):
    d = flagship_dict(res, spp, depth)
    d["sensor"]["film"]["rfilter"] = {"type": rfilter}
    d["sensor"]["sampler"]["type"] = sampler
    if sensor:
        d["sensor"].update(sensor)
    return d


def assert_frame_matches_jax(d, spp=16):
    js = mct.load_dict(d)
    want = np.asarray(jax.jit(lambda s: jax_render(s, spp, 0))(js))
    scene = mt.load_dict(d, "cpu")
    assert (scene.config.rfilter, scene.config.sampler) == (js.config.rfilter,
                                                            js.config.sampler)
    got = mt.render(scene, spp, 0).numpy()
    mom = mt.render(scene, spp, 1, "moment").numpy()
    var = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    ok, z = ztest_images(got, var, want, var, spp, spp)
    assert ok, z


@pytest.mark.parametrize("name", [f for f in FILTERS if f != "box"])
def test_filter_frame_matches_jax(name):
    """Two spheres on a floor (16x16, 16 spp, depth 3) with each splat
    filter, through load_dict -> render: means within 1 % and the
    Z-test."""
    assert_frame_matches_jax(_scene_dict({
        "type": "perspective", "fov": 45, "to_world": CAM,
        "film": {"width": 16, "height": 16, "rfilter": {"type": name}}}))


def test_box_frames_keep_their_path():
    """A box-filtered frame does not go through the splat: changing the
    film filter of the scene to tent changes the image, and the box image
    is the mean of each pixel's lanes (render_lanes, block order aside)."""
    scene = mt.load_dict(_flagship(spp=4), "cpu")
    box = mt.render(scene, 4, 0)
    tent = mt.render(dataclasses.replace(
        scene, config=dataclasses.replace(scene.config, rfilter="tent")), 4, 0)
    assert not torch.equal(box, tent)
    L, _, _ = render_lanes(scene, 4, 0)
    torch.testing.assert_close(box, L.reshape(16, 16, 4, 3).mean(2), rtol=1e-6, atol=1e-7)


TABLE = "bsdf.tabulated.table"
ALPHA = "bsdf.roughconductor.alpha_u"


def test_thinlens_gaussian_multijitter_gradient_matches_jax():
    """jax.grad of the JAX render (ad_mode) of the flagship seen by a
    thin lens (aperture 0.05, focused on the MERL sphere), gaussian
    filter, multijitter sampler (16x16, 4 spp, depth 2), against the
    port's grad_render on the same scene arrays and seed, through the
    splat: loss within rtol 1e-4, the table gradient within 1e-3 relative
    L2 error, the alpha gradient within rtol 1e-3."""
    d = _flagship("gaussian", "multijitter", {
        "type": "thinlens", "aperture_radius": 0.05, "focus_distance": 4.2}, spp=4, depth=2)
    js = mct.load_dict(d)
    full = jparams.traverse(js)
    keys = (TABLE, ALPHA)

    def loss(p):
        img = jax_render(jparams.update(js, p), spp=4, seed=0, ad_mode=True)
        return jnp.mean(img ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss))({k: full[k] for k in keys})
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    p = tparams.params_from_numpy({k: np.asarray(full[k]) for k in keys}, "cpu")
    tl, tg = ad.grad_render(ts, p, torch.zeros((16, 16, 3)), spp=4, seed=0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    got, want = tg[TABLE].numpy(), np.asarray(jg[TABLE])
    assert np.isfinite(got).all() and (want != 0).any()
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    np.testing.assert_allclose(tg[ALPHA].numpy(), np.asarray(jg[ALPHA]), rtol=1e-3)
