"""The port's light tracer (render/ptracer.py) and bidirectional tracer
(render/bdpt.py) against the JAX package's.

connect_sensor, sample_emitter_ray (area, point and spot emitters) and
emitters.pdf_hit_area on the same inputs, allclose; ptracer and bdpt
frames at 24x24 through both packages' loaders at the same seed, whose
light paths draw the same numbers: image means within 2 % and the
per-pixel Z-test of tests/reference_renderer (the variance from the
spread of the port's frames at two seeds); the rejections with the JAX
package's messages; and, marked slow as their JAX counterparts are, the
port's ptracer and bdpt against its path tracer by the JAX tests'
aggregate rules (tests/test_ptracer.py, tests/test_bdpt.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import bdpt as jbdpt
from mitsuba_customization_tpu.render import emitters as jem
from mitsuba_customization_tpu.render import ptracer as jpt
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu.render.records import Ray as JRay
from mitsuba_customization_tpu_torch.render import emitters as tem
from mitsuba_customization_tpu_torch.render import ptracer as tpt
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.scenes import (
    BDPT_SMALL_LIGHT,
    aggregate_agreement,
    bdpt_spheres_dict,
    light_paths_vs_path,
    ptracer_box_dict,
)
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401

RES, SPP = 24, 16


def box_dict(integrator, spp=SPP, depth=3, res=RES, lights=None, sensor=None):
    """tests/test_ptracer.py's box (scenes.ptracer_box_dict) with other
    lights or another sensor."""
    d = ptracer_box_dict(integrator, spp, depth, res)
    if sensor is not None:
        d["sensor"] = sensor
    if lights is not None:
        del d["lamp"]
        d.update(lights)
    return d


LIGHTS = {
    "lamp": {"type": "rectangle", "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90},
                                               "scale": 0.8, "translate": [0, 2.4, 0]},
             "emitter": {"type": "area", "radiance": [8.0, 7.0, 6.0]}},
    "bulb": {"type": "sphere", "center": [1.5, 1.5, 0.5], "radius": 0.2,
             "emitter": {"type": "area", "radiance": [3.0, 3.0, 3.0]}},
    "point": {"type": "point", "position": [-1.0, 2.0, -0.5], "intensity": [5.0, 4.0, 3.0]},
    "spot": {"type": "spot", "intensity": [9.0, 9.0, 9.0], "cutoff_angle": 30,
             "beam_width": 20,
             "to_world": {"look_at": {"origin": [0, 3, -1], "target": [0, 0, 0]}}},
}


@pytest.fixture(scope="module")
def light_scenes():
    d = box_dict("ptracer", lights=LIGHTS)
    return mct.load_dict(d), mt.load_dict(d, "cpu")


def _u(n, k, seed):
    return np.random.default_rng(seed).random((n, k)).astype(np.float32)


def test_sample_emitter_ray_matches_jax(light_scenes):
    """Every emitter type of a ptracer scene (two area emitters, a point
    and a spot): origins, directions, beta, the emission vertex and its
    weights within rtol 1e-5, atol 1e-5 (the origin is offset 1e-4 along
    the normal; beta's values reach ~1e3)."""
    js, ts = light_scenes
    n = 4096
    u = _u(n, 4, 1)
    want = jpt.sample_emitter_ray(js.emitters, js.geometry, jnp.asarray(u[:, 0]),
                                  jnp.asarray(u[:, 1]), jnp.asarray(u[:, 2:]))
    got = tpt.sample_emitter_ray(ts.emitters, ts.geometry, *(
        torch.as_tensor(x) for x in (u[:, 0], u[:, 1], u[:, 2:])))
    kinds = set(np.asarray(js.emitters.em_type)[np.asarray(
        js.emitters.select.sample_reuse(jnp.asarray(u[:, 0]))[0])].tolist())
    assert kinds == {jem.AREA, jem.POINT, jem.SPOT}
    (jray, *jrest), (tray, *trest) = want, got
    for a, b in zip((tray.o, tray.d, *trest), (jray.o, jray.d, *jrest)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_connect_sensor_matches_jax(light_scenes):
    """Film positions, directions to the camera and importances within
    rtol 1e-5 (atol 1e-4 on film pixels), validity equal, on points in
    front of, beside and behind the camera."""
    js, ts = light_scenes
    p = (np.random.default_rng(2).uniform(-4, 4, (4096, 3))).astype(np.float32)
    want = jpt.connect_sensor(js.sensor, jnp.asarray(p), RES, RES)
    got = tpt.connect_sensor(ts.sensor, torch.as_tensor(p), RES, RES)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert 0.05 < got[3].numpy().mean() < 0.95
    ok = got[3].numpy()
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def test_pdf_hit_area_matches_jax(light_scenes):
    """On the JAX package's hits of rays aimed at the emitters (and past
    them): the area density of the hit point, rtol 1e-6."""
    js, ts = light_scenes
    rng = np.random.default_rng(3)
    n = 2048
    o = np.tile(np.asarray([[0.2, 0.8, -1.5]], np.float32), (n, 1))
    target = np.where(rng.random((n, 1)) < 0.5, [[0, 2.4, 0]], [[1.5, 1.5, 0.5]])
    d = target + rng.normal(scale=0.5, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jsi = js.ray_intersect(JRay.make(jnp.asarray(o), jnp.asarray(d)))
    tsi = ts.ray_intersect(Ray.make(torch.as_tensor(o), torch.as_tensor(d)))
    np.testing.assert_array_equal(tsi.emitter.numpy(), np.asarray(jsi.emitter))
    want = np.asarray(jem.pdf_hit_area(js.emitters, jsi))
    got = tem.pdf_hit_area(ts.emitters, tsi).numpy()
    assert (want > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _frames(d, spp=SPP):
    scene = mt.load_dict(d, "cpu")
    got, other = (mt.render(scene, spp, s).numpy() for s in (0, 1))
    js = mct.load_dict(d)  # closed over: ptracer and bdpt read the sensor type on the host
    want = np.asarray(jax.jit(lambda: jax_render(js, spp, 0))())
    return got, other, want


@pytest.mark.parametrize("integrator", ["ptracer", "bdpt"])
def test_frame_matches_jax(integrator):
    """ptracer on tests/test_ptracer.py's box; bdpt on tests/test_bdpt.py's
    spheres lit by its small bright emitter near the floor (the t = 1
    strategy carries real weight there). Means within 2 %; the Z-test at
    4 sigma on >= 99.5 % of pixels."""
    d = (box_dict(integrator) if integrator == "ptracer"
         else bdpt_spheres_dict(integrator, SPP, 4, RES, **BDPT_SMALL_LIGHT))
    got, other, want = _frames(d)
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    var = 0.5 * (got - other) ** 2 * SPP + 1e-4
    ok, z = ztest_images(got, var, want, var, SPP, SPP)
    assert ok, z


def test_rejections_carry_the_jax_messages():
    batch = {"type": "batch",
             "a": {"type": "perspective", "to_world": {"look_at": {
                 "origin": [0, 1, -3], "target": [0, 0.5, 0]}}},
             "film": {"width": 8, "height": 4}}
    ortho = {"type": "orthographic", "film": {"width": 8, "height": 8}}
    for integrator, fn in (("ptracer", jpt.render_ptracer), ("bdpt", jbdpt.render_bdpt)):
        for sensor in (batch, ortho):
            d = box_dict(integrator, sensor=sensor)
            with pytest.raises(ValueError) as want:
                fn(mct.load_dict(d), spp=1)
            with pytest.raises(ValueError) as got:
                mt.render(mt.load_dict(d, "cpu"), 1)
            assert str(got.value) == str(want.value)
    sky = {"sky": {"type": "constant", "radiance": [1, 1, 1]}}
    with pytest.raises(ValueError, match="ptracer supports area/point/spot emitters; "
                                         "scene has constant"):
        mt.load_dict(box_dict("ptracer", lights=sky), "cpu")
    d = box_dict("bdpt", lights={"point": LIGHTS["point"]})
    with pytest.raises(ValueError) as want:
        jbdpt.render_bdpt(mct.load_dict(d), spp=1)
    with pytest.raises(ValueError) as got:
        mt.render(mt.load_dict(d, "cpu"), 1)
    assert str(got.value) == str(want.value) and "bdpt supports area emitters" in str(got.value)
    d = box_dict("bdpt")
    d["fog"] = {"type": "sphere", "bsdf": {"type": "null"}, "interior": {"type": "homogeneous"}}
    with pytest.raises(ValueError, match="bdpt does not support participating media"):
        mt.render(mt.load_dict(d, "cpu"), 1)


@pytest.mark.slow  # as the JAX package's test_ptracer_matches_path
def test_ptracer_matches_path():
    path_img, img, tol = light_paths_vs_path("cpu")["ptracer"]
    ok, diff, ncc = aggregate_agreement(path_img, img, tol)
    assert ok, (diff, ncc)


@pytest.mark.slow  # as the JAX package's test_bdpt_matches_path_glossy
def test_bdpt_matches_path_glossy():
    path_img, img, tol = light_paths_vs_path("cpu")["bdpt"]
    assert np.isfinite(img).all()
    ok, diff, ncc = aggregate_agreement(path_img, img, tol)
    assert ok, (diff, ncc)
