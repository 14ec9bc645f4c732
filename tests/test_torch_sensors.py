"""The port's sensors against the JAX package's render/sensors.py: the
primary rays of every sensor type and of a batch sensor, each sensor
through load_dict -> render against the JAX render, and the JAX tests'
expectations of the measurement and batch sensors on the port.

Inputs are made from a seed with numpy (one torch thread). Tolerances:
ray origins and directions within rtol 1e-5, atol 1e-6 (the JAX package
rotates with a matrix product, the port elementwise); the loaded sensor's
fields equal the JAX loader's; frames: per-channel means within 1 % and
the Z-test of tests/reference_renderer.ztest_images (4 sigma on >= 99.5 %
of pixels). The JAX frames are 16x16 (1x1 for the meters) and jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import sensors as jsensors
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.render import sensors as tsensors
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.scenes import batch_strip_means, meter_dict
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_render import _arrays

CAM = tsensors.look_at([0.3, 1.5, -4], [0, 0.2, 0], [0, 1, 0])
KW = dict(fov_x=50.0, aperture_radius=0.1, focus_distance=3.5, near_clip=0.01,
          ortho_scale=1.5)
BATCH = ("perspective", "thinlens", "orthographic")


def _jax_sensor(kind):
    if kind != "batch":
        return jsensors.make_sensor(kind, CAM, **KW)
    kids = [jsensors.make_sensor(k, tsensors.look_at([0.5 * i, 1.5, -4], [0, 0, 0], [0, 1, 0]),
                                 **KW) for i, k in enumerate(BATCH)]
    st = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *kids)
    return st._replace(child_types=st.sensor_type)


def _port_sensor(kind):
    if kind != "batch":
        return tsensors.make_sensor(kind, CAM, **KW, device="cpu")
    return tsensors.stack_sensors([
        tsensors.make_sensor(k, tsensors.look_at([0.5 * i, 1.5, -4], [0, 0, 0], [0, 1, 0]),
                             **KW, device="cpu") for i, k in enumerate(BATCH)])


@pytest.mark.parametrize("kind", list(tsensors.SENSOR_TYPES) + ["batch"])
def test_sample_ray_matches_jax(kind):
    """4,096 film and aperture samples: origins and directions of each
    sensor type, and of a batch of a perspective, a thinlens and an
    orthographic child, as the JAX package computes them (aspect 1.5)."""
    rng = np.random.default_rng(3)
    uv = rng.random((4096, 2)).astype(np.float32)
    ap = rng.random((4096, 2)).astype(np.float32)
    want = jsensors.sample_ray(_jax_sensor(kind), jnp.asarray(uv), jnp.asarray(ap), 1.5)
    got = tsensors.sample_ray(_port_sensor(kind), torch.as_tensor(uv), torch.as_tensor(ap), 1.5)
    for name in ("o", "d"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _scene_dict(sensor, res=16, spp=16, shape="sphere"):
    """Two spheres (or cubes; diffuse, GGX) on a diffuse floor under a sky,
    seen by `sensor` (its film and sampler filled in)."""
    sensor = dict(sensor)
    sensor.setdefault("film", {"width": res, "height": res})
    sensor.setdefault("sampler", {"type": "independent", "sample_count": spp})

    def place(center):
        if shape == "sphere":
            return {"type": "sphere", "center": center, "radius": 0.7}
        return {"type": "cube", "to_world": {"scale": 0.6, "translate": center}}

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": sensor,
        "a": dict(place([-0.7, 0, 0]),
                  bsdf={"type": "diffuse", "reflectance": [0.8, 0.3, 0.2]}),
        "b": dict(place([0.9, 0, 0.4]), bsdf={"type": "roughconductor", "alpha": 0.2}),
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.6] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 6.0,
                               "translate": [0, -0.7, 0]}},
        "sky": {"type": "constant", "radiance": [0.8, 0.9, 1.0]},
    }


SENSORS = {
    "thinlens": {"type": "thinlens", "fov": 45, "to_world": CAM, "aperture_radius": 0.08,
                 "focus_distance": 4.0},
    "orthographic": {"type": "orthographic", "to_world": CAM, "ortho_scale": 2.0},
    "distant": {"type": "distant", "to_world": CAM, "ortho_scale": 2.0},
    "batch": {"type": "batch",
              "l": {"type": "thinlens", "fov": 45, "to_world": CAM, "aperture_radius": 0.05,
                    "focus_distance": 4.0},
              "r": {"type": "orthographic", "ortho_scale": 1.5,
                    "to_world": tsensors.look_at([-2, 1, -3], [0, 0, 0], [0, 1, 0])}},
    "radiancemeter": {"type": "radiancemeter",
                      "to_world": tsensors.look_at([0, 2, -3], [-0.7, 0, 0], [0, 1, 0])},
    "irradiancemeter": {"type": "irradiancemeter",
                        "to_world": tsensors.look_at([0, 2, -3], [-0.7, 0, 0], [0, 1, 0])},
}


def _frames(d, spp):
    """(port image, port per-pixel variance, JAX image) at seed 0."""
    js = mct.load_dict(d)
    want = np.asarray(jax.jit(lambda s: jax_render(s, spp, 0))(js))
    scene = mt.load_dict(d, "cpu")
    got = mt.render(scene, spp, 0).numpy()
    mom = mt.render(scene, spp, 1, "moment").numpy()
    var = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0)
    return scene, js, got, var * scene.config.sensor_scale ** 2, want


@pytest.mark.parametrize("name", list(SENSORS))
def test_sensor_frame_matches_jax(name):
    """Each sensor through load_dict -> render (16x16, 16 spp; the meters
    1x1 at 256 spp): the loaded sensor and config equal the JAX loader's,
    and the frame agrees with the JAX render (means within 1 %, Z-test).
    The distant sensor's rays start 1e4 away, where the sphere test's
    quadratic has lost its float32 precision in either package, so its
    scene has cubes in place of the spheres."""
    meter = name.endswith("meter")
    spp = 256 if meter else 16
    d = _scene_dict(SENSORS[name], spp=spp, shape="cube" if name == "distant" else "sphere")
    if meter:
        del d["sensor"]["film"]
    scene, js, got, var, want = _frames(d, spp)
    ref = scene_from_numpy(_arrays(js), js.config, "cpu")
    for f, a, b in zip(tsensors.Sensor._fields, scene.sensor, ref.sensor):
        assert (a is None) == (b is None), f
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    for f in ("width", "height", "sampler", "rfilter", "sensor_scale", "spp"):
        assert getattr(scene.config, f) == getattr(js.config, f), f
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    ok, z = ztest_images(got, var, want, var, spp, spp)
    assert ok, z


def _meter(kind, want, rtol):
    scene = mt.load_dict(meter_dict(kind), "cpu")
    img = mt.render(scene, spp=scene.config.spp, seed=0).numpy()
    assert img.shape == (1, 1, 3)
    np.testing.assert_allclose(img[0, 0], want, rtol=rtol)


def _radiancemeter():
    _meter("radiancemeter", 0.5, 0.05)


def _irradiancemeter():
    _meter("irradiancemeter", np.pi, 0.02)


def _batch_strips():
    strips, halves = batch_strip_means("cpu")
    assert abs(strips[0] - halves[0]) < 0.05 and abs(strips[1] - halves[1]) < 0.05


@pytest.mark.parametrize("check", [_radiancemeter, _irradiancemeter, _batch_strips],
                         ids=["radiancemeter", "irradiancemeter", "batch_strips"])
def test_jax_sensor_expectations_hold_on_the_port(check):
    """The JAX package's tests, on the port: the radiancemeter reads a
    diffuse wall of albedo 0.5 under unit light as 0.5 within 5 %
    (tests/test_render.py::test_radiancemeter_pointwise, 256 spp), the
    irradiancemeter a unit field as pi within 2 % (512 spp)
    (::test_irradiancemeter_constant_field), and a batch of two
    perspective sensors renders the two half-width frames side by side
    (tests/test_plugins4.py::test_batch_sensor_strips, means within
    0.05)."""
    check()


def test_make_sensor_takes_the_references_order():
    """make_sensor(sensor_type, to_world, fov_x, ...) in the reference's
    positional order, with the device keyword-only: a reference-style call
    makes a thinlens sensor with those values."""
    s = tsensors.make_sensor("thinlens", CAM, 30.0, 0.2, 2.5, device="cpu")
    assert int(s.sensor_type) == tsensors.THINLENS
    assert float(s.fov_x) == 30.0 and float(s.aperture_radius) == pytest.approx(0.2)
    assert float(s.focus_distance) == 2.5
    with pytest.raises(TypeError):
        tsensors.make_sensor("perspective", CAM, 30.0, 0.0, 1.0, 1e-3, 1.0, "cpu")
