"""Each integrator of the port's render dispatch against the JAX package's
render on one small scene (spheres of diffuse, GGX, plastic, MERL and
glass over a floor, an area light and a dim sky): depth and the aov
types within 1e-5 (atol and rtol: the intersection distance differs by
ulps between torch and XLA, ~1e-5 at t ~ 5); direct and moment (whose L^2 channels give the
variances) by image mean and the per-pixel Z-test of
tests/reference_renderer.
"""

import jax
import numpy as np
import pytest

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render.integrator import render as jax_render
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401

RES, SPP, DEPTH = 16, 8, 3


def scene_dict():
    rng = np.random.default_rng(2)
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": DEPTH},
        "sensor": {"type": "perspective", "fov": 55,
                   "to_world": {"look_at": {"origin": [0, 1.2, -5], "target": [0, 0, 0]}},
                   "film": {"width": RES, "height": RES},
                   "sampler": {"type": "independent", "sample_count": SPP}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse"},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90},
                               "scale": 6.0, "translate": [0, -0.8, 0]}},
        "light": {"type": "rectangle", "emitter": {"type": "area", "radiance": 6.0},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90},
                               "translate": [0.5, 3, -1]}},
        "sky": {"type": "constant", "radiance": 0.2},
    }
    bsdfs = [{"type": "diffuse", "reflectance": [0.7, 0.3, 0.2]},
             {"type": "roughconductor", "alpha": 0.2},
             {"type": "plastic"},
             {"type": "merl", "table": smooth_table(rng)},
             {"type": "dielectric"}]
    for i, b in enumerate(bsdfs):
        d[f"s{i}"] = {"type": "sphere", "center": [-2.4 + 1.2 * i, 0, 0.3 * i],
                      "radius": 0.55, "bsdf": b}
    return d


@pytest.fixture(scope="module")
def scenes():
    d = scene_dict()
    return mct.load_dict(d), mt.load_dict(d, "cpu")


def _jax(scene, integrator):
    return np.asarray(jax.jit(lambda s: jax_render(s, SPP, 0, integrator))(scene))


@pytest.mark.parametrize("integrator", ["depth", "aov", "aov_normals", "aov_position",
                                        "aov_uv"])
def test_camera_ray_integrators_match_jax(scenes, integrator):
    js, ts = scenes
    got = mt.render(ts, SPP, 0, integrator).numpy()
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(js, integrator), rtol=1e-5, atol=1e-5)


def test_direct_matches_jax(scenes):
    """direct is path at max_depth <= 2 on both sides."""
    js, ts = scenes
    got = mt.render(ts, SPP, 0, "direct").numpy()
    want = _jax(js, "direct")
    mom = mt.render(ts, SPP, 1, "moment", 2).numpy()
    var = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0)
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    ok, z = ztest_images(got, var, want, var, SPP, SPP)
    assert ok, z
    # depth 2 is all that direct traces
    np.testing.assert_array_equal(got, mt.render(ts, SPP, 0, "path", 2).numpy())


def test_moment_matches_jax(scenes):
    """moment: six channels [L, L^2], L the path tracer's (without
    compaction); L against the JAX moment by mean and Z-test, L^2 by
    mean."""
    js, ts = scenes
    got = mt.render(ts, SPP, 0, "moment").numpy()
    want = _jax(js, "moment")
    assert got.shape == want.shape == (RES, RES, 6)
    var = np.maximum(got[..., 3:] - got[..., :3] ** 2, 0.0)
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    ok, z = ztest_images(got[..., :3], var, want[..., :3], var, SPP, SPP)
    assert ok, z
    # the same paths as path's (the film's mean over 6 channels rounds
    # its sums in another order)
    np.testing.assert_allclose(got[..., :3], mt.render(ts, SPP, 0, "path").numpy(),
                               rtol=1e-6, atol=1e-7)
