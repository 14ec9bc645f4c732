"""The repository's production configuration on the port against the JAX
package: `__graft_entry__._production_scene` (volpath with a compaction
schedule, a 320-triangle MERL mesh on the cluster intersector, a null
sphere around a homogeneous medium, a GGX floor, an area light, a sky and
the gaussian splat filter) and the port's literal of it,
scenes.production_dict, at 32x32: the same prims, then image means within
2 % and the per-pixel Z-test of tests/reference_renderer (variances from
the spread of the port's frames at two seeds). Its 2-rank sharded render
is tests/test_torch_parallel.py's production case.
"""

import jax
import numpy as np

import mitsuba_customization_tpu_torch as mt
from __graft_entry__ import _production_scene
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.scenes import production_dict
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 32, 16, 3


def test_production_frame_matches_jax():
    js = _production_scene(RES, SPP, DEPTH)
    ts = mt.load_dict(production_dict(RES, SPP, DEPTH), "cpu")
    assert ts.config.intersector == "cluster" and ts.config.rfilter == "gaussian"
    assert ts.media.n_media == 1 and ts.config.compact == (1.0, 0.8, 0.6)
    np.testing.assert_array_equal(ts.geometry.p0.numpy(), np.asarray(js.geometry.p0))
    want = np.asarray(jax.jit(lambda s: jax_render(s, SPP, 0))(js))
    got = mt.render(ts, SPP, 0).numpy()
    other = mt.render(ts, SPP, 1).numpy()
    assert got.shape == want.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    var = 0.5 * (got - other) ** 2 * SPP + 1e-4
    ok, z = ztest_images(got, var, want, var, SPP, SPP)
    assert ok, z
