"""The JAX package's smaller public names, ported: the MERL and
measured_custom modules' BSDF interface (the tabulated core's functions),
core/warp.square_to_std_normal and interval_to_tent,
core/rusinkiewicz.half_diff_to_dirs and half_dir_to_diff, core/math's
angle helpers and constants, render/emitters.prim_surface_area and
render/ptracer.SUPPORTED_EMITTERS, each against its JAX counterpart on
the same seeded numpy inputs: within rtol 1e-5, atol 1e-6 (transcendentals
round apart), the constants and aliases exactly. One torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.core import math as jmath
from mitsuba_customization_tpu.core import rusinkiewicz as jrus
from mitsuba_customization_tpu.core import warp as jwarp
from mitsuba_customization_tpu.models import measured_custom as jcustom
from mitsuba_customization_tpu.models import merl as jmerl
from mitsuba_customization_tpu.render import emitters as jem
from mitsuba_customization_tpu.render import geometry as jgeo
from mitsuba_customization_tpu.render import ptracer as jpt
from mitsuba_customization_tpu_torch.core import math as tmath
from mitsuba_customization_tpu_torch.core import rusinkiewicz as trus
from mitsuba_customization_tpu_torch.core import warp as twarp
from mitsuba_customization_tpu_torch.models import measured_custom as tcustom
from mitsuba_customization_tpu_torch.models import merl as tmerl
from mitsuba_customization_tpu_torch.models import tabulated as ttab
from mitsuba_customization_tpu_torch.render import emitters as tem
from mitsuba_customization_tpu_torch.render import geometry as tgeo
from mitsuba_customization_tpu_torch.render import ptracer as tpt
from test_torch_kernels import one_torch_thread  # noqa: F401


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _dirs(n=4096, seed=0):
    """Seeded unit vectors, some on the poles and the equator."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("module", ["merl", "measured_custom"])
def test_tabulated_interface_aliases(module):
    """merl / measured_custom .eval, .eval_raw, .pdf and .sample are the
    tabulated core's functions, as in the JAX package."""
    mod, ref = (tmerl, jmerl) if module == "merl" else (tcustom, jcustom)
    for name in ("eval", "eval_raw", "pdf", "sample"):
        assert getattr(mod, name) is getattr(ttab, name)
        assert callable(getattr(ref, name))


@pytest.mark.parametrize("name", ["abs_cos_theta", "cos_theta2", "sin_theta", "tan_theta",
                                  "tan_theta2", "cos_phi", "sin_phi"])
def test_math_angle_helpers(name):
    w = _dirs()
    _close(getattr(tmath, name)(torch.as_tensor(w)), getattr(jmath, name)(jnp.asarray(w)))


def test_math_vector_helpers_and_constants():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(512, 3)).astype(np.float32) for _ in range(2))
    t = rng.random((512, 1)).astype(np.float32)
    x = rng.uniform(-1.5, 1.5, 512).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    _close(tmath.abs_dot(ta, tb), jmath.abs_dot(jnp.asarray(a), jnp.asarray(b)))
    _close(tmath.squared_norm(ta), jmath.squared_norm(jnp.asarray(a)))
    _close(tmath.lerp(ta, tb, torch.as_tensor(t)),
           jmath.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    _close(tmath.safe_asin(torch.as_tensor(x)), jmath.safe_asin(jnp.asarray(x)))
    assert tmath.ONE_MINUS_EPSILON == jmath.ONE_MINUS_EPSILON
    assert np.float32(tmath.ONE_MINUS_EPSILON) < 1.0
    assert tmath.INF == jmath.INF


def test_warp_std_normal_and_tent():
    rng = np.random.default_rng(2)
    u = rng.random((4096, 2)).astype(np.float32)
    u[:3] = [[0, 0], [0.5, 0.5], [1 - 1e-7, 1 - 1e-7]]
    _close(twarp.square_to_std_normal(torch.as_tensor(u)),
           jwarp.square_to_std_normal(jnp.asarray(u)))
    _close(twarp.interval_to_tent(torch.as_tensor(u[:, 0])),
           jwarp.interval_to_tent(jnp.asarray(u[:, 0])))


def test_rusinkiewicz_inverse_maps():
    """half_diff_to_dirs and half_dir_to_diff against the JAX package's, and
    half_diff_to_dirs inverting dirs_to_half_diff."""
    rng = np.random.default_rng(3)
    n = 2048
    th = (rng.random(n) * 0.49 * np.pi).astype(np.float32)
    ph = (rng.random(n) * 2 * np.pi - np.pi).astype(np.float32)
    td = (rng.random(n) * 0.49 * np.pi).astype(np.float32)
    pd = (rng.random(n) * 2 * np.pi - np.pi).astype(np.float32)
    got = trus.half_diff_to_dirs(*map(torch.as_tensor, (th, ph, td, pd)))
    want = jrus.half_diff_to_dirs(*map(jnp.asarray, (th, ph, td, pd)))
    for g, w in zip(got, want):
        _close(g, w)
    back = trus.dirs_to_half_diff(*got)
    np.testing.assert_allclose(back[0].numpy(), th, atol=2e-3)
    np.testing.assert_allclose(back[2].numpy(), td, atol=2e-3)
    h, wi = _dirs(n, 4), _dirs(n, 5)
    for g, w in zip(trus.half_dir_to_diff(torch.as_tensor(h), torch.as_tensor(wi)),
                    jrus.half_dir_to_diff(jnp.asarray(h), jnp.asarray(wi))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_prim_surface_area():
    """Areas of triangles, spheres and cylinders of one prim soup."""
    rng = np.random.default_rng(6)
    p = 64
    typ = np.resize([0, 1, 2], p).astype(np.int64)
    p0, e1, e2 = (rng.normal(size=(p, 3)).astype(np.float32) for _ in range(3))
    e1[typ == 1, 0] = np.abs(e1[typ == 1, 0])  # sphere radius e1.x
    e2[typ == 2, 0] = np.abs(e2[typ == 2, 0])  # cylinder radius e2.x
    zeros3 = np.zeros((p, 3), np.float32)
    zeros2 = np.zeros((p, 2), np.float32)
    ints = np.zeros(p, np.int64)
    fields = dict(prim_type=typ, p0=p0, e1=e1, e2=e2, vn0=zeros3, vn1=zeros3, vn2=zeros3,
                  uv0=zeros2, uv1=zeros2, uv2=zeros2, mat_id=ints, emitter_id=ints,
                  shape_id=ints)
    prim = rng.integers(0, p, 300)
    got = tem.prim_surface_area(
        tgeo.Geometry(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        torch.as_tensor(prim))
    jfields = {f: jnp.asarray(fields[f]) for f in jgeo.Geometry._fields}
    want = jem.prim_surface_area(jgeo.Geometry(**jfields), jnp.asarray(prim))
    _close(got, want)


def test_ptracer_supported_emitters():
    assert tpt.SUPPORTED_EMITTERS == jpt.SUPPORTED_EMITTERS
    assert (tem.AREA, tem.POINT, tem.SPOT) == tpt.SUPPORTED_EMITTERS
