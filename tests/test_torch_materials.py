"""The materials and blend frames against the JAX package, the blended
scene's table gradient against jax.grad, and the reflective frames held
bit-equal to the port before transmissive kernels existed.

The frames are chip_smoke.py's materials scene (matpreview bands of merl,
conductor, the dielectrics, plastic, roughplastic, principled, twosided;
a Beckmann floor) and its blend scene (null, mask and blendbsdf bands), at
32x32 with a 1,280-triangle blob, compared by image mean and a per-pixel
Z-test (variances from the port's `moment` render). Reflective-only
scenes keep the NEE horizon cull: their images and gradients at a fixed
seed hash to the values the port rendered before transmissive kernels
existed.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from chip_smoke import material_bands
from mitsuba_customization_tpu.render import params as jparams
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy, traverse
from mitsuba_customization_tpu_torch.scenes import flagship_dict, matpreview_dict
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401

RES, SPP, DEPTH = 32, 4, 3
TABLE = "bsdf.tabulated.table"


def _arrays(scene):
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def _frame_dict(blend):
    return material_bands(matpreview_dict(RES, SPP, DEPTH, n_sub=3, n_materials=12),
                          blend=blend)


@pytest.mark.parametrize("blend", [False, True], ids=["materials", "blend"])
def test_frame_matches_jax(blend):
    """The port's load_dict -> render against the JAX package's on the same
    dict and seed: per-channel means within 2 %, and the per-pixel Z-test
    of reference_renderer (4 sigma on >= 99.5 % of pixels)."""
    d = _frame_dict(blend)
    want = np.asarray(jax.jit(lambda s: jax_render(s, SPP, 0))(mct.load_dict(d)))
    scene = mt.load_dict(d, "cpu")
    assert (scene.shadow_clusters is not None) == blend
    got = mt.render(scene, SPP, 0).numpy()
    mom = mt.render(scene, SPP, 1, "moment").numpy()
    var = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0)
    assert got.shape == want.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    ok, z = ztest_images(got, var, want, var, SPP, SPP)
    assert ok, z


def _blend_spheres(tables, res, spp, depth):
    """Spheres over a floor under an area light: merl, blendbsdf(merl,
    roughplastic), mask(merl), a null sphere, and a diffuse floor."""
    merl = [{"type": "merl", "table": t} for t in tables]
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": {"look_at": {"origin": [0, 1.5, -5], "target": [0, 0, 0]}},
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse"},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90},
                               "scale": 6.0, "translate": [0, -1, 0]}},
        "light": {"type": "rectangle", "emitter": {"type": "area", "radiance": 8.0},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90},
                               "translate": [0, 3, -1]}},
        "sky": {"type": "constant", "radiance": 0.1},
    }
    bsdfs = [merl[0],
             {"type": "blendbsdf", "weight": 0.3, "a": merl[1],
              "b": {"type": "roughplastic", "alpha": 0.2}},
             {"type": "mask", "opacity": 0.6, "bsdf": merl[2]},
             {"type": "null"}]
    for i, b in enumerate(bsdfs):
        d[f"s{i}"] = {"type": "sphere", "center": [-2.4 + 1.6 * i, 0, 0],
                      "radius": 0.7, "bsdf": b}
    return d


def test_blend_gradient_matches_jax():
    """jax.grad of the JAX render (ad_mode) of a scene with blendbsdf, mask
    and null over MERL children against the port's grad_render on the same
    scene arrays and seed, the stack of 3 tables: loss within rtol 1e-5,
    table gradient within 2e-3 relative L2 error, the same nonzero cells
    (as test_torch_ad.test_frame_gradients_match_jax); one gradient
    buffer."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted

    rng = np.random.default_rng(9)
    d = _blend_spheres([smooth_table(rng) for _ in range(3)], 16, 2, 3)
    js = mct.load_dict(d)
    full = jparams.traverse(js)

    def loss(p):
        img = jax_render(jparams.update(js, p), spp=2, seed=0, ad_mode=True)
        return jnp.mean(img ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss))({TABLE: full[TABLE]})
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    p = tparams.params_from_numpy({TABLE: np.asarray(full[TABLE])}, "cpu")
    buffers = merl_sorted.GRAD_BUFFERS
    tl, tg = ad.grad_render(ts, p, torch.zeros((16, 16, 3)), spp=2, seed=0)
    assert merl_sorted.GRAD_BUFFERS - buffers == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got, want = tg[TABLE].numpy(), np.asarray(jg[TABLE])
    assert np.isfinite(got).all() and (want != 0).any()
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)
    np.testing.assert_array_equal(got != 0, want != 0)


# sha256 (first 16 hex digits) of the float32 bytes of each image or
# gradient as the port rendered it before transmissive kernels existed (on
# the CPU, one torch thread); the NEE cull of reflective-only scenes keeps
# them bit-equal
PARENT = {
    "flagship": "a7b41add3ddf817c",
    "matpreview": "9a491cba946e6582",
    "ad_image": "359f9ebca1410aa3",
    "ad_table": "8d7815f685dd7bfa",
    "ad_alpha": "05656c5558ee5f78",
}


def _hash(t):
    return hashlib.sha256(np.ascontiguousarray(t.detach().numpy()).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("what", ["flagship", "matpreview", "ad"])
def test_reflective_frames_unchanged(what):
    """Flagship (16x16, 4 spp, depth 3), a matpreview (16x16, 2 spp, depth
    3, n_sub 3, 3 materials, schedule (1, 0.6, 0.3)) and the flagship's AD
    image and gradients (table, GGX alpha_u) at seed 0, bit-equal to the
    port's renders before transmissive kernels existed."""
    if what == "matpreview":
        d = matpreview_dict(16, 2, 3, n_sub=3, n_materials=3, compact=(1.0, 0.6, 0.3))
        got = {what: _hash(mt.render(mt.load_dict(d, "cpu"), 2, 0))}
    else:
        scene = mt.load_dict(flagship_dict(16, 4, 3), "cpu")
        if what == "flagship":
            got = {what: _hash(mt.render(scene, 4, 0))}
        else:
            keys = (TABLE, "bsdf.roughconductor.alpha_u")
            p = {k: v for k, v in traverse(scene).items() if k in keys}
            _, g = ad.grad_render(scene, p, torch.zeros((16, 16, 3)), spp=4, seed=0)
            got = {"ad_image": _hash(ad.render_ad(scene, p, spp=4, seed=0)),
                   "ad_table": _hash(g[keys[0]]), "ad_alpha": _hash(g[keys[1]])}
    assert got == {k: PARENT[k] for k in got}
