"""The port's load_dict against the JAX package's: the wrappers (twosided,
blendbsdf, mask), every analytic BSDF type, look_at, each spectrum form,
the integrator names and keys, the MERL and measured_custom readers and
writers, textures, normal and bump maps, the emitter types, the sensor,
sampler, film-filter and shape types, and the integrators and media of
ROADMAP item 14b (refused by the earlier port, naming that item).
"""

import jax
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.models import measured_custom as jcustom
from mitsuba_customization_tpu.models import merl as jmerl
from mitsuba_customization_tpu.render import scene as jscene_mod
from mitsuba_customization_tpu_torch.models import measured_custom as tcustom
from mitsuba_customization_tpu_torch.models import merl as tmerl
from mitsuba_customization_tpu_torch.render import scene as tscene_mod
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.scenes import synthetic_merl_table
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401


def _arrays(scene):
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def _from_jax(d):
    js = jscene_mod.load_dict(d)
    return scene_from_numpy(_arrays(js), js.config, "cpu")


def _assert_bsdfs_equal(own, ref):
    for name in ("mat_type", "mat_slot", "blend_a", "blend_b", "blend_w", "nm_slot"):
        a, b = getattr(own, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert own.present_kernels == ref.present_kernels
    stacks = [(own.stacks[kid], ref.stacks[kid]) for kid in own.present_kernels]
    if own.normal_tex is not None:
        stacks.append((own.normal_tex, ref.normal_tex))
    for st_own, st_ref in stacks:
        for f, a, b in zip(st_own._fields, st_own, st_ref):
            assert (a is None) == (b is None), f
            if f == "sampling":
                for x, y in zip(a, b):
                    torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
            elif torch.is_tensor(a):
                torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0, msg=f)


def _spheres(bsdfs, **extra):
    d = {"type": "scene", "light": {"type": "constant"}, **extra}
    for i, b in enumerate(bsdfs):
        d[f"s{i}"] = {"type": "sphere", "center": [3.0 * i, 0, 5], "bsdf": b}
    return d


ANALYTIC = [
    {"type": "conductor", "eta": [0.2, 0.9, 1.1], "k": 3.0},
    {"type": "roughconductor", "distribution": "beckmann", "alpha_u": 0.1,
     "alpha_v": 0.3},
    {"type": "roughconductor", "alpha": 0.2},
    {"type": "plastic", "int_ior": 1.6, "diffuse_reflectance": [0.2, 0.4, 0.6]},
    {"type": "roughplastic", "alpha": 0.3},
    {"type": "principled", "metallic": 0.5, "clearcoat": 0.5, "base_color": [0.8, 0.2, 0.1]},
    {"type": "dielectric", "int_ior": 1.33},
    {"type": "thindielectric"},
    {"type": "roughdielectric", "alpha": 0.2, "specular_transmittance": [0.9, 0.8, 0.7]},
    {"type": "passthrough", "transmittance": 0.5},
    {"type": "null"},
    {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.1, 0.2, 0.3]}},
]


def test_every_bsdf_type_loads_as_in_jax():
    """Each ported BSDF type (and the wrappers, a named reference, merl and
    measured_custom from tables) compiles to the JAX package's table."""
    rng = np.random.default_rng(0)
    t0, t1 = smooth_table(rng), smooth_table(rng)
    bsdfs = ANALYTIC + [
        {"type": "twosided", "bsdf": {"type": "merl", "table": t0}},
        {"type": "blendbsdf", "weight": 0.3, "x": {"type": "measured_custom", "table": t1},
         "y": {"type": "roughplastic"}},
        {"type": "mask", "opacity": {"type": "uniform", "value": 0.6},
         "bsdf": {"type": "diffuse"}},
        "named",
    ]
    d = _spheres(bsdfs, named={"type": "plastic"})
    own = mt.load_dict(d, "cpu")
    ref = _from_jax(d)
    _assert_bsdfs_equal(own.bsdfs, ref.bsdfs)
    for a, b in zip(own.shadow_geometry, ref.shadow_geometry):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_twosided_is_its_child():
    inner = {"type": "roughconductor", "alpha": 0.3}
    a = mt.load_dict(_spheres([{"type": "twosided", "bsdf": inner}]), "cpu")
    b = mt.load_dict(_spheres([inner]), "cpu")
    _assert_bsdfs_equal(a.bsdfs, b.bsdfs)


def test_look_at_transform_matches_jax():
    t = {"look_at": {"origin": [1, 2, 3], "target": [0, 0.5, 0], "up": [0, 0, 1]},
         "scale": 2.0, "translate": [0.5, 0, 0]}
    np.testing.assert_array_equal(tscene_mod._as_transform(t), jscene_mod._as_transform(t))
    d = _spheres([{"type": "diffuse"}], sensor={
        "type": "perspective", "to_world": {"look_at": {"origin": [0, 1, -4],
                                                        "target": [0, 0, 0]}}})
    own, ref = mt.load_dict(d, "cpu"), _from_jax(d)
    torch.testing.assert_close(own.sensor.to_world, ref.sensor.to_world, rtol=0, atol=0)


@pytest.mark.parametrize("spec", [
    0.5,
    [0.1, 0.2, 0.3],
    {"type": "rgb", "value": [0.4, 0.5, 0.6]},
    {"type": "uniform", "value": 2.0},
    {"type": "blackbody", "temperature": 3200, "scale": 2.0},
    {"type": "blackbody"},
    {"type": "d65", "scale": 0.5},
    {"type": "regular", "lambda_min": 400, "lambda_max": 700,
     "values": [0.1, 0.5, 0.9, 0.4]},
    {"type": "irregular", "wavelengths": [380, 450, 600, 760],
     "values": [1.0, 0.2, 0.7, 0.3], "scale": 3.0},
], ids=lambda s: s["type"] if isinstance(s, dict) else str(s))
def test_spectrum_matches_jax(spec):
    got = tscene_mod.resolve_spectrum(spec)
    want = jscene_mod.resolve_spectrum(spec)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_emitter_spectra_load_as_in_jax():
    d = _spheres([{"type": "diffuse"}])
    d["light"] = {"type": "constant", "radiance": {"type": "blackbody", "temperature": 5000}}
    d["lamp"] = {"type": "rectangle", "emitter": {"type": "area", "radiance": {
        "type": "d65", "scale": 3.0}}}
    own, ref = mt.load_dict(d, "cpu"), _from_jax(d)
    torch.testing.assert_close(own.emitters.radiance, ref.emitters.radiance, rtol=0, atol=0)


def test_bsdf_spectra_are_resolved():
    """A spectrum plugin in a BSDF field resolves to its color. The JAX
    package's BSDF fields read only a dict's "value" (a blackbody
    reflectance becomes the field's default there): a recorded gap, the
    port resolving it as its emitters do."""
    spec = {"type": "blackbody", "temperature": 4000}
    d = _spheres([{"type": "diffuse", "reflectance": spec}])
    own, ref = mt.load_dict(d, "cpu"), _from_jax(d)
    np.testing.assert_array_equal(own.bsdfs.stacks[0].reflectance[0].numpy(),
                                  tscene_mod.resolve_spectrum(spec))
    np.testing.assert_array_equal(ref.bsdfs.stacks[0].reflectance[0].numpy(), [0.5] * 3)


@pytest.mark.parametrize("key, integ, kind", [
    ("integrator", {"type": "prb", "max_depth": 5}, "prb"),
    ("integrator", {"type": "prb_basic"}, "prb_basic"),
    ("my_integrator", {"type": "direct", "max_depth": 7}, "direct"),
    ("aovs", {"type": "aov_uv"}, "aov_uv"),
    ("integrator", {"type": "moment", "rr_depth": 3, "hide_emitters": True}, "moment"),
    ("integrator", {"type": "volpathmis", "max_depth": 6}, "volpathmis"),
    ("my_integrator", {"type": "prbvolpath", "rr_depth": 2}, "prbvolpath"),
    ("integrator", {"type": "bdpt", "max_depth": 5}, "bdpt"),
])
def test_integrator_under_any_key(key, integ, kind):
    d = _spheres([{"type": "diffuse"}])
    d[key] = integ
    own, ref = mt.load_dict(d, "cpu"), jscene_mod.load_dict(d)
    assert own.config.integrator == ref.config.integrator == kind
    for f in ("max_depth", "rr_depth", "hide_emitters"):
        assert getattr(own.config, f) == getattr(ref.config, f)


def test_prb_renders_as_path():
    d = _spheres([{"type": "roughconductor"}, {"type": "diffuse"}])
    d["sensor"] = {"type": "perspective", "film": {"width": 8, "height": 8},
                   "to_world": {"look_at": {"origin": [3, 0, -4], "target": [3, 0, 5]}}}
    scene = mt.load_dict(d, "cpu")
    path = mt.render(scene, 2, 0, "path")
    for name in ("prb", "prb_basic", {"type": "prb"}):
        torch.testing.assert_close(mt.render(scene, 2, 0, name), path, rtol=0, atol=0)


def test_merl_file_round_trip(tmp_path):
    """A table written by the port's write_merl reads back bit-equal through
    both packages' readers, and loads as the JAX package loads it."""
    table = synthetic_merl_table(0.1, [0.9, 0.5, 0.2])
    table[0, 0, :4] = -1.0  # unmeasured entries clamp to 0
    path = str(tmp_path / "t.binary")
    tmerl.write_merl(path, table)
    got = tmerl.read_merl(path)
    assert got.dtype == np.float32 and got.shape == (90, 90, 180, 3)
    np.testing.assert_array_equal(got, jmerl.read_merl(path))
    jpath = str(tmp_path / "j.binary")
    jmerl.write_merl(jpath, table)
    assert open(jpath, "rb").read() == open(path, "rb").read()
    d = _spheres([{"type": "merl", "filename": path}])
    own = mt.load_dict(d, "cpu").bsdfs.stacks[4]
    np.testing.assert_array_equal(own.table[0].numpy(), got)
    brdf = tmerl.load(path, "cpu")
    np.testing.assert_array_equal(brdf.table.numpy(), got)
    other = str(tmp_path / "c.cmbrdf")  # another resolution: not a MERL file
    tcustom.write_custom(other, table[:10])
    with pytest.raises(ValueError, match="dims"):
        tmerl.read_merl(other)


def test_measured_custom_file_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    table = smooth_table(rng, (12, 10, 20, 3))
    path = str(tmp_path / "t.cmbrdf")
    tcustom.write_custom(path, table, scale=(0.5, 1.0, 2.0))
    got = tcustom.read_custom(path)
    np.testing.assert_array_equal(got, jcustom.read_custom(path))
    jpath = str(tmp_path / "j.cmbrdf")
    jcustom.write_custom(jpath, table, scale=(0.5, 1.0, 2.0))
    assert open(jpath, "rb").read() == open(path, "rb").read()
    np.testing.assert_array_equal(tcustom.load(path, "cpu").table.numpy(), got)
    d = _spheres([{"type": "measured_custom", "filename": path}])
    own, ref = mt.load_dict(d, "cpu"), _from_jax(d)
    _assert_bsdfs_equal(own.bsdfs, ref.bsdfs)
    with open(path, "r+b") as f:
        f.write(b"XXXXXXXX")
    with pytest.raises(ValueError, match="magic"):
        tcustom.read_custom(path)


@pytest.mark.parametrize("entry, item", [
    ({"integrator": {"type": "volpath"}}, "14b"),
    ({"integrator": {"type": "bdpt"}}, "14b"),
    ({"pt": {"type": "ptracer"}}, "14b"),
    ({"s9": {"type": "sphere", "interior": {"type": "homogeneous"}}}, "14b"),
    ({"fog": {"type": "homogeneous"}}, "14b"),
    ({"smoke": {"type": "heterogeneous", "density": np.ones((2, 2, 2))}}, "14b"),
])
def test_unported_types_name_their_roadmap_item(entry, item):
    """Item 14b's types, which the earlier port refused naming that item,
    load as the JAX loader loads them (the integrator, the media table),
    or are refused with its ValueError (a ptracer scene under a constant
    emitter)."""
    assert item == "14b" and not hasattr(tscene_mod, "NOT_PORTED")
    d = _spheres([{"type": "diffuse"}], **entry)
    try:
        ref = jscene_mod.load_dict(d)
    except ValueError as err:
        with pytest.raises(ValueError) as own_err:
            mt.load_dict(d, "cpu")
        assert str(own_err.value) == str(err)
        return
    own = mt.load_dict(d, "cpu")
    assert own.config.integrator == ref.config.integrator
    assert own.media.n_media == ref.media.n_media
    for f, a in zip(own.media._fields, own.media):
        if torch.is_tensor(a):
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref.media, f)),
                                          err_msg=f)


@pytest.mark.parametrize("entry", [
    {"sensor": {"type": "orthographic"}},
    {"sensor": {"type": "perspective", "sampler": {"type": "multijitter"}}},
    {"sensor": {"type": "thinlens"}},
    {"sensor": {"type": "perspective", "sampler": {"type": "stratified"}}},
    {"sensor": {"type": "perspective", "film": {"rfilter": {"type": "gaussian"}}}},
    {"sensor": {"type": "perspective", "film": {"rfilter": "tent"}}},
    {"box": {"type": "cube"}},
    {"can": {"type": "cylinder"}},
    {"lid": {"type": "disk"}},
], ids=["orthographic", "multijitter", "thinlens", "stratified", "gaussian", "tent", "cube",
        "cylinder", "disk"])
def test_sensor_sampler_filter_and_shape_types_load_as_in_jax(entry):
    """The sensor, sampler, film-filter and shape types the earlier port
    raised on (ROADMAP items 13 and 15, the former cases of the test
    above) load to the JAX loader's sensor, configuration and geometry
    table."""
    d = _spheres([{"type": "diffuse"}], **entry)
    own, ref = mt.load_dict(d, "cpu"), _from_jax(d)
    for f, a, b in zip(own.sensor._fields, own.sensor, ref.sensor):
        assert (a is None) == (b is None), f
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    for f in ("sampler", "rfilter", "spp", "width", "height", "sensor_scale", "intersector",
              "use_bvh"):
        assert getattr(own.config, f) == getattr(ref.config, f), f
    for f, a, b in zip(own.geometry._fields, own.geometry, ref.geometry):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    assert own.has_cylinders == ref.has_cylinders


def _assert_emitters_equal(own, ref):
    """The port's emitter table against the JAX loader's (through
    scene_from_numpy): every array equal, the constant sky's NEE weight
    aside (0 beside other emitters here, 1e-20 there: ROADMAP §3)."""
    for f in ("em_type", "radiance", "position", "direction", "cutoff_cos", "beam_cos",
              "em_prims", "prim_area", "prim_to_q", "env_image", "env_to_world",
              "proj_image", "proj_to_world", "em_prim_emitter"):
        a, b = getattr(own, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    for f in ("background_index", "env_index", "proj_index", "proj_tan", "present",
              "has_area"):
        assert getattr(own, f) == getattr(ref, f), f
    torch.testing.assert_close(own.select.pmf, ref.select.pmf, rtol=0, atol=1e-19)
    torch.testing.assert_close(own.prim_dist.pmf, ref.prim_dist.pmf, rtol=0, atol=0)
    for a, b in zip(own.env_dist, ref.env_dist):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("entry", [
    {"env": {"type": "envmap", "bitmap": np.arange(24, dtype=np.float32).reshape(2, 4, 3),
             "scale": 2.0, "to_world": {"rotate": {"axis": [0, 1, 0], "angle": 30}}}},
    {"sun": {"type": "directional"}, "spot": {"type": "spot", "cutoff_angle": 30,
                                              "to_world": {"translate": [0, 3, 0]}}},
    {"s9": {"type": "sphere", "bsdf": {"type": "diffuse", "reflectance": {
        "type": "checkerboard"}}}},
    {"s9": {"type": "sphere", "bsdf": {"type": "normalmap", "bsdf": {"type": "diffuse"},
                                       "normalmap": np.ones((2, 2, 3))}}},
    {"s9": {"type": "sphere", "bsdf": {"type": "bumpmap", "bsdf": {"type": "plastic"},
                                       "texture": {"bitmap": np.eye(4)}, "scale": 0.5}}},
], ids=["envmap", "directional", "checkerboard", "normalmap", "bumpmap"])
def test_image_and_emitter_types_load_as_in_jax(entry):
    """The types the earlier port raised on (the envmap, directional,
    checkerboard, normalmap and bumpmap cases of the test above) load to
    the JAX loader's tables."""
    d = _spheres([{"type": "diffuse"}], **entry)
    own, ref = mt.load_dict(d, "cpu"), _from_jax(d)
    _assert_bsdfs_equal(own.bsdfs, ref.bsdfs)
    _assert_emitters_equal(own.emitters, ref.emitters)


def test_unknown_types_raise_value_error():
    for entry in ({"x": {"type": "sphere", "bsdf": {"type": "velvet"}}},
                  {"integrator": {"type": "warp_drive"}},
                  {"light": {"type": "constant", "radiance": {"type": "lab"}}}):
        with pytest.raises(ValueError):
            mt.load_dict(_spheres([{"type": "diffuse"}], **entry), "cpu")


def test_traverse_exposes_every_kernel_as_jax_does():
    """params.traverse names bsdf.<kernel>.<field> for every analytic
    kernel of the scene (the JAX package's
    tests/test_principled.py::test_traverse_exposes_principled_params),
    with the JAX traverse's values; update writes a field back."""
    from mitsuba_customization_tpu.render import params as jparams
    from mitsuba_customization_tpu_torch.render import params as tparams

    d = _spheres([b for b in ANALYTIC if b["type"] != "null"])
    own = mt.load_dict(d, "cpu")
    want = jparams.traverse(jscene_mod.load_dict(d))
    got = tparams.traverse(own)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert "bsdf.principled.clearcoat" in got and "bsdf.roughconductor_beckmann.alpha_u" in got
    new = tparams.update(own, {"bsdf.principled.metallic": torch.tensor([0.25])})
    assert float(new.bsdfs.stacks[14].metallic[0]) == 0.25
