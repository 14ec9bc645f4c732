"""The port's textures, textured diffuse, normal and bump maps and image
readers against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
the port's (one torch thread): texture eval over a stack of bitmaps of
several sizes (wrap, uv_scale, pixel centres), checkerboard cells, mesh
attributes and volume grids (with the fill outside the unit cube); the
textured diffuse kernel; bump_to_normal and apply_normal_maps; the EXR and
PFM files of each package read by the other; the BSDF dispatch with uv
through the fused bounce and the blend fallback; and whole frames of the
JAX tests' textured scenes, compared by image mean and the per-pixel
Z-test of tests/reference_renderer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.models import bsdf as jbsdf
from mitsuba_customization_tpu.models import normalmap as jnm
from mitsuba_customization_tpu.models import texture as jtex
from mitsuba_customization_tpu.models import textured_diffuse as jtd
from mitsuba_customization_tpu.render import params as jparams
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu.utils import exr as jexr
from mitsuba_customization_tpu.utils import io as jio
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.models import normalmap as tnm
from mitsuba_customization_tpu_torch.models import texture as ttex
from mitsuba_customization_tpu_torch.models import textured_diffuse as ttd
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.utils import exr as texr
from mitsuba_customization_tpu_torch.utils import io as tio
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_render import _arrays


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _rows(rng):
    """Texture rows of every type: three bitmaps of different sizes (one
    2-D, so grey), a checkerboard, a mesh attribute and two volumes (one
    scalar, one RGB, placed by to_world)."""
    return [
        dict(type=jtex.BITMAP, image=rng.random((5, 7, 3)), uv_scale=(1.0, 1.0)),
        dict(type=jtex.BITMAP, image=rng.random((16, 16, 3)), uv_scale=(2.5, -1.5)),
        dict(type=jtex.BITMAP, image=rng.random((3, 9)), uv_scale=(1.0, 3.0)),
        dict(type=jtex.CHECKERBOARD, value0=(0.9, 0.1, 0.2), value1=(0.1, 0.7, 0.3),
             uv_scale=(3.0, 2.0)),
        dict(type=jtex.MESH_ATTRIBUTE, value0=(0.5, 1.0, 2.0)),
        dict(type=jtex.VOLUME, value0=(1.5, 1.5, 1.5), value1=(0.2, 0.3, 0.4),
             volume=rng.random((4, 5, 6))),
        dict(type=jtex.VOLUME, value0=(1.0, 1.0, 1.0), value1=(0.0, 0.0, 0.0),
             volume=rng.random((6, 3, 4, 3)),
             vol_to_world=np.float64([[2, 0, 0, -0.3], [0, 1, 0, 0.1], [0, 0, 0.5, -0.2],
                                      [0, 0, 0, 1]])),
    ]


def _texcoords(rng, n, n_prims):
    """TC_VOL coordinates: uv over [-1.5, 2.5) (wrap), the texel centres of
    the 5x7 bitmap, barycentrics, prim ids and world points over [-0.5,
    1.5)^3 (so some lanes lie outside each volume's cube)."""
    uv = rng.uniform(-1.5, 2.5, (n, 2))
    centres = np.stack(np.meshgrid((np.arange(7) + 0.5) / 7, (np.arange(5) + 0.5) / 5),
                       -1).reshape(-1, 2)
    uv[: len(centres)] = centres
    b = rng.random((n, 2))
    b = np.where(b.sum(-1, keepdims=True) > 1, 1 - b, b)
    prim = rng.integers(0, n_prims, (n, 1))
    p = rng.uniform(-0.5, 1.5, (n, 3))
    return np.concatenate([uv, b, prim, p], -1).astype(np.float32)


def test_texture_eval_matches_jax():
    """eval over every row type of one stack (bitmaps padded into one (T,
    H, W, 3) tensor): atol 1e-6; the bitmap's pixel centres return its
    texels; the plain-uv and TC_FULL widths skip what they cannot reach."""
    rng = np.random.default_rng(0)
    rows, n_prims = _rows(rng), 11
    attr = rng.random((n_prims, 9)).astype(np.float32)
    js = jtex.build_stack(rows, attr=attr)
    ts = ttex.build_stack(rows, attr, device="cpu")
    assert ts.images.shape == tuple(js.images.shape) == (3, 16, 16, 3)
    for f in ts._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)
    n = 4000
    tc = _texcoords(rng, n, n_prims)
    slot = rng.integers(0, len(rows), n)
    for width in (2, ttex.TC_FULL, ttex.TC_VOL):
        want = np.asarray(jtex.eval(js, jnp.asarray(slot, jnp.int32),
                                    jnp.asarray(tc[:, :width])))
        got = ttex.eval(ts, _t(slot), _t(tc[:, :width])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=str(width))
    # texel centres of the 5x7 bitmap (v = 0 is the bottom row)
    got = ttex.eval(ts, torch.zeros(35, dtype=torch.int64), _t(tc[:35, :2])).numpy()
    img = rows[0]["image"].astype(np.float32)
    np.testing.assert_allclose(got.reshape(5, 7, 3), img[::-1], atol=1e-6)
    # volume lanes outside [0, 1]^3 take the fill
    outside = (slot == 5) & ((tc[:, 5:8] < 0) | (tc[:, 5:8] > 1)).any(-1)
    assert outside.any()
    got = ttex.eval(ts, _t(slot), _t(tc)).numpy()
    np.testing.assert_array_equal(got[outside], np.float32([[0.2, 0.3, 0.4]]).repeat(
        outside.sum(), 0))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _lanes(rng, n):
    """wi (a tenth below the horizon), wo in the upper hemisphere, and a
    2-D sample."""
    wi = rng.normal(size=(n, 3))
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rng.random(n) < 0.1, -1, 1)
    wo = rng.normal(size=(n, 3))
    wo[:, 2] = np.abs(wo[:, 2])
    return _unit(wi), _unit(wo), rng.random((n, 2)).astype(np.float32)


def test_textured_diffuse_matches_jax():
    """eval / pdf / sample of the textured diffuse kernel with slot, uv and
    mask (masked lanes read uv 0): rtol 1e-5 (sampled directions atol
    1e-5)."""
    rng = np.random.default_rng(1)
    rows = _rows(rng)[:4]
    js, ts = jtex.build_stack(rows), ttex.build_stack(rows, device="cpu")
    n = 3000
    wi, wo, u2 = _lanes(rng, n)
    uv = rng.uniform(-1, 2, (n, 2)).astype(np.float32)
    slot = rng.integers(0, len(rows), n)
    mask = rng.random(n) > 0.3
    jkw = dict(slot=jnp.asarray(slot, jnp.int32), uv=jnp.asarray(uv), mask=jnp.asarray(mask))
    tkw = dict(slot=_t(slot), uv=_t(uv), mask=_t(mask))
    for fn in ("eval", "pdf"):
        want = getattr(jtd, fn)(js, jnp.asarray(wi), jnp.asarray(wo), **jkw)
        got = getattr(ttd, fn)(ts, _t(wi), _t(wo), **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    # the sampled direction within 1e-5 (torch's and XLA's sin / cos part
    # by ulps, ROADMAP §3), the pdf, weight and lobe flag at rtol 1e-5
    want = jtd.sample(js, jnp.asarray(wi), jnp.asarray(u2), None, **jkw)
    got = ttd.sample(ts, _t(wi), _t(u2), None, **tkw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_bump_to_normal_is_jax():
    rng = np.random.default_rng(2)
    for h in (rng.random((9, 13)), rng.random((6, 6, 3)), np.zeros((4, 4))):
        np.testing.assert_array_equal(tnm.bump_to_normal(h, 0.3), jnm.bump_to_normal(h, 0.3))


def _plate(bsdf, res=16, spp=16, integrator=None):
    return {
        "type": "scene",
        "integrator": integrator or {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 30,
                   "to_world": {"look_at": {"origin": [0.3, 0.4, -3], "target": [0, 0, 0],
                                            "up": [0, 1, 0]}},
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "light": {"type": "constant", "radiance": [1, 1, 1]},
        "lamp": {"type": "sphere", "center": [1.5, 1.5, -2], "radius": 0.3,
                 "emitter": {"type": "area", "radiance": [20, 20, 20]}},
        "plate": {"type": "rectangle", "to_world": {"scale": 2.0}, "bsdf": bsdf},
    }


def _tilt_map(rng, h=6, w=5):
    n = rng.normal(size=(h, w, 3)) * 0.4
    n[..., 2] = 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def test_apply_normal_maps_matches_jax():
    """The perturbed frame and the re-localized wi of camera hits on a
    normal-mapped plate (a bump-mapped sphere beside it): within 1e-5."""
    rng = np.random.default_rng(3)
    d = _plate({"type": "normalmap", "normalmap": {"bitmap": _tilt_map(rng)},
                "uv_scale": [2.0, 1.0],
                "bsdf": {"type": "roughplastic", "alpha": 0.3}})
    d["bumped"] = {"type": "sphere", "center": [-0.6, 0, -0.5], "radius": 0.4,
                   "bsdf": {"type": "bumpmap", "texture": {"bitmap": rng.random((8, 8))},
                            "scale": 0.05, "bsdf": {"type": "diffuse"}}}
    js = mct.load_dict(d)
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    n = 3000
    o = np.tile(np.float32([0.3, 0.4, -3.0]), (n, 1))
    tgt = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), np.zeros((n, 1))], -1)
    dirs = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    from mitsuba_customization_tpu.render.records import Ray as JRay

    jsi = jnm.apply_normal_maps(js.bsdfs, js.ray_intersect(
        JRay.make(jnp.asarray(o), jnp.asarray(dirs, jnp.float32))))
    tsi = tnm.apply_normal_maps(ts.bsdfs, ts.ray_intersect(
        Ray.make(_t(o), _t(dirs, torch.float32))))
    assert bool(tsi.valid.all())
    for name in ("s", "t", "n"):
        np.testing.assert_allclose(getattr(tsi.frame, name).numpy(),
                                   np.asarray(getattr(jsi.frame, name)), atol=1e-5)
    np.testing.assert_allclose(tsi.wi.numpy(), np.asarray(jsi.wi), atol=1e-5)
    plain = ts.ray_intersect(Ray.make(_t(o), _t(dirs, torch.float32)))
    assert float((tsi.frame.n - plain.frame.n).abs().max()) > 0.1


def test_exr_and_pfm_cross_read(tmp_path):
    """Each package's EXR (ZIP, ZIPS, NONE) and PFM files: the same bytes,
    and each reads the other's back equal; read_image of a PNG equal."""
    rng = np.random.default_rng(4)
    img = (rng.random((37, 21, 3)) * 4).astype(np.float32)
    for comp in (texr.ZIP_COMPRESSION, texr.ZIPS_COMPRESSION, texr.NO_COMPRESSION):
        a, b = tmp_path / f"t{comp}.exr", tmp_path / f"j{comp}.exr"
        texr.write_exr(a, img, compression=comp)
        jexr.write_exr(b, img, compression=comp)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(texr.read_exr(b), img)
        np.testing.assert_array_equal(jexr.read_exr(a), img)
    for arr in (img, img[..., 0]):
        a, b = tmp_path / "t.pfm", tmp_path / "j.pfm"
        texr.write_pfm(a, arr)
        jexr.write_pfm(b, arr)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(texr.read_pfm(b), arr)
    for ext in ("exr", "pfm", "npy", "png"):
        p = tmp_path / f"x.{ext}"
        tio.write_image(p, img)
        got, want = tio.read_image(p), jio.read_image(p)
        assert got.dtype == np.float32 and got.shape == (37, 21, 3)
        np.testing.assert_array_equal(got, want)
    png = tmp_path / "j.png"
    jio.write_png(png, img)
    np.testing.assert_array_equal(tio.read_image(png), jio.read_image(png))


def _frame(d, spp):
    """(port image, its per-pixel variance, JAX image) of dict d."""
    want = np.asarray(jax.jit(lambda s: jax_render(s, spp, 0))(mct.load_dict(d)))
    scene = mt.load_dict(d, "cpu")
    got = mt.render(scene, spp, 0).numpy()
    mom = mt.render(scene, spp, 1, "moment").numpy()
    return got, np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0), want


def _textured_scenes(rng):
    v = np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
    f = np.int32([[0, 1, 2], [0, 2, 3]])
    return {
        "checker": _plate({"type": "diffuse", "reflectance": {
            "type": "checkerboard", "color0": [0.8, 0.1, 0.1], "color1": [0.1, 0.8, 0.1],
            "uv_scale": [2, 3]}}),
        "bitmap": _plate({"type": "diffuse", "reflectance": {
            "type": "bitmap", "bitmap": rng.random((6, 10, 3)), "uv_scale": [1.5, 1.0]}}),
        "normalmap": _plate({"type": "normalmap", "normalmap": _tilt_map(rng),
                             "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.5, 0.4]}}),
        "bumpmap": _plate({"type": "bumpmap", "bumpmap": {"bitmap": rng.random((12, 12))},
                           "scale": 0.1, "bsdf": {"type": "roughplastic", "alpha": 0.2}}),
        "mesh_attribute": dict(_plate({"type": "null"}), quad={
            "type": "mesh", "vertices": v * 0.8 + [0, 0, -0.1], "faces": f,
            "vertex_colors": rng.random((4, 3)),
            "bsdf": {"type": "diffuse", "reflectance": {"type": "mesh_attribute",
                                                        "name": "vertex_color"}}}),
        "volume": _plate({"type": "blendbsdf", "weight": 0.4,
                          "a": {"type": "diffuse", "reflectance": {
                              "type": "volume", "grid": rng.random((3, 4, 5, 3)),
                              "to_world": {"scale": 1.2, "translate": [-0.6, -0.6, -0.5]}}},
                          "b": {"type": "roughconductor", "alpha": 0.3}}),
    }


@pytest.mark.parametrize("name", ["checker", "bitmap", "normalmap", "bumpmap",
                                  "mesh_attribute", "volume"])
def test_textured_frame_matches_jax(name):
    """The JAX tests' textured rectangle (checkerboard, bitmap), the normal-
    and bump-mapped plate, a mesh_attribute quad and a volume-textured
    diffuse inside a blendbsdf (uv through the blend fallback), 16x16 at
    16 spp, depth 3, an area light and a sky: per-channel means within 1 %
    and the Z-test (4 sigma on >= 99.5 % of pixels)."""
    d = _textured_scenes(np.random.default_rng(5))[name]
    got, var, want = _frame(d, 16)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    ok, z = ztest_images(got, var, want, var, 16, 16)
    assert ok, z


def test_uv_reaches_every_dispatch_route():
    """bounce_shade and the public eval / pdf / sample with a textured
    diffuse alone, inside twosided, and inside a blendbsdf (the blend
    fallback): the JAX package's values on every live lane (rtol 1e-5),
    and different values for different uv (the texture is read)."""
    rng = np.random.default_rng(6)
    tex = {"type": "bitmap", "bitmap": rng.random((4, 4, 3))}
    for bsdfs in (
        [{"type": "diffuse", "reflectance": tex}, {"type": "roughplastic"}],
        [{"type": "twosided", "bsdf": {"type": "diffuse", "reflectance": tex}}],
        [{"type": "blendbsdf", "weight": 0.3, "a": {"type": "diffuse", "reflectance": tex},
          "b": {"type": "roughconductor", "alpha": 0.2}}],
    ):
        d = {"type": "scene", "light": {"type": "constant"}}
        for i, b in enumerate(bsdfs):
            d[f"s{i}"] = {"type": "sphere", "center": [3.0 * i, 0, 5], "bsdf": b}
        js = mct.load_dict(d)
        ts = scene_from_numpy(_arrays(js), js.config, "cpu")
        n = 2000
        wi, wo, u2 = _lanes(rng, n)
        u1 = rng.random(n).astype(np.float32)
        uv = rng.random((n, 2)).astype(np.float32)
        mat = rng.integers(0, int(js.bsdfs.mat_type.shape[0]), n)
        active = rng.random(n) > 0.2
        nee = active & (rng.random(n) > 0.3)
        ja = [jnp.asarray(x) for x in (mat.astype(np.int32), wi, wo, u2, u1, uv)]
        ta = [_t(x) for x in (mat, wi, wo, u2, u1, uv)]
        want = jbsdf.bounce_shade(js.bsdfs, *ja, active=jnp.asarray(active),
                                  nee_mask=jnp.asarray(nee))[:6]
        got = tbsdf.bounce_shade(ts.bsdfs, *ta, active=_t(active), nee_mask=_t(nee))
        for i, (g, w) in enumerate(zip(got, want)):
            live = nee if i < 2 else active
            np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=1e-5,
                                       atol=1e-6)
        want = jbsdf.eval(js.bsdfs, ja[0], ja[1], ja[2], ja[5])
        got = tbsdf.eval(ts.bsdfs, ta[0], ta[1], ta[2], ta[5])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        other = tbsdf.eval(ts.bsdfs, ta[0], ta[1], ta[2], 1.0 - ta[5])
        assert float((other - got).abs().max()) > 1e-3


def test_texture_files_load_as_in_jax(tmp_path):
    """Textures, normal maps, bump maps and an envmap given by filename
    (EXR, PFM and NPY files written from a seed) compile to the JAX
    loader's tables and give its traverse keys; a texture in another BSDF
    field than diffuse's
    reflectance raises (the JAX loader takes the field's default there,
    ROADMAP §3)."""
    from test_torch_loader import _assert_bsdfs_equal, _assert_emitters_equal, _spheres

    rng = np.random.default_rng(7)
    files = {}
    for name, arr in (("albedo.exr", rng.random((9, 14, 3))), ("normal.npy", _tilt_map(rng)),
                      ("height.pfm", rng.random((12, 10))), ("sky.exr", rng.random((6, 12, 3)))):
        files[name] = str(tmp_path / name)
        if arr.ndim == 3:
            tio.write_image(files[name], arr)
        else:  # a one-channel height map
            texr.write_pfm(files[name], arr)
    v = np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
    bsdfs = [
        {"type": "diffuse", "reflectance": {"type": "bitmap", "filename": files["albedo.exr"],
                                            "uv_scale": [2, 1]}},
        {"type": "normalmap", "normalmap": {"filename": files["normal.npy"]},
         "bsdf": {"type": "roughconductor"}},
        {"type": "bumpmap", "bumpmap": {"filename": files["height.pfm"]}, "scale": 0.3,
         "bsdf": {"type": "diffuse", "reflectance": {"type": "checkerboard"}}},
        {"type": "diffuse", "reflectance": {"type": "volume", "grid": rng.random((2, 3, 4)),
                                            "fill": [0.1, 0.2, 0.3]}},
    ]
    d = _spheres(bsdfs, env={"type": "envmap", "filename": files["sky.exr"]})
    d["quad"] = {"type": "mesh", "vertices": v, "faces": np.int32([[0, 1, 2], [0, 2, 3]]),
                 "vertex_colors": rng.random((4, 3)),
                 "bsdf": {"type": "diffuse", "reflectance": {"type": "mesh_attribute"}}}
    js = mct.load_dict(d)
    own, ref = mt.load_dict(d, "cpu"), scene_from_numpy(_arrays(js), js.config, "cpu")
    _assert_bsdfs_equal(own.bsdfs, ref.bsdfs)
    _assert_emitters_equal(own.emitters, ref.emitters)
    # the JAX traverse's keys (bsdf.textured_diffuse.* float fields,
    # emitter.env_image), shapes and values
    want = {k: np.asarray(v) for k, v in jparams.traverse(js).items()}
    got = tparams.traverse(own)
    assert sorted(got) == sorted(want) and "bsdf.textured_diffuse.images" in got
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    with pytest.raises(NotImplementedError, match="only a diffuse reflectance"):
        mt.load_dict(_spheres([{"type": "roughplastic", "diffuse_reflectance": {
            "type": "bitmap", "bitmap": np.ones((2, 2, 3))}}]), "cpu")
    assert np.asarray(mct.load_dict(_spheres([{"type": "roughplastic", "diffuse_reflectance": {
        "type": "bitmap", "bitmap": np.ones((2, 2, 3))}}])).bsdfs.stacks[
        jbsdf.ROUGHPLASTIC].diffuse_reflectance).tolist() == [[0.5, 0.5, 0.5]]
