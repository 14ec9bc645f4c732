"""The port's Mitsuba-XML loader (render/xml.py) against the JAX package's.

The five tests of tests/test_xml.py on the port; the port's parse_file
against the JAX one on those files and on a scene that <include>s a file
with a PLY mesh and a MERL table (the same keys, values and arrays within
1e-6); a small XML frame through both packages' load_file -> render, by
image mean and the per-pixel Z-test of tests/reference_renderer; the
matpreview XML (scenes.matpreview_xml) against the matpreview dict; and the
to_world reference fault: the JAX loader drops a to_world dict's unknown
keys, the port refuses them, and an XML <matrix> loads as the same 4x4 in
both.
"""

import jax
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import scene as jscene
from mitsuba_customization_tpu.render import xml as jxml
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.models.merl import write_merl
from mitsuba_customization_tpu_torch.render import scene as tscene
from mitsuba_customization_tpu_torch.render import xml as txml
from mitsuba_customization_tpu_torch.scenes import matpreview_dict, matpreview_xml
from mitsuba_customization_tpu_torch.utils.meshgen import icosphere_blob, vertex_normals
from mitsuba_customization_tpu_torch.utils.ply import write_ply
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401
from test_xml import XML

# <include> renames the included file's top-level ids (inc_<id>_<n>) in
# both packages, so a <ref> inside it to its own id would dangle: the
# included shape carries its bsdf inline
INCLUDED = """<scene version="3.0.0">
  <shape type="ply">
    <string name="filename" value="blob.ply"/>
    <transform name="to_world"><scale value="0.6"/><translate x="0.4" y="0.1"/></transform>
    <bsdf type="merl"><string name="filename" value="$table"/></bsdf>
  </shape>
</scene>"""

MAIN = """<scene version="3.0.0">
  <default name="spp" value="16"/>
  <default name="res" value="16"/>
  <default name="table" value="t.binary"/>
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world"><lookat origin="0, 1, -4" target="0, 0, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="$res"/><integer name="height" value="$res"/>
      <rfilter type="box"/></film>
    <sampler type="independent"><integer name="sample_count" value="$spp"/></sampler>
  </sensor>
  <include filename="sub/included.xml"/>
  <shape type="sphere">
    <point name="center" x="-0.9" y="0" z="0.3"/><float name="radius" value="0.5"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7, 0.4, 0.3"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><matrix value="5 0 0 0  0 0 5 -0.7  0 -5 0 0  0 0 0 1"/></transform>
    <bsdf type="roughconductor"><float name="alpha" value="0.3"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="90"/><translate x="0.5" y="3" z="-1"/></transform>
    <emitter type="area"><rgb name="radiance" value="6"/></emitter>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.15"/></emitter>
</scene>"""


@pytest.fixture
def scene_file(tmp_path):
    p = tmp_path / "s.xml"
    p.write_text(XML)
    return p


@pytest.fixture
def include_file(tmp_path):
    """MAIN, which includes sub/included.xml: a PLY blob (binary, with
    normals) painted with a MERL table file beside it."""
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "included.xml").write_text(INCLUDED)
    v, f = icosphere_blob(n_sub=1)
    write_ply(sub / "blob.ply", v, f, normals=vertex_normals(v, f))
    table = np.zeros((90, 90, 180, 3), np.float32) + smooth_table(
        np.random.default_rng(5), (90, 1, 1, 3))
    write_merl(sub / "t.binary", table)
    p = tmp_path / "main.xml"
    p.write_text(MAIN)
    return p


def _perspectives(d):
    return [v for v in d.values() if isinstance(v, dict) and v.get("type") == "perspective"]


def test_parse_structure(scene_file):
    d = txml.parse_file(scene_file)
    assert d["type"] == "scene"
    assert d["integrator"]["max_depth"] == 5
    (s,) = _perspectives(d)
    assert s["film"]["width"] == 20 and s["film"]["height"] == 10
    assert s["sampler"]["sample_count"] == 8  # $spp substituted
    assert d["mat_white"]["reflectance"] == [0.7, 0.6, 0.5]
    consts = [v for v in d.values() if isinstance(v, dict) and v.get("type") == "constant"]
    assert consts[0]["radiance"] == [0.5, 0.5, 0.5]  # a single value broadcasts


def test_define_override(scene_file):
    (s,) = _perspectives(txml.parse_file(scene_file, spp=32))
    assert s["sampler"]["sample_count"] == 32


def test_undefined_var(tmp_path):
    p = tmp_path / "bad.xml"
    p.write_text('<scene version="3"><integrator type="path">'
                 '<integer name="max_depth" value="$nope"/></integrator></scene>')
    with pytest.raises(ValueError, match="undefined scene variable"):
        txml.parse_file(p)


def test_load_and_render(scene_file):
    scene = txml.load_file(scene_file, device="cpu")
    assert scene.device.type == "cpu"
    assert scene.config.max_depth == 5
    assert scene.config.width == 20 and scene.config.height == 10
    img = mt.render(scene, 4).numpy()
    assert img.shape == (10, 20, 3) and np.isfinite(img).all() and img.max() > 0


def test_transform_composition(tmp_path):
    p = tmp_path / "t.xml"
    p.write_text('<scene version="3"><shape type="sphere">'
                 '<transform name="to_world"><scale value="2"/>'
                 '<translate x="1" y="2" z="3"/></transform></shape></scene>')
    shape = next(v for v in txml.parse_file(p).values()
                 if isinstance(v, dict) and v.get("type") == "sphere")
    m = np.asarray(shape["to_world"])
    assert np.allclose(m[:3, 3], [1, 2, 3])
    assert np.allclose(np.diag(m)[:3], 2)


def _same(a, b, path="d"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6,
                                   err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("which", ["test_xml", "override", "include"])
def test_parse_file_matches_jax(which, scene_file, include_file, tmp_path):
    """The same dict from both parsers: keys (the generated names too),
    values, types and transforms within 1e-6; filenames resolved against
    the including file's directory alike."""
    path, defines = {"test_xml": (scene_file, {}), "override": (scene_file, {"spp": 32}),
                     "include": (include_file, {"res": 8})}[which]
    _same(txml.parse_file(path, **defines), jxml.parse_file(path, **defines))


def test_xml_frame_matches_jax(include_file):
    """The including scene (a PLY blob with a MERL table from files, a
    sphere, a floor placed by a <matrix>, an area light and a sky) through
    both load_file -> render: image means within 2 % and the per-pixel
    Z-test (the port's moment integrator gives the variance)."""
    ts = txml.load_file(include_file, device="cpu")
    js = jxml.load_file(include_file)
    spp = ts.config.spp
    got = mt.render(ts, spp, 0).numpy()
    want = np.asarray(jax.jit(lambda s: jax_render(s, spp, 0))(js))
    mom = mt.render(ts, spp, 1, "moment").numpy()
    var = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0) + 1e-4
    assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    ok, z = ztest_images(got, var, want, var, spp, spp)
    assert ok, z


def test_matpreview_xml_renders_the_matpreview_dict(tmp_path):
    """scenes.matpreview_xml (PLY bands, MERL files, <default>s) compiles
    to the matpreview dict's geometry and renders its frame bit for bit
    (the MERL file round trip is exact for these tables)."""
    path = matpreview_xml(tmp_path, n_sub=1, n_materials=4)
    got = txml.load_file(path, device="cpu", res=16, spp=4, depth=3)
    want = mt.load_dict(matpreview_dict(16, 4, 3, n_sub=1, n_materials=4), "cpu")
    for f in ("p0", "e1", "e2", "vn0", "vn1", "vn2", "emitter_id"):
        assert torch.equal(getattr(got.geometry, f), getattr(want.geometry, f)), f
    assert got.config == want.config
    assert torch.equal(mt.render(got, 4, 1), mt.render(want, 4, 1))


def test_to_world_unknown_keys_and_xml_matrix(tmp_path):
    """Reference fault: the JAX _as_transform reads only look_at, scale,
    rotate and translate from a to_world dict and silently drops any other
    key ({"matrix": M} gives the identity); the port refuses the dict. An
    XML <matrix> arrives as a 4x4 array, which both load as that matrix."""
    m = np.asarray([[0, 0, 2, 1], [0, 2, 0, 2], [-2, 0, 0, 3], [0, 0, 0, 1]], np.float32)
    np.testing.assert_array_equal(jscene._as_transform({"matrix": m}), np.eye(4))
    with pytest.raises(NotImplementedError, match="matrix"):
        tscene._as_transform({"matrix": m})
    p = tmp_path / "m.xml"
    p.write_text('<scene version="3"><shape type="rectangle"><transform name="to_world">'
                 '<matrix value="' + " ".join(str(float(x)) for x in m.ravel())
                 + '"/></transform></shape></scene>')
    for parse, as_transform in ((txml.parse_file, tscene._as_transform),
                                (jxml.parse_file, jscene._as_transform)):
        (shape,) = [v for v in parse(p).values() if isinstance(v, dict)
                    and v.get("type") == "rectangle"]
        np.testing.assert_array_equal(as_transform(shape["to_world"]), m)
