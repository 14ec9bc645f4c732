"""The port's shapes against the JAX package's: the OBJ, PLY and
serialized readers, the loader's geometry tables for cube, disk,
cylinder, obj, ply, serialized, face_normals, an instanced shapegroup and
an sdfgrid, the SDF sphere tracer, a frame of these shapes against the
JAX render, and the JAX SDF test's expectation on the port.

Inputs are made from a seed with numpy (one torch thread). Tolerances:
the readers' arrays and the loaded geometry tables equal the JAX
package's; sdf.intersect's hit flags equal on >= 99.9 % of 4,096 lanes,
and where both hit, t within atol 1e-5 on >= 99.9 % of them (and within
one HIT_EPS step on all) and the normals within atol 1e-5 where t is;
the frame's per-channel
means within 1 % and the Z-test of tests/reference_renderer.ztest_images
(16x16, jitted); the SDF sphere renders like the analytic sphere (image
means within 0.02, mean absolute difference under 0.03, as
tests/test_sdf.py holds the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import scene as jscene_mod
from mitsuba_customization_tpu.render import sdf as jsdf
from mitsuba_customization_tpu.render.records import Ray as JRay
from mitsuba_customization_tpu.utils import obj as jobj
from mitsuba_customization_tpu.utils import ply as jply
from mitsuba_customization_tpu.utils import serialized as jser
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import sdf as tsdf
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.scenes import sdf_and_analytic_spheres
from mitsuba_customization_tpu_torch.utils import obj as tobj
from mitsuba_customization_tpu_torch.utils import ply as tply
from mitsuba_customization_tpu_torch.utils import serialized as tser
from mitsuba_customization_tpu_torch.utils.meshgen import icosphere_blob, vertex_normals
from test_torch_film import assert_frame_matches_jax
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_render import _arrays


def _assert_mesh_equal(got, want):
    assert len(got) == len(want) == 4
    for name, g, w in zip(("v", "f", "n", "uv"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _blob(n_sub=2, seed=0):
    v, f = icosphere_blob(n_sub=n_sub)
    uv = np.random.default_rng(seed).random((len(v), 2)).astype(np.float32)
    return v, f, vertex_normals(v, f), uv


OBJ_TEXT = """# a quad, a triangle and a pentagon with v/vt/vn corners, negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/1 4/4/1
f -3/-2/-1 -2/-1/-1 -1/1/2
f 1//1 2//1 3//2 5//2 4//1
"""


@pytest.mark.parametrize("kind", ["written", "corners"])
def test_obj_reader_matches_jax(tmp_path, kind):
    """A blob written by the JAX package's write_obj, and a file with
    v/vt/vn corners, polygons and negative indices: read_obj returns the
    JAX reader's arrays."""
    path = tmp_path / "m.obj"
    if kind == "written":
        v, f, _, _ = _blob()
        jobj.write_obj(path, v, f)
    else:
        path.write_text(OBJ_TEXT)
    _assert_mesh_equal(tobj.read_obj(path), jobj.read_obj(path))


def test_obj_writer_round_trip(tmp_path):
    """The port's write_obj: read back, each triangle's corners are the
    written ones, and the JAX reader reads the file as the port's does."""
    v, f, _, _ = _blob()
    tobj.write_obj(tmp_path / "m.obj", v, f)
    _assert_mesh_equal(tobj.read_obj(tmp_path / "m.obj"), jobj.read_obj(tmp_path / "m.obj"))
    # the reader numbers vertices in their first corner's order
    got = tobj.read_obj(tmp_path / "m.obj")
    np.testing.assert_array_equal(got[0][got[1]], v[f])


PLY_ASCII = """ply
format ascii 1.0
comment quads and s/t texture coordinates
element vertex 5
property float x
property float y
property float z
property float s
property float t
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 0
1 0 0 1 0
1 1 0 1 1
0 1 0 0 1
0.5 1.5 0.25 0.5 1
4 0 1 2 3
3 3 2 4
"""


def _binary_polygons(path):
    """A binary PLY whose faces are a quad and a triangle (the reader's
    row-by-row path)."""
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              "property float x\nproperty float y\nproperty float z\n"
              "element face 2\nproperty list uchar int vertex_indices\nend_header\n")
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 1.5, 0.25]], "<f4")
    body = v.tobytes() + bytes([4]) + np.asarray([0, 1, 2, 3], "<i4").tobytes()
    body += bytes([3]) + np.asarray([3, 2, 4], "<i4").tobytes()
    path.write_bytes(header.encode("ascii") + body)


POLYGONS = (np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 1.5, 0.25]],
                       np.float32),
            np.asarray([[0, 1, 2], [0, 2, 3], [3, 2, 4]], np.int32))


@pytest.mark.parametrize("kind", ["binary", "ascii", "ascii_polygons", "binary_polygons"])
def test_ply_reader_matches_jax(tmp_path, kind):
    """Binary and ascii files written by write_ply (normals and uvs), an
    ascii file of polygons with s/t coordinates, and a binary file of
    polygons: a binary file reads as the JAX reader reads it; every file
    reads back as what was written (polygons fan-triangulated). The JAX
    reader raises TypeError on an ascii file's faces: the port reads
    them."""
    path = tmp_path / "m.ply"
    v, f, n, uv = _blob()
    want = (v, f, n, uv)
    if kind in ("binary", "ascii"):
        tply.write_ply(path, v, f, n, uv, binary=kind == "binary")
    elif kind == "ascii_polygons":
        path.write_text(PLY_ASCII)
        want = POLYGONS + (None, np.asarray([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 1]],
                                            np.float32))
    else:
        _binary_polygons(path)
        want = POLYGONS + (None, None)
    got = tply.read_ply(path)
    _assert_mesh_equal(got, tuple(None if w is None else np.asarray(w).astype(g.dtype)
                                  for g, w in zip(got, want)))
    if kind.startswith("binary"):
        _assert_mesh_equal(got, jply.read_ply(path))
    else:
        with pytest.raises(TypeError):
            jply.read_ply(path)


def test_serialized_reader_and_writer_match_jax(tmp_path):
    """Two meshes (with normals and uvs, and without) written by the JAX
    package's write_serialized, and by the port's: read_serialized returns
    the JAX reader's arrays for each shape_index; a bad index raises."""
    a, b = _blob(2), _blob(1, seed=1)
    meshes = [a, (b[0], b[1], None, None)]
    for writer in (jser.write_serialized, tser.write_serialized):
        path = tmp_path / f"m_{writer.__module__.split('.')[0]}.serialized"
        writer(path, meshes)
        for idx in (0, 1):
            _assert_mesh_equal(tser.read_serialized(path, idx), jser.read_serialized(path, idx))
        with pytest.raises(ValueError, match="out of range"):
            tser.read_serialized(path, 2)
    assert (tmp_path / "m_mitsuba_customization_tpu.serialized").read_bytes() == (
        tmp_path / "m_mitsuba_customization_tpu_torch.serialized").read_bytes()


def _sdf_to_world():
    tw = np.eye(4, dtype=np.float32)
    tw[:3, :3] *= 2.0
    tw[:3, 3] = [-1.0, -1.0, -1.0]
    return tw


def _shape_entries(tmp_path):
    """One scene entry per shape type of the loader, its mesh files
    written into tmp_path."""
    v, f, n, uv = _blob()
    tply.write_ply(tmp_path / "b.ply", v, f, n, uv)
    jobj.write_obj(tmp_path / "b.obj", v, f)
    jser.write_serialized(tmp_path / "b.serialized", [_blob(1), (v, f, n, uv)])
    move = {"scale": 0.5, "rotate": {"axis": [0, 1, 1], "angle": 30}, "translate": [0.2, 0, 1]}
    return {
        "cube": {"c": {"type": "cube", "to_world": move}},
        "disk": {"c": {"type": "disk", "to_world": move}},
        "cylinder": {"c": {"type": "cylinder", "p0": [0, -0.5, 0], "p1": [0.2, 0.5, 0.1],
                           "radius": 0.3, "to_world": move}},
        "obj": {"c": {"type": "obj", "filename": str(tmp_path / "b.obj"), "to_world": move}},
        "ply": {"c": {"type": "ply", "filename": str(tmp_path / "b.ply"), "to_world": move}},
        "serialized": {"c": {"type": "serialized", "filename": str(tmp_path / "b.serialized"),
                             "shape_index": 1, "to_world": move}},
        "face_normals": {"c": {"type": "ply", "filename": str(tmp_path / "b.ply"),
                               "face_normals": True}},
        "instance": {
            "grp": {"type": "shapegroup",
                    "m": {"type": "obj", "filename": str(tmp_path / "b.obj"),
                          "bsdf": {"type": "roughconductor", "alpha": 0.3},
                          "to_world": {"scale": 0.3}},
                    "k": {"type": "cylinder", "radius": 0.1}},
            "i1": {"type": "instance", "shapegroup": "grp", "to_world": move},
            "i2": {"type": "instance", "ref": {"id": "grp"},
                   "to_world": {"translate": [-1.0, 0.5, 2.0]}}},
        "sdfgrid": {"c": {"type": "sdfgrid", "grid": tsdf.sphere_sdf(n=16),
                          "to_world": _sdf_to_world(),
                          "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.5, 0.7]}}},
    }


SHAPES = ["cube", "disk", "cylinder", "obj", "ply", "serialized", "face_normals", "instance",
          "sdfgrid"]


@pytest.mark.parametrize("name", SHAPES)
def test_shape_loads_as_in_jax(tmp_path, name):
    """Each shape type beside a sphere under a sky: the port's geometry
    table (every field), its cylinder flag, intersector and SDF grid equal
    the JAX loader's (through scene_from_numpy)."""
    d = {"type": "scene", "s": {"type": "sphere", "center": [0, 0, 4]},
         "sky": {"type": "constant"}, **_shape_entries(tmp_path)[name]}
    own = mt.load_dict(d, "cpu")
    js = jscene_mod.load_dict(d)
    ref = scene_from_numpy(_arrays(js), js.config, "cpu")
    for f, a, b in zip(geo.Geometry._fields, own.geometry, ref.geometry):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    assert own.has_cylinders == ref.has_cylinders == (name in ("cylinder", "instance"))
    assert own.config.intersector == ref.config.intersector
    assert (own.sdf is None) == (ref.sdf is None) == (name != "sdfgrid")
    if own.sdf is not None:
        for f, a, b in zip(tsdf.SDFGrid._fields, own.sdf, ref.sdf):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    np.testing.assert_array_equal(own.bsdfs.mat_type.numpy(), ref.bsdfs.mat_type.numpy())


def test_sdf_intersect_matches_jax():
    """4,096 rays from seeded origins toward a 64^3 SDF sphere (placed by
    a scale and a translation), some of them grazing or missing: hit flags
    equal on >= 99.9 % of lanes; t and the normals within atol 1e-5 where
    both hit, but for a lane in a thousand that stops one HIT_EPS step
    apart; maxt cuts the march as in the JAX package."""
    rng = np.random.default_rng(0)
    n = 4096
    grid, tw = tsdf.sphere_sdf(n=64), _sdf_to_world()
    o = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -3.0]).astype(np.float32)
    tgt = rng.normal(size=(n, 3)) * 0.5
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.random(n) < 0.1, 2.5, np.inf).astype(np.float32)
    jg = jsdf.make(grid, to_world=tw)
    tg = tsdf.make(grid, tw, device="cpu")
    jr = JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt))
    tr = Ray(o=torch.as_tensor(o), d=torch.as_tensor(d), maxt=torch.as_tensor(maxt))
    jt, jhit, jp = jsdf.intersect(jg, jr)
    tt, thit, tp = tsdf.intersect(tg, tr)
    jhit, thit = np.asarray(jhit), thit.numpy()
    assert 0.2 < jhit.mean() < 0.9 and (maxt < 3).any()
    assert (jhit == thit).mean() >= 0.999
    both = jhit & thit
    dt = np.abs(tt.numpy() - np.asarray(jt))[both]
    # a lane whose distance lands within rounding of HIT_EPS stops one
    # step (HIT_EPS / |d_local| = 2e-4 here) later in one package: the
    # two rotate rays into the grid with matrix products that round apart
    assert (dt <= 1e-5).mean() >= 0.999 and dt.max() <= 1.01 * tsdf.HIT_EPS / 0.5
    jn = np.asarray(jsdf.interaction(jg, jr, jt, jnp.asarray(jhit), jp).n)
    tn = tsdf.interaction(tg, tr, tt, torch.as_tensor(thit), tp).n.numpy()
    same = both.copy()
    same[both] = dt <= 1e-5
    np.testing.assert_allclose(tn[same], jn[same], rtol=0, atol=1e-5)


def _shapes_frame_dict(res=16, spp=16, sdf=None):
    """A cube, a disk, a cylinder and a sphere (and optionally an SDF
    sphere) on a floor, under an area light and a sky."""
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": mt.look_at([0, 2.0, -4.5], [0, 0.2, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.5] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 5.0,
                               "translate": [0, -0.5, 0]}},
        "box": {"type": "cube", "bsdf": {"type": "diffuse", "reflectance": [0.8, 0.3, 0.2]},
                "to_world": {"scale": 0.4, "rotate": {"axis": [0, 1, 0], "angle": 25},
                             "translate": [-1.2, -0.1, 0.3]}},
        "lid": {"type": "disk", "bsdf": {"type": "roughconductor", "alpha": 0.2},
                "to_world": {"scale": 0.5, "rotate": {"axis": [1, 0, 0], "angle": -60},
                             "translate": [1.3, 0.2, 0.8]}},
        "can": {"type": "cylinder", "p0": [0.3, -0.5, -0.5], "p1": [0.3, 0.6, -0.5],
                "radius": 0.3, "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.6, 0.3]}},
        "ball": {"type": "sphere", "center": [-0.2, 0.0, 1.2], "radius": 0.5,
                 "bsdf": {"type": "roughconductor", "alpha": 0.1}},
        "light": {"type": "rectangle", "emitter": {"type": "area", "radiance": [6.0] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "scale": 0.8,
                               "translate": [0.5, 2.5, -0.5]}},
        "sky": {"type": "constant", "radiance": [0.1, 0.12, 0.15]},
    }
    if sdf is not None:
        d["blob"] = sdf
    return d


def test_shapes_frame_matches_jax():
    """A cube, disk, cylinder, sphere and a 32^3 SDF sphere on a floor
    (16x16, 16 spp, depth 3) through load_dict -> render: means within 1 %
    and the Z-test against the JAX render."""
    tw = np.diag([0.8, 0.8, 0.8, 1.0]).astype(np.float32)
    tw[:3, 3] = [0.6, -0.5, 1.6]
    assert_frame_matches_jax(_shapes_frame_dict(sdf={
        "type": "sdfgrid", "grid": tsdf.sphere_sdf(n=32), "to_world": tw,
        "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.7, 0.2]}}))


def test_sdf_sphere_renders_like_the_analytic_sphere():
    """The JAX package's tests/test_sdf.py::
    test_sdf_sphere_render_matches_analytic_sphere on the port."""
    img_sdf, img_ref = sdf_and_analytic_spheres("cpu")
    assert torch.isfinite(img_sdf).all()
    assert abs(float(img_sdf.mean()) - float(img_ref.mean())) < 0.02
    assert float((img_sdf - img_ref).abs().mean()) < 0.03
