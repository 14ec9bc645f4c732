"""Scene dicts the port is exercised on, and the compaction probe.

`config0_dict` is BASELINE configs[0], the scene of the JAX package's
tests/test_golden.py: a unit sphere of one BSDF under a constant emitter,
direct illumination.

`flagship_dict` is the same dict literal as the JAX package's flagship
scene (`__graft_entry__._flagship_scene`): a sphere with a synthetic
MERL-format (90, 90, 180, 3) table, a GGX roughconductor sphere, a diffuse
floor rectangle and a constant sky, rendered by the path integrator.

`matpreview_dict` is the literal of the repository's headline scene
(`__graft_entry__._matpreview_scene`): a displaced icosphere (20 * 4**n_sub
triangles) painted with `n_materials` synthetic MERL tables in latitude
bands, a GGX roughconductor floor, a rectangle area light and a dim
constant sky. `probe_compact_schedule` is the JAX package's benchmark
probe (`bench._probe_compact_schedule`). They let scripts and tests build
the scenes without the JAX package.

`production_dict` is the literal of the production configuration
(`__graft_entry__._production_scene`).
`matpreview_xml` writes the same scene as a Mitsuba XML file beside its
PLY meshes and MERL tables.
`camera_dict` is the matpreview scene seen through a thin lens focused on
the blob, sampled by multijitter and developed by the gaussian filter.
`volpath_dict` is the matpreview scene with a homogeneous fog ball and a
heterogeneous smoke cube under the volumetric tracer; `fog_dict`,
`ptracer_box_dict` and `bdpt_spheres_dict` are the JAX package's media,
ptracer and bdpt test scenes.
`shape_files` writes the meshes of the shapes scene (binary PLY, OBJ,
serialized) from a seeded numpy state, and `shapes_dict` loads them beside
a cube, a disk, cylinders and a sphere (or an SDF sphere in place of the
largest mesh).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mitsuba_customization_tpu_torch.render.sdf import sphere_sdf
from mitsuba_customization_tpu_torch.render.sensors import look_at
from mitsuba_customization_tpu_torch.utils.meshgen import (
    face_bands,
    icosphere_blob,
    vertex_normals,
)
from mitsuba_customization_tpu_torch.utils.obj import write_obj
from mitsuba_customization_tpu_torch.utils.ply import write_ply
from mitsuba_customization_tpu_torch.utils.serialized import write_serialized


def flagship_table():
    """Synthetic MERL-format table: a diffuse floor plus a specular ridge
    at theta_h ~ 0 (no MERL data ships in the repository)."""
    return synthetic_merl_table(0.2, [1.0, 0.8, 0.5])


def config0_dict(bsdf, res=64, spp=64):
    """BASELINE configs[0]: a unit sphere with `bsdf` under a constant
    emitter of radiance 1, direct illumination, camera at distance 4."""
    return {
        "type": "scene",
        "integrator": {"type": "direct", "max_depth": 2},
        "sensor": {
            "type": "perspective",
            "fov": 40,
            "to_world": look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "sphere": {"type": "sphere", "bsdf": bsdf},
        "light": {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
    }


def flagship_dict(res=64, spp=4, depth=4):
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {
            "type": "perspective",
            "fov": 45,
            "to_world": look_at([0, 1.5, -4], [0, 0, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "merl_sphere": {
            "type": "sphere",
            "center": [-0.8, 0, 0],
            "radius": 0.9,
            "bsdf": {"type": "merl", "table": flagship_table()},
        },
        "ggx_sphere": {
            "type": "sphere",
            "center": [1.2, 0, 0.5],
            "radius": 0.9,
            "bsdf": {"type": "roughconductor", "alpha": 0.15},
        },
        "floor": {
            "type": "rectangle",
            "to_world": {
                "rotate": {"axis": [1, 0, 0], "angle": -90},
                "scale": 8.0,
                "translate": [0, -0.95, 0],
            },
            "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]},
        },
        "light": {"type": "constant", "radiance": [0.8, 0.9, 1.0]},
    }


def synthetic_merl_table(lobe_width, color):
    """MERL-format (90, 90, 180, 3) table: a diffuse floor plus a specular
    ridge at theta_h ~ 0 of the given width, tinted `color`."""
    n_th, n_td, n_pd = 90, 90, 180
    u = (np.arange(n_th) + 0.5) / n_th
    th = (np.pi / 2) * u**2
    lobe = np.exp(-((np.tan(np.minimum(th, 1.5)) / lobe_width) ** 2))
    mono = 0.03 + 0.6 * np.broadcast_to(lobe[:, None, None], (n_th, n_td, n_pd))
    return (mono[..., None] * np.asarray(color)).astype(np.float32)


_BAND_COLORS = [
    [1.0, 0.8, 0.5], [0.4, 0.6, 1.0], [1.0, 0.4, 0.4], [0.5, 1.0, 0.6],
    [0.9, 0.9, 0.9], [0.8, 0.5, 1.0], [1.0, 1.0, 0.4], [0.4, 1.0, 1.0],
    [1.0, 0.6, 0.8], [0.6, 0.7, 0.9],
]


def matpreview_dict(res=512, spp=16, depth=8, n_sub=5, n_materials=10,
                    compact=None):
    """The matpreview scene: n_sub = 5 gives 20,480 blob triangles (20,484
    prims with the floor and the light)."""
    v, f = icosphere_blob(n_sub=n_sub)
    vn = vertex_normals(v, f)
    bands = face_bands(v, f, n_materials)
    d = {
        "type": "scene",
        "integrator": {
            "type": "path", "max_depth": depth, "compact": compact,
        },
        "sensor": {
            "type": "perspective",
            "fov": 40,
            "to_world": look_at([0, 1.6, -3.6], [0, 0.1, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "floor": {
            "type": "rectangle",
            "to_world": {
                "rotate": {"axis": [1, 0, 0], "angle": -90},
                "scale": 12.0,
                "translate": [0, -1.2, 0],
            },
            "bsdf": {"type": "roughconductor", "alpha": 0.25},
        },
        "light": {
            "type": "rectangle",
            "to_world": {
                "rotate": {"axis": [1, 0, 0], "angle": 90},
                "scale": 1.2,
                "translate": [1.5, 3.2, -1.0],
            },
            "emitter": {"type": "area", "radiance": [18.0, 17.0, 15.0]},
        },
        "sky": {"type": "constant", "radiance": [0.08, 0.09, 0.12]},
    }
    for i, fi in enumerate(bands):
        d[f"blob_{i}"] = {
            "type": "mesh",
            "vertices": v,
            "faces": f[fi],
            "normals": vn,
            "bsdf": {
                "type": "merl",
                "table": synthetic_merl_table(
                    0.08 + 0.04 * i, _BAND_COLORS[i % len(_BAND_COLORS)]
                ),
            },
        }
    return d


def production_dict(res=32, spp=2, depth=3, compact=(1.0, 0.8, 0.6)):
    """The literal of the repository's production configuration
    (`__graft_entry__._production_scene`): a 320-triangle MERL blob (the
    cluster intersector), a null sphere around a homogeneous medium (the
    volumetric tracer), a GGX floor, an area light, a sky, the gaussian
    film filter and a compaction schedule."""
    v, f = icosphere_blob(n_sub=2)
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": depth, "compact": tuple(compact)},
        "sensor": {
            "type": "perspective",
            "fov": 45,
            "to_world": look_at([0, 1.2, -3.6], [0, 0, 0], [0, 1, 0]),
            "film": {"width": res, "height": res, "rfilter": "gaussian"},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "blob": {"type": "mesh", "vertices": v, "faces": f, "normals": vertex_normals(v, f),
                 "bsdf": {"type": "merl", "table": synthetic_merl_table(0.1, [1.0, 0.8, 0.5])}},
        "fog_ball": {"type": "sphere", "center": [1.4, 0.2, 0.3], "radius": 0.7,
                     "bsdf": {"type": "null"},
                     "interior": {"type": "homogeneous", "sigma_t": [0.8, 0.9, 1.0],
                                  "albedo": [0.7, 0.7, 0.7]}},
        "floor": {"type": "rectangle",
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 8.0,
                               "translate": [0, -1.0, 0]},
                  "bsdf": {"type": "roughconductor", "alpha": 0.2}},
        "light": {"type": "rectangle",
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "scale": 0.8,
                               "translate": [1.0, 2.8, -0.5]},
                  "emitter": {"type": "area", "radiance": [10.0, 9.0, 8.0]}},
        "sky": {"type": "constant", "radiance": [0.05, 0.06, 0.08]},
    }


def matpreview_xml(root, n_sub=5, n_materials=10):
    """Write the matpreview scene as a Mitsuba XML file under `root`: each
    band of the blob a binary PLY (all vertices, their normals and the
    band's faces, written by utils/ply.write_ply), each band's table a MERL
    .binary file (models/merl.write_merl), id'd top-level <bsdf>s that the
    bands <ref>, the floor, the area light and the sky, in
    matpreview_dict's order and transforms, and <default>s for spp, res
    and depth (8, 512, 8). Returns the XML's path."""
    from mitsuba_customization_tpu_torch.models.merl import write_merl

    os.makedirs(root, exist_ok=True)
    d = matpreview_dict(n_sub=n_sub, n_materials=n_materials)
    bands, shapes = [], []
    for i in range(n_materials):
        blob = d[f"blob_{i}"]
        write_ply(os.path.join(root, f"blob_{i}.ply"), blob["vertices"], blob["faces"],
                  normals=blob["normals"])
        write_merl(os.path.join(root, f"band_{i}.binary"), blob["bsdf"]["table"])
        bands.append(f'  <bsdf type="merl" id="band_{i}">'
                     f'<string name="filename" value="band_{i}.binary"/></bsdf>')
        shapes.append(f'  <shape type="ply" id="blob_{i}">'
                      f'<string name="filename" value="blob_{i}.ply"/><ref id="band_{i}"/>'
                      f'</shape>')
    xml = "\n".join([
        '<scene version="3.0.0">',
        '  <default name="spp" value="8"/>',
        '  <default name="res" value="512"/>',
        '  <default name="depth" value="8"/>',
        '  <integrator type="path"><integer name="max_depth" value="$depth"/></integrator>',
        '  <sensor type="perspective">',
        '    <float name="fov" value="40"/>',
        '    <transform name="to_world">'
        '<lookat origin="0, 1.6, -3.6" target="0, 0.1, 0" up="0, 1, 0"/></transform>',
        '    <film type="hdrfilm"><integer name="width" value="$res"/>'
        '<integer name="height" value="$res"/><rfilter type="box"/></film>',
        '    <sampler type="independent"><integer name="sample_count" value="$spp"/></sampler>',
        '  </sensor>',
        *bands,
        '  <shape type="rectangle" id="floor">',
        '    <transform name="to_world"><scale value="12"/><rotate x="1" angle="-90"/>'
        '<translate y="-1.2"/></transform>',
        '    <bsdf type="roughconductor"><float name="alpha" value="0.25"/></bsdf>',
        '  </shape>',
        '  <shape type="rectangle" id="light">',
        '    <transform name="to_world"><scale value="1.2"/><rotate x="1" angle="90"/>'
        '<translate x="1.5" y="3.2" z="-1.0"/></transform>',
        '    <emitter type="area"><rgb name="radiance" value="18, 17, 15"/></emitter>',
        '  </shape>',
        '  <emitter type="constant" id="sky"><rgb name="radiance" value="0.08, 0.09, 0.12"/>'
        '</emitter>',
        *shapes,
        '</scene>',
    ])
    path = os.path.join(root, "matpreview.xml")
    with open(path, "w") as f:
        f.write(xml + "\n")
    return path


def probe_compact_schedule(scene, spp=4):
    """One pass of spp samples per pixel -> per-bounce live fractions ->
    the scene with that compaction schedule, and the schedule.

    rays_per_bounce counts the live lanes entering each bounce plus the
    NEE shadow rays, so the fractions are conservative; the schedule keeps
    20 % + 2 points of headroom (1.2 * fraction + 0.02, at most 1) so that
    thinning live lanes stays rare."""
    from mitsuba_customization_tpu_torch.render.integrator import render_lanes

    _, _, st = render_lanes(scene, spp, 0)
    rpb = st["rays_per_bounce"].cpu().numpy()
    fracs = [1.0] + [
        min(1.0, float(f) * 1.2 + 0.02) for f in (rpb[1:] / max(rpb[0], 1))
    ]
    cfg = dataclasses.replace(scene.config, compact=tuple(fracs))
    return dataclasses.replace(scene, config=cfg), fracs


# the matpreview camera: its origin and target (matpreview_dict)
_MP_EYE, _MP_TARGET = np.array([0.0, 1.6, -3.6]), np.array([0.0, 0.1, 0.0])


def camera_dict(res=512, spp=8, depth=8, n_sub=5, compact=None, aperture=0.05):
    """matpreview_dict seen through a thin lens of radius `aperture`
    focused on the blob's centre (the origin), the multijitter sampler and
    the gaussian film filter."""
    d = matpreview_dict(res, spp, depth, n_sub=n_sub, compact=compact)
    fwd = (_MP_TARGET - _MP_EYE) / np.linalg.norm(_MP_TARGET - _MP_EYE)
    d["sensor"].update(type="thinlens", aperture_radius=aperture,
                       focus_distance=float(np.dot(-_MP_EYE, fwd)))
    d["sensor"]["sampler"]["type"] = "multijitter"
    d["sensor"]["film"]["rfilter"] = {"type": "gaussian"}
    return d


def shape_files(root, seed=0, n_sub=(7, 6, 5)):
    """Write the shapes scene's meshes into `root` from a seeded numpy
    state: the displaced blob of 20 * 4**n_sub[0] triangles as a binary
    PLY (big.ply), one of 20 * 4**n_sub[1] as an OBJ (mid.obj), two of 20 *
    4**n_sub[2] as one serialized file (pair.serialized; normals and uvs
    in the first), and one of those as a PLY for the shapegroup
    (group.ply). The seed jitters the vertices. Returns {name: path}."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    def blob(n):
        v, f = icosphere_blob(n_sub=n)
        v = (v * (1.0 + 0.01 * rng.standard_normal((len(v), 1)))).astype(np.float32)
        return v, f, vertex_normals(v, f)

    paths = {k: os.path.join(root, k) for k in ("big.ply", "mid.obj", "pair.serialized",
                                                 "group.ply")}
    v, f, n = blob(n_sub[0])
    write_ply(paths["big.ply"], v, f, n)
    v, f, _ = blob(n_sub[1])
    write_obj(paths["mid.obj"], v, f)
    v, f, n = blob(n_sub[2])
    uv = rng.random((len(v), 2)).astype(np.float32)
    v2, f2, _ = blob(n_sub[2])
    write_serialized(paths["pair.serialized"], [(v, f, n, uv), (v2, f2, None, None)])
    write_ply(paths["group.ply"], v2, f2)
    return paths


def shapes_dict(paths, res=512, spp=8, depth=8, compact=None, sdf_res=None):
    """The shapes scene: the big PLY blob (MERL) in the middle, or with
    sdf_res an sdf_res^3 SDF sphere in its place; the OBJ blob
    (roughconductor) on the left; the serialized pair (MERL, diffuse) on
    the right; the group blob instanced four times along the back; a
    cube, a disk, three cylinders and a sphere in front; a
    roughconductor floor, a rectangle area light and a dim sky."""
    merl = [{"type": "merl", "table": synthetic_merl_table(w, c)}
            for w, c in ((0.1, [1.0, 0.8, 0.5]), (0.2, [0.4, 0.6, 1.0]),
                         (0.15, [0.9, 0.9, 0.9]))]
    diffuse = {"type": "diffuse", "reflectance": [0.6, 0.5, 0.4]}
    rough = {"type": "roughconductor", "alpha": 0.2}
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth, "compact": compact},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": look_at([0, 2.2, -5.0], [0, 0.2, 0.5], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": rough,
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 12.0,
                               "translate": [0, -1.0, 0]}},
        "light": {"type": "rectangle", "emitter": {"type": "area", "radiance": [18.0, 17.0, 15.0]},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "scale": 1.2,
                               "translate": [1.5, 3.5, -1.0]}},
        "sky": {"type": "constant", "radiance": [0.08, 0.09, 0.12]},
        "mid": {"type": "obj", "filename": paths["mid.obj"], "bsdf": rough,
                "to_world": {"scale": 0.6, "translate": [-1.9, -0.4, 0.6]}},
        "pair_a": {"type": "serialized", "filename": paths["pair.serialized"], "shape_index": 0,
                   "bsdf": merl[1], "to_world": {"scale": 0.45, "translate": [1.8, -0.55, 0.2]}},
        "pair_b": {"type": "serialized", "filename": paths["pair.serialized"], "shape_index": 1,
                   "bsdf": diffuse, "to_world": {"scale": 0.45, "translate": [2.6, -0.55, 1.6]}},
        "group": {"type": "shapegroup",
                  "blob": {"type": "ply", "filename": paths["group.ply"], "bsdf": merl[2],
                           "to_world": {"scale": 0.35}}},
        "box": {"type": "cube", "bsdf": diffuse,
                "to_world": {"scale": 0.3, "rotate": {"axis": [0, 1, 0], "angle": 30},
                             "translate": [-0.9, -0.7, -1.2]}},
        "lid": {"type": "disk", "bsdf": rough,
                "to_world": {"scale": 0.35, "rotate": {"axis": [1, 0, 0], "angle": -70},
                             "translate": [0.9, -0.6, -1.4]}},
        "ball": {"type": "sphere", "center": [0.1, -0.65, -1.8], "radius": 0.35, "bsdf": merl[1]},
    }
    for i in range(4):
        d[f"inst_{i}"] = {"type": "instance", "shapegroup": "group",
                          "to_world": {"rotate": {"axis": [0, 1, 0], "angle": 40 * i},
                                       "translate": [-2.4 + 1.6 * i, -0.65, 3.0]}}
    for i, (x, z) in enumerate(((-1.6, -0.6), (1.4, -0.4), (0.0, 1.9))):
        d[f"can_{i}"] = {"type": "cylinder", "p0": [x, -1.0, z], "p1": [x, 0.2 + 0.3 * i, z],
                         "radius": 0.18, "bsdf": rough if i % 2 else diffuse}
    if sdf_res is None:
        d["big"] = {"type": "ply", "filename": paths["big.ply"], "bsdf": merl[0],
                    "to_world": {"scale": 0.9, "translate": [0, 0, 0.6]}}
    else:
        # sphere_sdf's sphere (centre 0.5, radius 0.35 of the unit cube)
        # scaled to the blob's size
        tw = np.diag([2.6, 2.6, 2.6, 1.0]).astype(np.float32)
        tw[:3, 3] = [-1.3, -1.3, -0.7]
        d["big"] = {"type": "sdfgrid", "grid": sphere_sdf(n=sdf_res), "to_world": tw,
                    "bsdf": merl[0]}
    return d


def variant_dict(res=64, spp=4, depth=4, sampler="independent", rfilter="box", sensor=None):
    """flagship_dict with another sampler, film filter or sensor (a dict
    of sensor fields: its type and parameters). A distant sensor's rays
    start 1e4 away, where the sphere test's quadratic has lost its float32
    precision, so its scene has cubes in place of the two spheres."""
    d = flagship_dict(res, spp, depth)
    d["sensor"]["sampler"]["type"] = sampler
    d["sensor"]["film"]["rfilter"] = {"type": rfilter}
    if sensor:
        d["sensor"].update(sensor)
    if (sensor or {}).get("type") == "distant":
        for key in ("merl_sphere", "ggx_sphere"):
            sph = d[key]
            d[key] = {"type": "cube", "bsdf": sph["bsdf"],
                      "to_world": {"scale": 0.75 * sph["radius"], "translate": sph["center"]}}
    return d


def meter_dict(kind):
    """The JAX package's measurement-sensor tests' scenes
    (tests/test_render.py): a radiancemeter at the origin facing a diffuse
    wall of albedo 0.5 at z = 2 under unit light (it reads 0.5; 256 spp),
    or an irradiancemeter in a unit radiance field (it reads pi; 512
    spp)."""
    spp = 256 if kind == "radiancemeter" else 512
    d = {"type": "scene", "integrator": {"type": "direct", "max_depth": 2},
         "sensor": {"type": kind, "to_world": np.eye(4).tolist(),
                    "sampler": {"type": "independent", "sample_count": spp}},
         "light": {"type": "constant", "radiance": [1.0, 1.0, 1.0]}}
    if kind == "radiancemeter":
        d["wall"] = {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.5] * 3},
                     "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 180}, "scale": 10.0,
                                  "translate": [0, 0, 2.0]}}
    else:
        d["dot"] = {"type": "sphere", "center": [100, 100, -100], "radius": 0.1,
                    "bsdf": {"type": "diffuse"}}
    return d


BATCH_LOOKS = (look_at([0, 0, -4], [-0.8, 0, 0], [0, 1, 0]),
               look_at([0, 0, -4], [1.0, 0, 0.5], [0, 1, 0]))


def batch_strips_dict(sensor):
    """The scene of the JAX package's tests/test_plugins4.py::
    test_batch_sensor_strips (two diffuse spheres under unit light), seen
    by `sensor`."""
    return {
        "type": "scene", "integrator": {"type": "path", "max_depth": 2},
        "sensor": sensor,
        "sphere_l": {"type": "sphere", "center": [-0.8, 0, 0], "radius": 0.6,
                     "bsdf": {"type": "diffuse", "reflectance": [0.9, 0.2, 0.2]}},
        "sphere_r": {"type": "sphere", "center": [1.0, 0, 0.5], "radius": 0.6,
                     "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.2, 0.9]}},
        "light": {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
    }


def batch_strip_means(device, w=32, h=16, spp=16):
    """test_batch_sensor_strips on `device`: ((left, right) strip means of
    the batch of two perspective sensors, (left, right) means of the two
    half-width perspective renders)."""
    from mitsuba_customization_tpu_torch.render.integrator import render
    from mitsuba_customization_tpu_torch.render.scene import load_dict

    img = render(load_dict(batch_strips_dict({
        "type": "batch", "film": {"width": w, "height": h},
        "a": {"type": "perspective", "fov": 45, "to_world": BATCH_LOOKS[0]},
        "b": {"type": "perspective", "fov": 45, "to_world": BATCH_LOOKS[1]}}), device),
        spp=spp, seed=3)
    halves = [float(render(load_dict(batch_strips_dict({
        "type": "perspective", "fov": 45, "to_world": look,
        "film": {"width": w // 2, "height": h}}), device), spp=spp, seed=3).mean())
        for look in BATCH_LOOKS]
    return (float(img[:, :w // 2].mean()), float(img[:, w // 2:].mean())), tuple(halves)


def sdf_sphere_dict(entry, res=32, spp=32):
    """The JAX package's tests/test_sdf.py scene around `entry` (an SDF or
    an analytic sphere of radius 0.7 at the origin)."""
    return {
        "type": "scene", "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": look_at([0, 0.6, -3.2], [0, 0, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "obj": entry,
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.5] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 6.0,
                               "translate": [0, -0.75, 0]}},
        "light": {"type": "constant", "radiance": [0.8, 0.9, 1.0]},
    }


def sdf_and_analytic_spheres(device, n=96, res=32, spp=32):
    """tests/test_sdf.py's two renders on `device`: (the n^3 SDF sphere's
    image, the analytic sphere's image)."""
    from mitsuba_customization_tpu_torch.render.integrator import render
    from mitsuba_customization_tpu_torch.render.scene import load_dict

    bsdf = {"type": "diffuse", "reflectance": [0.7, 0.3, 0.2]}
    tw = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    tw[:3, 3] = -1.0
    return tuple(render(load_dict(sdf_sphere_dict(e, res, spp), device), spp=spp, seed=2)
                 for e in ({"type": "sdfgrid", "grid": sphere_sdf(n=n), "to_world": tw,
                            "bsdf": bsdf}, {"type": "sphere", "radius": 0.7, "bsdf": bsdf}))


def smooth_volume(rng, n, waves=6):
    """A smooth seeded (n, n, n) float32 field scaled to [0, 1]: a sum of
    products of sines along the three axes (made in place, one wave at a
    time, so a 256^3 field takes 64 MiB and no more)."""
    c = (np.arange(n, dtype=np.float32) + 0.5) / n
    f = np.zeros((n, n, n), np.float32)
    for _ in range(waves):
        k, ph = rng.integers(1, 6, 3), rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        sz, sy, sx = (np.sin(np.float32(2 * np.pi) * ki * c + p) for ki, p in zip(k, ph))
        f += sz[:, None, None] * (sy[:, None] * sx[None, :])[None]
    f -= f.min()
    f /= f.max()
    return f


# the volpath scene's media: the production scene's homogeneous fog ball
# (__graft_entry__._production_scene) and a heterogeneous cube, left and
# right in front of the matpreview blob and clear of it and of the floor
VOL_FOG = {"type": "homogeneous", "sigma_t": [0.8, 0.9, 1.0], "albedo": [0.7, 0.7, 0.7]}
VOL_FOG_CENTER, VOL_FOG_RADIUS = [-0.75, 0.05, -1.55], 0.4
VOL_CUBE_CENTER, VOL_CUBE_HALF = [0.8, -0.05, -1.55], 0.35


def volpath_dict(res=512, spp=8, depth=8, grid_res=256, seed=10, n_sub=5):
    """The matpreview scene (matpreview_dict) under the volpath integrator
    with two media: a null sphere around the production scene's fog (a
    homogeneous isotropic medium, sigma_t (0.8, 0.9, 1.0), albedo 0.7)
    and a null cube holding a heterogeneous medium (sigma_t (4, 4.5, 5),
    albedo 0.8, HG g = 0.6) whose density is a seeded smooth grid_res^3
    float32 grid (smooth_volume) in the gridvolume form, filling the
    cube."""
    d = matpreview_dict(res, spp, depth, n_sub=n_sub)
    d["integrator"] = {"type": "volpath", "max_depth": depth}
    d["fog_ball"] = {"type": "sphere", "center": VOL_FOG_CENTER, "radius": VOL_FOG_RADIUS,
                     "bsdf": {"type": "null"}, "interior": VOL_FOG}
    h = VOL_CUBE_HALF
    grid_to_world = np.diag([2 * h, 2 * h, 2 * h, 1.0]).astype(np.float32)
    grid_to_world[:3, 3] = np.asarray(VOL_CUBE_CENTER, np.float32) - h
    d["smoke_box"] = {
        "type": "cube", "bsdf": {"type": "null"},
        "to_world": {"scale": h, "translate": VOL_CUBE_CENTER},
        "interior": {"type": "heterogeneous", "sigma_t": [4.0, 4.5, 5.0],
                     "albedo": [0.8, 0.8, 0.8], "phase": {"type": "hg", "g": 0.6},
                     "density": {"grid": smooth_volume(np.random.default_rng(seed), grid_res),
                                 "to_world": grid_to_world}},
    }
    return d


def fog_dict(sigma, albedo, radius=0.8, emitter_radiance=2.0, depth=8, res=24, spp=192,
             radiance=None):
    """The JAX package's tests/test_media.py fog ball: a null sphere of a
    homogeneous medium (emitting `radiance` when given) at the origin,
    seen from 4 units away (fov 30) under a constant emitter of
    `emitter_radiance` (none when 0)."""
    d = {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 30,
                   "to_world": look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "fog": {"type": "sphere", "radius": radius, "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous", "sigma_t": sigma, "albedo": albedo}},
    }
    if radiance is not None:
        d["fog"]["interior"]["radiance"] = radiance
    if emitter_radiance:
        d["light"] = {"type": "constant", "radiance": [emitter_radiance] * 3}
    return d


def ptracer_box_dict(integrator, spp=64, depth=3, res=32):
    """The JAX package's tests/test_ptracer.py scene: a diffuse floor and
    ball under a rectangle lamp, seen from above the floor."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": look_at([0, 1.0, -3.2], [0, 0.5, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.5, 0.3]},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 3.0}},
        "ball": {"type": "sphere", "center": [0.0, 0.6, 0.0], "radius": 0.6,
                 "bsdf": {"type": "diffuse", "reflectance": [0.3, 0.5, 0.7]}},
        "lamp": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0, 0, 0]},
                 "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "scale": 0.8,
                              "translate": [0, 2.4, 0]},
                 "emitter": {"type": "area", "radiance": [8.0, 8.0, 8.0]}},
    }


def bdpt_spheres_dict(integrator, spp, depth=4, res=32, light_scale=0.5,
                      light_pos=(0.5, 2.5, -0.5), radiance=40.0, alpha=0.3):
    """The JAX package's tests/test_bdpt.py scene: a diffuse and a GGX
    sphere over a diffuse floor under a rectangle light (small and very
    bright near the floor in its second golden case)."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": look_at([0, 1.0, -3.5], [0, 0, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "ball": {"type": "sphere", "center": [-0.6, 0, 0], "radius": 0.8,
                 "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.5, 0.3]}},
        "ball2": {"type": "sphere", "center": [1.0, 0, 0.3], "radius": 0.8,
                  "bsdf": {"type": "roughconductor", "alpha": alpha}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.5, 0.5, 0.5]},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 6.0,
                               "translate": [0, -0.8, 0]}},
        "light": {"type": "rectangle",
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90},
                               "scale": light_scale, "translate": list(light_pos)},
                  "emitter": {"type": "area",
                              "radiance": [radiance, radiance * 0.95, radiance * 0.9]}},
    }


# tests/test_bdpt.py's second golden case: a small, very bright light
# grazing the glossy floor, where the t = 1 strategy carries real weight
BDPT_SMALL_LIGHT = dict(light_scale=0.08, light_pos=(0.3, 0.35, -0.6), radiance=900.0,
                        alpha=0.15)


def light_paths_vs_path(device, res=32):
    """The JAX tests' comparisons of the light tracers with the path
    tracer (tests/test_ptracer.py::test_ptracer_matches_path,
    tests/test_bdpt.py::test_bdpt_matches_path_glossy) on `device`:
    {name: (path image, its image, mean tolerance)}."""
    from mitsuba_customization_tpu_torch.render.integrator import render
    from mitsuba_customization_tpu_torch.render.scene import load_dict

    def img(d, seed):
        return render(load_dict(d, device), seed=seed).cpu().numpy()

    return {
        "ptracer": (img(ptracer_box_dict("path", 196, res=res), 3),
                    img(ptracer_box_dict("ptracer", 196, res=res), 7), 0.05),
        "bdpt": (img(bdpt_spheres_dict("path", 48, res=res), 3),
                 img(bdpt_spheres_dict("bdpt", 48, res=res), 7), 0.07),
    }


def aggregate_agreement(path_img, img, tol):
    """The JAX tests' aggregate rules on two numpy images: (the image
    means within tol of the path image's mean + 1e-3, the normalised
    cross-correlation of the channel-mean images > 0.95, the means'
    difference, the correlation)."""
    diff = abs(float(path_img.mean()) - float(img.mean()))
    a = path_img.mean(-1).ravel() - path_img.mean()
    b = img.mean(-1).ravel() - img.mean()
    ncc = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-12))
    return diff < tol * float(path_img.mean()) + 1e-3 and ncc > 0.95, diff, ncc
