"""Scene container + dict-based scene loader.

PyTorch port of mitsuba_customization_tpu/render/scene.py (`load_dict`,
`SceneConfig`, `Scene`) for this subset:

* shapes: sphere, cylinder, rectangle, cube, disk, mesh (vertices,
  faces, optional normals, uvs and vertex_colors), obj, ply and serialized
  files (utils/obj.py, ply.py, serialized.py), face_normals, shapegroup
  with instances (flattened into the prim soup per instance) and one
  sdfgrid a scene (render/sdf.py), with a look_at / scale / rotate /
  translate to_world;
* emitters: "area" and "directionalarea" on a shape; constant, envmap
  (a bitmap or a filename, scale, to_world), point, spot, directional and
  projector;
* sensors: perspective, thinlens, orthographic, radiancemeter,
  irradiancemeter (film 1x1 by default), distant, and batch (children
  perspective, thinlens or orthographic); samplers: independent,
  stratified, multijitter, orthogonal, sobol / ldsampler; film filters:
  box, gaussian, tent, mitchell, catmullrom, lanczos;
* integrators (a dict under "integrator" or under any key with an
  integrator type): path, direct, depth, aov, aov_normals, aov_position,
  aov_uv, moment, prb / prb_basic (rendered as path), volpath,
  volpathmis and prbvolpath (the volumetric tracer), ptracer and bdpt,
  with max_depth, rr_depth, hide_emitters and an optional compaction
  schedule ("compact");
* media: homogeneous and heterogeneous (a density array, or the
  gridvolume form {"grid", "to_world"}), with scale, sigma_t, albedo,
  radiance and a phase (isotropic, hg, rayleigh, sggx), as a
  shape's "interior" or named at the top level and referenced by name (a
  shape's "exterior" is not read, as in the JAX package);
* BSDFs: diffuse (RGB), conductor, roughconductor (GGX or Beckmann),
  plastic, roughplastic, principled, dielectric, thindielectric,
  roughdielectric, null, passthrough, twosided, blendbsdf, mask, and merl
  / measured_custom from a "table" array or a "filename";
* a diffuse reflectance textured by a bitmap (an array or a filename:
  EXR, PFM, NPY, or PNG / JPG through Pillow), checkerboard,
  mesh_attribute (the mesh's vertex_colors) or volume grid; normalmap and
  bumpmap wrappers (a bump map becomes a normal map at load);
* spectra: RGB, uniform, blackbody, d65, regular and irregular.

A type the JAX package does not know raises ValueError. A null material
makes a shadow copy of the geometry in which its prims are degenerate
(and, with clusters, its own cluster set), so shadow rays pass through
them. Scenes past BRUTE_FORCE_MAX_PRIMS primitives get use_bvh and the
skip-link BVH (render/bvh.py), as in the JAX loader, and the cluster
structure (ops/clusters.py) with intersector = "cluster"; past
clusters.MAX_PRIMS they trace on the BVH (intersector = "bvh", with the JAX
loader's warning). `load_dict(d, device="cuda")` runs
on the card unless the caller names another device (the tests name
"cpu"); without a card it raises. The host-side numpy helpers are copied
from the JAX package, not imported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.distr import DiscreteDistribution
from mitsuba_customization_tpu_torch.core.spectrum import (
    blackbody_rgb,
    d65_rgb,
    spectrum_to_rgb,
)
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.models import conductor as conductor_mod
from mitsuba_customization_tpu_torch.models import dielectric as dielectric_mod
from mitsuba_customization_tpu_torch.models import diffuse as diffuse_mod
from mitsuba_customization_tpu_torch.models import measured_custom as custom_mod
from mitsuba_customization_tpu_torch.models import merl as merl_mod
from mitsuba_customization_tpu_torch.models import passthrough as passthrough_mod
from mitsuba_customization_tpu_torch.models import phase as phase_mod
from mitsuba_customization_tpu_torch.models import plastic as plastic_mod
from mitsuba_customization_tpu_torch.models import principled as principled_mod
from mitsuba_customization_tpu_torch.models import roughconductor as rough_mod
from mitsuba_customization_tpu_torch.models import roughdielectric as roughdiel_mod
from mitsuba_customization_tpu_torch.models import roughplastic as roughplastic_mod
from mitsuba_customization_tpu_torch.models import texture as tex_mod
from mitsuba_customization_tpu_torch.models import thindielectric as thindiel_mod
from mitsuba_customization_tpu_torch.models.normalmap import bump_to_normal
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF
from mitsuba_customization_tpu_torch.ops import clusters as cl_mod
from mitsuba_customization_tpu_torch.render import bvh as bvh_mod
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.core.sampler import SAMPLERS
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import medium as medium_mod
from mitsuba_customization_tpu_torch.render import sdf as sdf_mod
from mitsuba_customization_tpu_torch.render import sensors as sensor_mod
from mitsuba_customization_tpu_torch.render.film import FILTER_NAMES
from mitsuba_customization_tpu_torch.utils.io import read_image
from mitsuba_customization_tpu_torch.utils import log
from mitsuba_customization_tpu_torch.utils.log import logger
from mitsuba_customization_tpu_torch.utils.obj import read_obj
from mitsuba_customization_tpu_torch.utils.ply import read_ply
from mitsuba_customization_tpu_torch.utils.serialized import read_serialized

BRUTE_FORCE_MAX_PRIMS = 64

# Default copper-ish conductor IOR (per-channel eta - i k).
_DEFAULT_ETA = (0.2004, 0.9240, 1.1022)
_DEFAULT_K = (3.9129, 2.4528, 2.1421)


@dataclasses.dataclass
class SceneConfig:
    """Static scene facts: the JAX SceneConfig's fields, in its order."""

    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 2
    rr_depth: int = 5
    integrator: str = "path"
    sampler: str = "independent"
    rfilter: str = "box"
    # the scene has the skip-link BVH (render/bvh.py): the loader builds it
    # past BRUTE_FORCE_MAX_PRIMS prims, as the JAX loader does
    use_bvh: bool = False
    # "brute" (all pairs), "cluster" (ops/clusters.py, K3 and K4) or "bvh"
    # (render/bvh.py, B1 and B2)
    intersector: str = "brute"
    hide_emitters: bool = False
    # radiance -> measurement: render multiplies the film by it (pi for an
    # irradiancemeter)
    sensor_scale: float = 1.0
    # False when the scene has no emitter at all: the integrator then
    # skips NEE sampling and shadow rays statically.
    nee: bool = True
    # Per-bounce wavefront-compaction fraction schedule (None = off):
    # entering bounce b keeps ceil(n * compact[min(b, len-1)]) lanes
    # (render/integrator._run_bounces_compact).
    compact: Optional[tuple] = None


@dataclasses.dataclass
class Scene:
    """A compiled scene: tensors on one device plus its static config."""

    geometry: geo.Geometry
    bsdfs: bsdf_mod.BSDFTable
    emitters: em_mod.EmitterTable
    sensor: sensor_mod.Sensor
    config: SceneConfig
    clusters: Optional[cl_mod.ClusterSet] = None
    # whether the prim soup holds cylinders (a host fact: without them the
    # cylinder tests, normals and uvs are not computed)
    has_cylinders: bool = False
    # with a null material: the geometry with its prims degenerate, and
    # (cluster intersector) its cluster set, for shadow rays
    shadow_geometry: Optional[geo.Geometry] = None
    shadow_clusters: Optional[cl_mod.ClusterSet] = None
    # the scene's one SDF grid shape (render/sdf.py), outside the prim soup
    sdf: Optional[sdf_mod.SDFGrid] = None
    # its participating media (render/medium.py; an empty table without)
    media: Optional[medium_mod.MediumTable] = None
    # the skip-link BVH over `geometry` (config.use_bvh), else None
    bvh: Optional[bvh_mod.BVH] = None

    @property
    def device(self):
        return self.geometry.p0.device

    def ray_intersect(self, ray):
        """Nearest hit -> SurfaceInteraction (K3 in cluster mode, B1 in bvh
        mode, else brute force)."""
        cyl = self.has_cylinders
        mode = self.config.intersector
        if mode == "cluster":
            t, prim, u, v, g = cl_mod.intersect(self.clusters, ray)
            si = geo.interaction_from_g(g, ray, t, prim, u, v, cyl)
        else:
            if mode == "bvh":
                t, prim, u, v = bvh_mod.intersect(self.bvh, self.geometry, ray, cyl)
            else:
                t, prim, u, v = geo.intersect_brute(self.geometry, ray, cyl)
            si = geo.compute_interaction(self.geometry, ray, t, prim, u, v, cyl)
        if self.sdf is not None:
            t_s, hit_s, p_l = sdf_mod.intersect(self.sdf, ray)
            si = sdf_mod.merge_interaction(si, sdf_mod.interaction(self.sdf, ray, t_s, hit_s,
                                                                   p_l))
        return si

    def ray_test(self, ray):
        """Shadow-ray occlusion (K4 in cluster mode, B2 in bvh mode, else
        brute force). Null-material prims never occlude: the shadow
        geometry and its cluster set, where the scene has them, hold them
        degenerate (B2 walks the tree built on `geometry` over the shadow
        geometry: a degenerate prim lies inside its old box)."""
        mode = self.config.intersector
        if mode == "cluster":
            cs = self.clusters if self.shadow_clusters is None else self.shadow_clusters
            occ = cl_mod.occluded(cs, ray)
        else:
            g = self.geometry if self.shadow_geometry is None else self.shadow_geometry
            if mode == "bvh":
                occ = bvh_mod.occluded(self.bvh, g, ray, self.has_cylinders)
            else:
                occ = geo.occluded_brute(g, ray, self.has_cylinders)
        if self.sdf is not None:
            t_s, hit_s, _ = sdf_mod.intersect(self.sdf, ray)
            occ = occ | (hit_s & (t_s < ray.maxt))
        return occ


# --------------------------------------------------------------------------
# Host-side helpers (numpy)
# --------------------------------------------------------------------------


def resolve_spectrum(val, default=(1.0, 1.0, 1.0)):
    """A spectrum declaration -> linear RGB (3,) float32: a scalar,
    [r, g, b], {"type": "rgb"/"uniform", "value": ...}, {"type":
    "blackbody", "temperature": K, "scale": s}, {"type": "d65", "scale":
    s}, or {"type": "regular"/"irregular", "wavelengths": [...] (or
    lambda_min / lambda_max), "values": [...], "scale": s}."""
    if isinstance(val, dict):
        t = val.get("type", "rgb")
        if t == "blackbody":
            return blackbody_rgb(float(val.get("temperature", 6504.0))) * np.float32(
                val.get("scale", 1.0))
        if t == "d65":
            return d65_rgb(float(val.get("scale", 1.0)))
        if t in ("regular", "irregular"):
            wl = val.get("wavelengths")
            if wl is None:
                wl = np.linspace(val.get("lambda_min", 360.0),
                                 val.get("lambda_max", 830.0), len(val["values"]))
            return spectrum_to_rgb(wl, val["values"]) * np.float32(val.get("scale", 1.0))
        if t not in ("rgb", "uniform"):
            raise ValueError(f"unsupported spectrum type '{t}'")
        val = val.get("value", default)
    arr = np.asarray(val, dtype=np.float32)
    return np.full(3, arr, np.float32) if arr.ndim == 0 else arr


def _as_transform(t):
    """A 4x4 array, or a dict {look_at(origin, target, up), scale,
    rotate(axis, angle), translate} composed in that order."""
    if t is None:
        return np.eye(4, dtype=np.float32)
    if not isinstance(t, dict):
        return np.asarray(t, dtype=np.float32)
    unknown = set(t) - {"look_at", "scale", "rotate", "translate"}
    if unknown:
        raise NotImplementedError(f"to_world keys {sorted(unknown)} are not ported")
    mat = np.eye(4)
    if "look_at" in t:
        la = t["look_at"]
        mat = sensor_mod.look_at(la["origin"], la["target"],
                                 la.get("up", [0, 1, 0])).astype(np.float64)
    if "scale" in t:
        s = np.asarray(t["scale"], dtype=np.float64)
        s = np.full(3, s) if s.ndim == 0 else s
        m_ = np.eye(4)
        m_[:3, :3] = np.diag(s)
        mat = m_ @ mat
    if "rotate" in t:
        axis = np.asarray(t["rotate"]["axis"], dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        ang = np.deg2rad(t["rotate"]["angle"])
        c, s_ = np.cos(ang), np.sin(ang)
        x, y, z = axis
        r = np.array(
            [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s_, x * z * (1 - c) + y * s_],
                [y * x * (1 - c) + z * s_, c + y * y * (1 - c), y * z * (1 - c) - x * s_],
                [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_, c + z * z * (1 - c)],
            ]
        )
        m_ = np.eye(4)
        m_[:3, :3] = r
        mat = m_ @ mat
    if "translate" in t:
        m_ = np.eye(4)
        m_[:3, 3] = np.asarray(t["translate"], dtype=np.float64)
        mat = m_ @ mat
    return mat.astype(np.float32)


def _apply_transform(mat, pts):
    return pts @ mat[:3, :3].T + mat[:3, 3]


def _apply_normal_transform(mat, normals):
    inv_t = np.linalg.inv(mat[:3, :3]).T
    n = normals @ inv_t.T
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-12)


class _GeomBuilder:
    """Accumulates per-primitive rows (numpy) for the Geometry soup."""

    def __init__(self):
        self.rows = {k: [] for k in geo.Geometry._fields}
        self.count = 0

    def _push(self, n, **fields):
        for k in geo.Geometry._fields:
            self.rows[k].append(fields[k])
        self.count += n

    def add_sphere(self, center, radius, mat_id, emitter_id, shape_id):
        z3 = np.zeros((1, 3), np.float32)
        z2 = np.zeros((1, 2), np.float32)
        self._push(
            1,
            prim_type=np.asarray([geo.SPHERE], np.int32),
            p0=np.asarray(center, np.float32)[None],
            e1=np.asarray([[radius, 0, 0]], np.float32),
            e2=z3, vn0=z3, vn1=z3, vn2=z3, uv0=z2, uv1=z2, uv2=z2,
            mat_id=np.asarray([mat_id], np.int32),
            emitter_id=np.asarray([emitter_id], np.int32),
            shape_id=np.asarray([shape_id], np.int32),
        )

    def add_cylinder(self, p0, p1, radius, mat_id, emitter_id, shape_id):
        z3 = np.zeros((1, 3), np.float32)
        z2 = np.zeros((1, 2), np.float32)
        p0 = np.asarray(p0, np.float32)
        self._push(
            1,
            prim_type=np.asarray([geo.CYLINDER], np.int32),
            p0=p0[None], e1=(np.asarray(p1, np.float32) - p0)[None],
            e2=np.asarray([[radius, 0.0, 0.0]], np.float32),
            vn0=z3, vn1=z3, vn2=z3, uv0=z2, uv1=z2, uv2=z2,
            mat_id=np.asarray([mat_id], np.int32),
            emitter_id=np.asarray([emitter_id], np.int32),
            shape_id=np.asarray([shape_id], np.int32),
        )

    def add_mesh(self, v, f, n, uv, mat_id, emitter_id, shape_id, flat=False):
        """Triangles with vertex normals n, or area-weighted ones when n is
        None (the JAX package's fallback), and uvs (zeros when None).
        flat (mitsuba's face_normals): every corner takes its face's
        geometric normal."""
        v = np.asarray(v, np.float32)
        f = np.asarray(f, np.int64)
        if flat:
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            fn = (fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
                  ).astype(np.float32)
            if uv is None:
                uv = np.zeros((len(v), 2), np.float32)
            p0 = v[f[:, 0]]
            cnt = len(f)
            self._push(
                cnt,
                prim_type=np.full(cnt, geo.TRI, np.int32),
                p0=p0, e1=v[f[:, 1]] - p0, e2=v[f[:, 2]] - p0, vn0=fn, vn1=fn, vn2=fn,
                uv0=uv[f[:, 0]], uv1=uv[f[:, 1]], uv2=uv[f[:, 2]],
                mat_id=np.full(cnt, mat_id, np.int32),
                emitter_id=np.full(cnt, emitter_id, np.int32),
                shape_id=np.full(cnt, shape_id, np.int32),
            )
            return
        if n is None:
            n = np.zeros_like(v)
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            for k in range(3):
                np.add.at(n, f[:, k], fn)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        if uv is None:
            uv = np.zeros((len(v), 2), np.float32)
        p0 = v[f[:, 0]]
        cnt = len(f)
        self._push(
            cnt,
            prim_type=np.full(cnt, geo.TRI, np.int32),
            p0=p0, e1=v[f[:, 1]] - p0, e2=v[f[:, 2]] - p0,
            vn0=n[f[:, 0]], vn1=n[f[:, 1]], vn2=n[f[:, 2]],
            uv0=uv[f[:, 0]], uv1=uv[f[:, 1]], uv2=uv[f[:, 2]],
            mat_id=np.full(cnt, mat_id, np.int32),
            emitter_id=np.full(cnt, emitter_id, np.int32),
            shape_id=np.full(cnt, shape_id, np.int32),
        )

    def arrays(self):
        if self.count == 0:
            raise ValueError("scene has no shapes")
        return {k: np.concatenate(v, axis=0) for k, v in self.rows.items()}


def _unit_rectangle():
    """[-1,1]^2 quad in the xy-plane facing +z (mitsuba3 rectangle.cpp)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    return v, f, uv


def _unit_cube():
    """[-1,1]^3 cube, outward normals (mitsuba3 cube.cpp)."""
    verts, faces = [], []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            base = len(verts)
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = [0.0, 0.0, 0.0]
                p[axis] = sgn
                p[u_ax] = du * sgn
                p[v_ax] = dv
                verts.append(p)
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)


def _unit_disk(segments=32):
    """Unit disk in the xy-plane facing +z (mitsuba3 disk.cpp)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
    f = np.asarray([[0, 1 + i, 1 + (i + 1) % segments] for i in range(segments)],
                   dtype=np.int32)
    return v, f


def geometry_from_numpy(arrays, device):
    """Geometry from numpy fields (int fields become int64)."""
    def conv(a):
        a = np.asarray(a)
        dt = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
        return torch.tensor(a, dtype=dt, device=device)

    return geo.Geometry(**{k: conv(arrays[k]) for k in geo.Geometry._fields})


# --------------------------------------------------------------------------
# load_dict
# --------------------------------------------------------------------------

_SHAPE_TYPES = {"sphere", "cylinder", "rectangle", "cube", "disk", "mesh", "obj", "ply",
                "serialized"}
# the types a batch sensor's children may have (the JAX loader's)
_BATCH_CHILDREN = ("perspective", "thinlens", "orthographic")
_BSDF_TYPES = {
    "diffuse", "conductor", "roughconductor", "dielectric", "thindielectric",
    "roughdielectric", "merl", "measured_custom", "twosided", "null",
    "plastic", "roughplastic", "blendbsdf", "mask", "passthrough",
    "normalmap", "bumpmap", "principled",
}
# the JAX package's integrator names; prb and prb_basic render as path,
# volpathmis and prbvolpath as volpath
INTEGRATOR_TYPES = frozenset([
    "path", "direct", "depth", "aov", "aov_normals", "aov_position", "aov_uv",
    "moment", "prb", "prb_basic", "volpath", "volpathmis", "prbvolpath", "ptracer",
    "bdpt",
])
_MEDIUM_TYPES = ("homogeneous", "heterogeneous")
_PHASE_TYPES = {"isotropic": phase_mod.ISOTROPIC, "hg": phase_mod.HG,
                "rayleigh": phase_mod.RAYLEIGH, "sggx": phase_mod.SGGX}
_TEXTURE_TYPES = ("bitmap", "checkerboard", "mesh_attribute", "volume")


def _bitmap(spec):
    """The image of a dict with a "bitmap" array or a "filename" (read by
    utils/io.read_image), else None."""
    img = spec.get("bitmap")
    if img is None and "filename" in spec:
        img = read_image(spec["filename"])
    return img


def _image(spec, key):
    """spec[key]: an array, or a dict that _bitmap reads."""
    img = spec.get(key)
    return _bitmap(img) if isinstance(img, dict) else img


def compile_texture_row(spec) -> dict:
    """A texture dict -> a models/texture.build_stack row (the JAX
    loader's compile_texture_row)."""
    ttype = spec.get("type")
    if ttype == "checkerboard":
        def c3(key, default):
            val = spec.get(key, default)
            if isinstance(val, dict):
                val = val.get("value", default)
            val = np.asarray(val, np.float32)
            return np.full(3, val, np.float32) if val.ndim == 0 else val

        return dict(type=tex_mod.CHECKERBOARD, value0=c3("color0", [0.4] * 3),
                    value1=c3("color1", [0.2] * 3),
                    uv_scale=spec.get("uv_scale", (1.0, 1.0)), image=None)
    if ttype == "bitmap":
        return dict(type=tex_mod.BITMAP, uv_scale=spec.get("uv_scale", (1.0, 1.0)),
                    image=np.asarray(_bitmap(spec), np.float32))
    if ttype == "volume":
        # a (D, H, W) or (D, H, W, 3) grid over the unit cube that
        # `to_world` places in the scene
        grid = spec.get("grid", spec.get("volume"))
        if grid is None:
            raise ValueError("volume texture needs a 'grid'")
        return dict(type=tex_mod.VOLUME,
                    value0=np.full(3, np.asarray(spec.get("scale", 1.0), np.float32)),
                    value1=np.asarray(spec.get("fill", [0.0, 0.0, 0.0]), np.float32),
                    image=None, volume=np.asarray(grid, np.float32),
                    vol_to_world=_as_transform(spec.get("to_world")))
    if ttype == "mesh_attribute":
        # the mesh's "vertex_colors", interpolated; `scale` multiplies
        sc = np.asarray(spec.get("scale", 1.0), np.float32)
        return dict(type=tex_mod.MESH_ATTRIBUTE,
                    value0=np.full(3, sc) if sc.ndim == 0 else sc, image=None)
    raise ValueError(f"unsupported texture type '{ttype}'")


def compile_medium_row(md) -> dict:
    """A medium dict -> a medium.build_table row (the JAX loader's
    compile_medium): sigma_t scaled by `scale`; a spectrum is a number,
    an RGB triple or a dict with a "value"; an SGGX phase takes "S" (the
    six entries [xx, yy, zz, xy, xz, yz]) or a diagonal "sigma" (S =
    diag(sigma^2)); a heterogeneous medium's density is an array placed by
    the medium's to_world, or {"grid", "to_world"}."""
    mtype = md.get("type", "homogeneous")
    if mtype not in _MEDIUM_TYPES:
        raise ValueError(f"unsupported medium type '{mtype}'")
    phase = md.get("phase", {"type": "isotropic"})
    ptype = _PHASE_TYPES[phase.get("type", "isotropic")]
    scale = float(md.get("scale", 1.0))

    def rgb3(key, default):
        val = md.get(key, default)
        if isinstance(val, dict):
            val = val.get("value", default)
        val = np.asarray(val, dtype=np.float32)
        return np.full(3, val, np.float32) if val.ndim == 0 else val

    phase_S = None
    if ptype == phase_mod.SGGX:
        if "S" in phase:
            phase_S = np.asarray(phase["S"], np.float32)
        else:
            sig = np.asarray(phase.get("sigma", [1.0, 1.0, 1.0]), np.float32)
            phase_S = np.asarray([sig[0] ** 2, sig[1] ** 2, sig[2] ** 2, 0, 0, 0], np.float32)
    # as the JAX loader reads it: an "emission" key alone makes the medium
    # emissive with the "radiance" value, zero (ROADMAP section 3)
    emission = None
    if "radiance" in md or "emission" in md:
        emission = rgb3("radiance", [0.0, 0.0, 0.0])
    row = dict(type=mtype, sigma_t=rgb3("sigma_t", [1.0, 1.0, 1.0]) * scale,
               albedo=rgb3("albedo", [0.75, 0.75, 0.75]), phase_type=ptype,
               phase_g=float(phase.get("g", 0.0)), phase_S=phase_S, density=None,
               to_world=None, emission=emission)
    if mtype == "heterogeneous":
        dens = md.get("density")
        if isinstance(dens, dict):  # the gridvolume form
            row["to_world"] = _as_transform(dens.get("to_world"))
            dens = dens.get("grid")
        else:
            row["to_world"] = _as_transform(md.get("to_world"))
        if dens is None:
            raise ValueError("heterogeneous medium needs a density grid")
        row["density"] = np.asarray(dens, dtype=np.float32)
    return row


def _bsdf_child(bd, key="bsdf"):
    """The child BSDF of a wrapper: bd[key], else its first dict entry with
    a BSDF type."""
    return bd.get(key) or next(
        v for v in bd.values() if isinstance(v, dict) and v.get("type") in _BSDF_TYPES)


_EMITTER_TYPES = ("constant", "envmap", "point", "spot", "directional", "projector")


def _add_emitter(t, val, em_rows, env, proj, const_row):
    """Append the emitter row of a top-level emitter dict of type t (the
    JAX loader's fields, in its units); the envmap and projector images
    go into `env` / `proj`. Returns the constant emitter's row."""
    row = dict(type={"constant": em_mod.CONSTANT, "envmap": em_mod.ENVMAP,
                     "point": em_mod.POINT, "spot": em_mod.SPOT,
                     "directional": em_mod.DIRECTIONAL,
                     "projector": em_mod.PROJECTOR}[t])
    if t == "constant":
        row["radiance"] = resolve_spectrum(val.get("radiance", [1, 1, 1]))
        const_row = len(em_rows)
    elif t == "envmap":
        env.update(image=np.asarray(_bitmap(val), np.float32), row=len(em_rows),
                   to_world=_as_transform(val.get("to_world"))[:3, :3])
        row["radiance"] = [float(val.get("scale", 1.0))] * 3
    elif t == "point":
        row.update(radiance=resolve_spectrum(val.get("intensity", [1, 1, 1])),
                   position=val.get("position", [0, 0, 0]))
    elif t == "directional":
        row.update(radiance=val.get("irradiance", [1, 1, 1]),
                   direction=val.get("direction", [0, 0, -1]))
    elif t == "spot":
        to_w = _as_transform(val.get("to_world"))
        row.update(radiance=val.get("intensity", [1, 1, 1]), position=to_w[:3, 3],
                   direction=to_w[:3, 2], cutoff=float(val.get("cutoff_angle", 20.0)),
                   beam=float(val.get("beam_width", 15.0)))
    else:  # projector
        img = _bitmap(val)
        if img is None:
            img = np.ones((1, 1, 3), np.float32)
        to_w = _as_transform(val.get("to_world"))
        proj.update(image=np.asarray(img, np.float32), row=len(em_rows),
                    frame=to_w[:3, :3].astype(np.float32),  # right / up / forward
                    tan=float(np.tan(np.deg2rad(float(val.get("fov", 45.0)) / 2.0))))
        row.update(radiance=resolve_spectrum(val.get("scale", val.get("irradiance", 1.0))),
                   position=to_w[:3, 3], direction=to_w[:3, 2])
    em_rows.append(row)
    return const_row


def load_dict(d: dict, device="cuda") -> Scene:
    """Compile a mi.load_dict-style nested dict into a Scene on `device`
    (the card unless the caller names another). The span scene.load holds
    it, with scene.bvh_build and scene.cluster_build inside."""
    with log.span("scene.load"):
        return _load_dict(d, device)


def _load_dict(d: dict, device) -> Scene:
    if d.get("type") != "scene":
        raise ValueError("root dict must have type='scene'")
    device = torch.device(device)
    cfg = SceneConfig()
    mat_types: list[int] = []
    mat_slots: list[int] = []
    stacks: dict[int, list] = {}
    tab_tables: list[np.ndarray] = []
    blend_entries: dict[int, tuple] = {}  # mat id -> (child_a, child_b, w)
    texture_rows: list[dict] = []  # textured-diffuse bindings
    normal_rows: list[dict] = []  # normal-map textures
    normal_bindings: dict[int, int] = {}  # mat id -> normal_rows index
    named_bsdfs: dict[str, int] = {}
    em_rows: list[dict] = []
    emissive_prim_ranges: list[tuple] = []  # (emitter_id, prim_start, prim_end)
    attr_spans: list[tuple] = []  # (prim_start, (F, 9) corner colors) a mesh
    env = dict(image=None, to_world=np.eye(3, dtype=np.float32), row=-1)
    proj = dict(image=None, frame=np.eye(3, dtype=np.float32), tan=1.0, row=-1)
    const_row = -1
    media_rows: list[dict] = []
    named_media: dict[str, int] = {}
    shape_interior: list[int] = []  # per shape id: its medium, or -1

    def compile_medium(md) -> int:
        """A medium dict, or the name of a top-level one, -> its id."""
        if isinstance(md, str):
            if md not in named_media:
                raise ValueError(f"unknown medium reference '{md}'")
            return named_media[md]
        media_rows.append(compile_medium_row(md))
        return len(media_rows) - 1

    def add_material(kid, params):
        stacks.setdefault(kid, []).append(params)
        mat_types.append(kid)
        mat_slots.append(len(stacks[kid]) - 1)
        return len(mat_types) - 1

    def compile_bsdf(bd) -> int:
        if isinstance(bd, str):
            if bd not in named_bsdfs:
                raise ValueError(f"unknown bsdf reference '{bd}'")
            return named_bsdfs[bd]
        btype = bd.get("type", "diffuse")

        def rgb(key, default):
            val = bd.get(key, default)
            if isinstance(val, dict) and val.get("type") in _TEXTURE_TYPES:
                # the JAX loader takes the field's default here (it reads
                # only a dict's "value"): textures reach diffuse only
                raise NotImplementedError(
                    f"a '{val['type']}' texture in '{btype}.{key}': only a diffuse "
                    "reflectance can be textured")
            return resolve_spectrum(val, default)

        def ior():
            return np.float32(float(bd.get("int_ior", 1.5046))
                              / float(bd.get("ext_ior", 1.000277)))

        if btype == "twosided":
            return compile_bsdf(_bsdf_child(bd))
        if btype in ("normalmap", "bumpmap"):
            # frame-perturbing wrappers: the child's material gets a normal
            # texture (models/normalmap.py)
            mid = compile_bsdf(_bsdf_child(bd))
            if btype == "normalmap":
                img = _image(bd, "normalmap")
            else:
                hm = bd.get("bumpmap")
                img = bump_to_normal(_image(bd, "texture" if hm is None else "bumpmap"),
                                     scale=float(bd.get("scale", 1.0)))
            normal_rows.append(dict(type=tex_mod.BITMAP, image=np.asarray(img, np.float32),
                                    uv_scale=bd.get("uv_scale", (1.0, 1.0))))
            normal_bindings[mid] = len(normal_rows) - 1
            return mid
        if btype in ("blendbsdf", "mask"):
            if btype == "blendbsdf":
                kids = [v for v in bd.values()
                        if isinstance(v, dict) and v.get("type") in _BSDF_TYPES]
                if len(kids) != 2:
                    raise ValueError("blendbsdf needs exactly two child bsdfs")
                child_a, child_b = compile_bsdf(kids[0]), compile_bsdf(kids[1])
                wmix = float(bd.get("weight", 0.5))
            else:  # mask: transparent with probability 1 - opacity
                child_b = compile_bsdf(_bsdf_child(bd))
                op = bd.get("opacity", 0.5)
                if isinstance(op, dict):
                    op = op.get("value", 0.5)
                wmix = float(np.asarray(op, np.float32).mean())
                child_a = compile_bsdf({"type": "passthrough"})
            if child_a in blend_entries or child_b in blend_entries:
                raise ValueError("nested blends are not supported")
            mat_types.append(bsdf_mod.BLEND)
            mat_slots.append(0)
            blend_entries[len(mat_types) - 1] = (child_a, child_b, wmix)
            return len(mat_types) - 1
        if btype == "null":
            mat_types.append(bsdf_mod.NULL)
            mat_slots.append(0)
            return len(mat_types) - 1
        if btype in ("merl", "measured_custom"):
            if "table" in bd:
                table = np.asarray(bd["table"], dtype=np.float32)
            elif btype == "merl":
                table = merl_mod.read_merl(bd["filename"])
            else:
                table = custom_mod.read_custom(bd["filename"])
            if tab_tables and tab_tables[0].shape != table.shape:
                raise ValueError(
                    "all tabulated BRDFs in one scene must share a "
                    f"resolution; got {table.shape} vs {tab_tables[0].shape}"
                )
            tab_tables.append(table)
            mat_types.append(bsdf_mod.TABULATED)
            mat_slots.append(len(tab_tables) - 1)
            return len(mat_types) - 1
        if btype == "passthrough":
            return add_material(bsdf_mod.PASSTHROUGH, passthrough_mod.PassthroughParams(
                transmittance=rgb("transmittance", [1.0, 1.0, 1.0])))
        if btype == "diffuse":
            refl = bd.get("reflectance")
            if isinstance(refl, dict) and refl.get("type") in _TEXTURE_TYPES:
                texture_rows.append(compile_texture_row(refl))
                mat_types.append(bsdf_mod.TEXTURED_DIFFUSE)
                mat_slots.append(len(texture_rows) - 1)
                return len(mat_types) - 1
            return add_material(bsdf_mod.DIFFUSE, diffuse_mod.DiffuseParams(
                reflectance=rgb("reflectance", [0.5, 0.5, 0.5])))
        if btype == "conductor":
            return add_material(bsdf_mod.CONDUCTOR, conductor_mod.ConductorParams(
                eta=rgb("eta", _DEFAULT_ETA), k=rgb("k", _DEFAULT_K),
                specular_reflectance=rgb("specular_reflectance", [1, 1, 1])))
        if btype == "roughconductor":
            dist = bd.get("distribution", "ggx")
            if dist not in ("ggx", "beckmann"):
                raise ValueError(f"unsupported microfacet distribution '{dist}'")
            alpha = float(bd.get("alpha", 0.1))
            return add_material(
                bsdf_mod.ROUGHCONDUCTOR if dist == "ggx"
                else bsdf_mod.ROUGHCONDUCTOR_BECKMANN,
                rough_mod.RoughConductorParams(
                    alpha_u=np.float32(bd.get("alpha_u", alpha)),
                    alpha_v=np.float32(bd.get("alpha_v", alpha)),
                    eta=rgb("eta", _DEFAULT_ETA), k=rgb("k", _DEFAULT_K),
                    specular_reflectance=rgb("specular_reflectance", [1, 1, 1])))
        if btype in ("plastic", "roughplastic"):
            eta = np.float32(float(bd.get("int_ior", 1.49))
                             / float(bd.get("ext_ior", 1.000277)))
            common = dict(
                diffuse_reflectance=rgb("diffuse_reflectance", [0.5, 0.5, 0.5]),
                specular_reflectance=rgb("specular_reflectance", [1, 1, 1]), eta=eta)
            if btype == "plastic":
                return add_material(bsdf_mod.PLASTIC, plastic_mod.PlasticParams(**common))
            return add_material(bsdf_mod.ROUGHPLASTIC, roughplastic_mod.RoughPlasticParams(
                alpha=np.float32(bd.get("alpha", 0.1)), **common))
        if btype == "principled":
            defaults = dict(roughness=0.5, anisotropic=0.0, metallic=0.0, spec_tint=0.0,
                            specular=0.5, sheen=0.0, sheen_tint=0.0, clearcoat=0.0,
                            clearcoat_gloss=0.0, flatness=0.0)
            return add_material(bsdf_mod.PRINCIPLED, principled_mod.PrincipledParams(
                base_color=rgb("base_color", [0.5, 0.5, 0.5]),
                **{k: np.float32(bd.get(k, v)) for k, v in defaults.items()}))
        if btype in ("dielectric", "thindielectric"):
            mod = dielectric_mod.DielectricParams if btype == "dielectric" \
                else thindiel_mod.ThinDielectricParams
            return add_material(
                bsdf_mod.DIELECTRIC if btype == "dielectric" else bsdf_mod.THINDIELECTRIC,
                mod(eta=ior(), specular_reflectance=rgb("specular_reflectance", [1, 1, 1]),
                    specular_transmittance=rgb("specular_transmittance", [1, 1, 1])))
        if btype == "roughdielectric":
            return add_material(bsdf_mod.ROUGHDIELECTRIC, roughdiel_mod.RoughDielectricParams(
                eta=ior(), alpha=np.float32(bd.get("alpha", 0.1)),
                specular_reflectance=rgb("specular_reflectance", [1, 1, 1]),
                specular_transmittance=rgb("specular_transmittance", [1, 1, 1])))
        raise ValueError(f"unsupported bsdf type '{btype}'")

    gb = _GeomBuilder()
    sensor = None
    sdf_shape = None
    shape_count = 0
    shapegroups: dict[str, dict] = {}

    def add_shape(val, extra_to_w=None):
        """One shape dict into prims, pre-transformed by an instance's
        to_world when given."""
        nonlocal shape_count
        t = val.get("type")
        if t not in _SHAPE_TYPES:
            raise ValueError(f"unsupported shape '{t}'")
        mat_id = compile_bsdf(val.get("bsdf", {"type": "diffuse"}))
        emitter_id = -1
        if "emitter" in val:
            espec = val["emitter"]
            if espec.get("type") not in ("area", "directionalarea"):
                raise ValueError("shape emitters must be 'area' or 'directionalarea'")
            em_rows.append(dict(
                type=em_mod.AREA if espec["type"] == "area" else em_mod.DIRECTIONALAREA,
                radiance=resolve_spectrum(espec.get("radiance", [1, 1, 1])),
            ))
            emitter_id = len(em_rows) - 1
        prim_start = gb.count
        to_w = _as_transform(val.get("to_world"))
        if extra_to_w is not None:
            to_w = np.asarray(extra_to_w, np.float64) @ to_w
        if t == "sphere":
            center = _apply_transform(
                to_w, np.asarray(val.get("center", [0, 0, 0]), np.float64)
            )
            scale = np.cbrt(abs(np.linalg.det(to_w[:3, :3])))
            gb.add_sphere(center, float(val.get("radius", 1.0)) * scale,
                          mat_id, emitter_id, shape_count)
        elif t == "cylinder":
            p0 = _apply_transform(to_w, np.asarray(val.get("p0", [0, 0, 0]), np.float64))
            p1 = _apply_transform(to_w, np.asarray(val.get("p1", [0, 0, 1]), np.float64))
            # the radius scales with the transform's mean stretch
            scale = np.cbrt(abs(np.linalg.det(to_w[:3, :3])))
            gb.add_cylinder(p0, p1, float(val.get("radius", 1.0)) * scale,
                            mat_id, emitter_id, shape_count)
        else:
            n = uv = None
            if t == "obj":
                v, f, n, uv = read_obj(val["filename"])
            elif t == "ply":
                v, f, n, uv = read_ply(val["filename"])
            elif t == "serialized":
                v, f, n, uv = read_serialized(val["filename"], int(val.get("shape_index", 0)))
            elif t == "cube":
                v, f = _unit_cube()
            elif t == "disk":
                v, f = _unit_disk()
            elif t == "mesh":
                v = np.asarray(val["vertices"], np.float32)
                f = np.asarray(val["faces"], np.int32)
                n, uv = val.get("normals"), val.get("uvs")
                n = None if n is None else np.asarray(n, np.float32)
                uv = None if uv is None else np.asarray(uv, np.float32)
                vc = val.get("vertex_colors")
                if vc is not None:
                    # per-prim corner rows for mesh_attribute textures
                    attr_spans.append(
                        (gb.count, np.asarray(vc, np.float32)[f].reshape(len(f), 9)))
            else:  # rectangle
                v, f, uv = _unit_rectangle()
            v = _apply_transform(to_w, v.astype(np.float64)).astype(np.float32)
            if n is not None:
                n = _apply_normal_transform(to_w, n)
            gb.add_mesh(v, f, n, uv, mat_id, emitter_id, shape_count,
                        flat=bool(val.get("face_normals", False)))
        if emitter_id >= 0:
            emissive_prim_ranges.append((emitter_id, prim_start, gb.count))
            if em_rows[emitter_id]["type"] == em_mod.DIRECTIONALAREA:
                # the collimation direction: the mean authored prim normal
                rows = {k: np.concatenate(gb.rows[k])[prim_start:gb.count]
                        for k in ("e1", "e2", "prim_type")}
                if (rows["prim_type"] != geo.TRI).any():
                    raise ValueError("directionalarea requires a triangle-mesh shape")
                nrm = np.cross(rows["e1"], rows["e2"]).mean(0)
                em_rows[emitter_id]["direction"] = nrm / max(np.linalg.norm(nrm), 1e-12)
        # the medium inside the shape (mitsuba3's <medium name="interior">)
        shape_interior.append(compile_medium(val["interior"]) if "interior" in val else -1)
        shape_count += 1

    # Pass 1: named top-level BSDFs and media (so shapes can reference them).
    for key, val in d.items():
        if key != "type" and isinstance(val, dict):
            if val.get("type") in _BSDF_TYPES:
                named_bsdfs[key] = compile_bsdf(val)
            elif val.get("type") in _MEDIUM_TYPES:
                named_media[key] = compile_medium(val)

    # Pass 2: everything else.
    for key, val in d.items():
        if key == "type" or not isinstance(val, dict):
            continue
        t = val.get("type")
        if t in _BSDF_TYPES or t in _MEDIUM_TYPES:
            continue
        if key == "integrator" or t in INTEGRATOR_TYPES:
            itype = val.get("type", "path")
            if itype not in INTEGRATOR_TYPES:
                raise ValueError(f"integrator type '{itype}' is not implemented "
                                 f"(available: {sorted(INTEGRATOR_TYPES)})")
            cfg.integrator = itype
            cfg.max_depth = int(val.get("max_depth", cfg.max_depth))
            cfg.rr_depth = int(val.get("rr_depth", cfg.rr_depth))
            cfg.hide_emitters = bool(val.get("hide_emitters", False))
            if val.get("compact") is not None:
                cfg.compact = tuple(float(f) for f in val["compact"])
            continue
        if t == "batch" or t in sensor_mod.SENSOR_TYPES:
            sensor = _load_sensor(t, val, cfg, device)
            continue
        if t in _EMITTER_TYPES:
            const_row = _add_emitter(t, val, em_rows, env, proj, const_row)
            continue
        if t == "shapegroup":
            # collected here, flattened into the prim soup per instance
            shapegroups[key] = val
            continue
        if t == "instance":
            gref = val.get("shapegroup", val.get("ref"))
            if isinstance(gref, dict):
                gref = gref.get("id")
            if gref not in shapegroups:
                raise ValueError(f"instance '{key}' references unknown shapegroup '{gref}'")
            inst_w = _as_transform(val.get("to_world"))
            for cval in shapegroups[gref].values():
                if isinstance(cval, dict):
                    add_shape(cval, extra_to_w=inst_w)
            continue
        if t == "sdfgrid":
            # one grid a scene: its own acceleration structure, not in the soup
            if sdf_shape is not None:
                raise ValueError("only one sdfgrid per scene supported")
            sdf_shape = sdf_mod.make(
                np.asarray(val["grid"], np.float32), _as_transform(val.get("to_world")),
                compile_bsdf(val.get("bsdf", {"type": "diffuse"})), shape_count,
                device=device)
            shape_interior.append(-1)
            shape_count += 1
            continue
        if t in _SHAPE_TYPES:
            add_shape(val)
            continue
        raise ValueError(f"scene entry '{key}' has an unsupported type '{t}'")

    arrays = gb.arrays()
    geometry = geometry_from_numpy(arrays, device)
    cfg.use_bvh = gb.count > BRUTE_FORCE_MAX_PRIMS
    tree = None
    if cfg.use_bvh:
        with log.span("scene.bvh_build"):
            tree = bvh_mod.build(geo.Geometry(**arrays), device)
    clusters = None
    if cfg.use_bvh and gb.count <= cl_mod.MAX_PRIMS:
        cfg.intersector = "cluster"
        with log.span("scene.cluster_build"):
            clusters = cl_mod.build(geo.Geometry(**arrays), device)
    elif cfg.use_bvh:
        cfg.intersector = "bvh"
        logger.warning(
            f"scene has {gb.count} primitives, past the cluster intersector's capacity "
            f"contract ({cl_mod.MAX_PRIMS}); tracing it on the skip-link BVH")
    # the shadow copy: null-material prims degenerate, so that shadow rays
    # pass through them
    shadow_geometry = shadow_clusters = None
    mat_np = np.asarray(mat_types, np.int64)
    if (mat_np == bsdf_mod.NULL).any():
        keep = (mat_np[arrays["mat_id"]] != bsdf_mod.NULL)[:, None]
        shadow = dict(arrays, e1=np.where(keep, arrays["e1"], 0.0).astype(np.float32),
                      e2=np.where(keep, arrays["e2"], 0.0).astype(np.float32))
        shadow_geometry = geometry_from_numpy(shadow, device)
        if clusters is not None:
            with log.span("scene.cluster_build"):
                shadow_clusters = cl_mod.build(geo.Geometry(**shadow), device)
    pack_bvh(cfg, tree, geometry, shadow_geometry)

    def stack_params(plist):
        return type(plist[0])(*(
            torch.as_tensor(np.stack(f), device=device) for f in zip(*plist)
        ))

    kernel_stacks = {kid: stack_params(plist) for kid, plist in stacks.items()}
    if tab_tables:
        kernel_stacks[bsdf_mod.TABULATED] = TabulatedBRDF.build_stack(
            torch.as_tensor(np.stack(tab_tables), device=device)
        )
    if texture_rows:
        attr_np = None
        if attr_spans:
            attr_np = np.zeros((max(gb.count, 1), 9), np.float32)
            for a_start, rows9 in attr_spans:
                attr_np[a_start:a_start + len(rows9)] = rows9
        elif any(r["type"] == tex_mod.MESH_ATTRIBUTE for r in texture_rows):
            raise ValueError("mesh_attribute texture needs a mesh shape declaring "
                             "'vertex_colors'")
        kernel_stacks[bsdf_mod.TEXTURED_DIFFUSE] = tex_mod.build_stack(
            texture_rows, attr_np, device=device)
    if not mat_types:
        mat_types, mat_slots = [bsdf_mod.DIFFUSE], [0]
    blend = {}
    if blend_entries:
        n_mat = len(mat_types)
        b_a, b_b = np.arange(n_mat), np.arange(n_mat)
        b_w = np.zeros(n_mat, np.float32)
        for mid, (ca, cb, wmix) in blend_entries.items():
            b_a[mid], b_b[mid], b_w[mid] = ca, cb, wmix
        blend = dict(blend_a=torch.as_tensor(b_a, device=device),
                     blend_b=torch.as_tensor(b_b, device=device),
                     blend_w=torch.as_tensor(b_w, device=device))
    normal = {}
    if normal_rows:
        nm_slot = np.full(len(mat_types), -1, np.int64)
        for mid, row in normal_bindings.items():
            nm_slot[mid] = row
        normal = dict(normal_tex=tex_mod.build_stack(normal_rows, device=device),
                      nm_slot=torch.as_tensor(nm_slot, device=device))
    bsdfs = bsdf_mod.BSDFTable(
        mat_type=torch.as_tensor(mat_types, dtype=torch.int64, device=device),
        mat_slot=torch.as_tensor(mat_slots, dtype=torch.int64, device=device),
        stacks=kernel_stacks, **blend, **normal,
    )
    cfg.nee = len(em_rows) > 0
    if cfg.integrator == "ptracer":
        # light paths start on area, point and spot emitters only
        from mitsuba_customization_tpu_torch.render.ptracer import SUPPORTED_EMITTERS

        bad = {r["type"] for r in em_rows} - set(SUPPORTED_EMITTERS)
        if bad:
            names = {0: "area", 1: "constant", 2: "envmap", 3: "point", 4: "spot",
                     5: "directional"}
            raise ValueError("ptracer supports area/point/spot emitters; scene has "
                             + ", ".join(sorted(names.get(b, str(b)) for b in bad)))
    if sensor is None:
        sensor = sensor_mod.make_sensor(device=device)
    return Scene(
        geometry=geometry,
        bsdfs=bsdfs,
        emitters=_build_emitter_table(em_rows, emissive_prim_ranges, arrays,
                                      const_row, env, proj, device),
        sensor=sensor,
        config=cfg,
        clusters=clusters,
        has_cylinders=bool((arrays["prim_type"] == geo.CYLINDER).any()),
        shadow_geometry=shadow_geometry,
        shadow_clusters=shadow_clusters,
        sdf=sdf_shape,
        media=medium_mod.build_table(media_rows, shape_interior, shape_count, device=device),
        bvh=tree,
    )


def pack_bvh(cfg, tree, geometry, shadow_geometry):
    """Make the BVH kernels' packed storage of a scene traced on the BVH
    (cfg.intersector "bvh") on the card: B1's over the geometry, B2's over
    the shadow geometry where there is one, so that no frame packs
    (render/bvh.packed keeps it). A scene on the clusters packs nothing;
    switched to the BVH later, it packs on its first call."""
    if cfg.intersector != "bvh" or tree is None or not tree.skip.is_cuda:
        return
    for g in (geometry, shadow_geometry if shadow_geometry is not None else geometry):
        bvh_mod.packed(tree, g)


def _load_sensor(t, val, cfg, device):
    """The Sensor of a sensor dict of type t (or "batch"), with its film
    size, film filter, sampler and spp written into cfg (the JAX
    loader's defaults: a radiancemeter or irradiancemeter film is 1x1, and
    the irradiancemeter's film is scaled by pi)."""
    film = val.get("film", {})
    meter = t in ("radiancemeter", "irradiancemeter")
    cfg.width = int(film.get("width", 1 if meter else cfg.width))
    cfg.height = int(film.get("height", 1 if meter else cfg.height))
    if t == "irradiancemeter":
        cfg.sensor_scale = float(np.pi)
    if t != "batch":  # the JAX loader reads no film filter for a batch sensor
        rf = film.get("rfilter", "box")
        cfg.rfilter = rf.get("type", "box") if isinstance(rf, dict) else rf
        if cfg.rfilter not in FILTER_NAMES:
            raise ValueError(f"unsupported film filter '{cfg.rfilter}'")
    samp = val.get("sampler", {})
    cfg.sampler = samp.get("type", cfg.sampler)
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unsupported sampler '{cfg.sampler}'")
    cfg.spp = int(samp.get("sample_count", cfg.spp))

    def make(st, spec):
        return sensor_mod.make_sensor(
            st, _as_transform(spec.get("to_world")), float(spec.get("fov", 45.0)),
            float(spec.get("aperture_radius", 0.0)), float(spec.get("focus_distance", 1.0)),
            float(spec.get("near_clip", 1e-3)), float(spec.get("ortho_scale", 1.0)),
            device=device)

    if t != "batch":
        return make(t, val)
    kids = [make(sub.get("type", "perspective"), sub) for sub in val.values()
            if isinstance(sub, dict) and sub.get("type") in _BATCH_CHILDREN]
    if not kids:
        raise ValueError("batch sensor needs child sensors")
    return sensor_mod.stack_sensors(kids)


def _build_emitter_table(em_rows, emissive_prim_ranges, arrays, const_row, env,
                         proj, device):
    """EmitterTable: the emitter rows (the JAX loader's fields), the
    emissive prims with their per-emitter area pmfs, the envmap with its
    sampling distribution and the projector's image, and uniform NEE
    selection over the emitters.

    Beside other emitters a constant sky gets selection weight exactly 0:
    for a constant radiance field BSDF sampling is already proportional to
    the integrand, and pdf_miss_direction reads the same pmf, so escaped
    BSDF rays then carry MIS weight 1. (The JAX package gives the sky
    1e-20 instead, so a lane that drew it would be weighted by ~1e20.)
    A sky that is the only emitter stays in NEE.
    """
    k = max(len(em_rows), 1)
    em_type = np.zeros(k, np.int64)
    radiance = np.zeros((k, 3), np.float32)
    position = np.zeros((k, 3), np.float32)
    direction = np.tile(np.asarray([0, 0, 1], np.float32), (k, 1))
    cutoff_cos = np.zeros(k, np.float32)
    beam_cos = np.zeros(k, np.float32)
    for i, row in enumerate(em_rows):
        em_type[i] = row["type"]
        radiance[i] = np.asarray(row.get("radiance", [0, 0, 0]), np.float32)
        position[i] = np.asarray(row.get("position", [0, 0, 0]), np.float32)
        dir_ = np.asarray(row.get("direction", [0, 0, 1]), np.float64)
        direction[i] = (dir_ / max(np.linalg.norm(dir_), 1e-12)).astype(np.float32)
        if row["type"] == em_mod.SPOT:
            cutoff_cos[i] = np.cos(np.deg2rad(row.get("cutoff", 20.0)))
            beam_cos[i] = np.cos(np.deg2rad(row.get("beam", 15.0)))

    q_ids = [p for _, start, end in emissive_prim_ranges for p in range(start, end)]
    q_owner = [e for e, start, end in emissive_prim_ranges for _ in range(start, end)]
    q = max(len(q_ids), 1)
    em_prims = np.zeros(q, np.int64)
    prim_area = np.ones(q, np.float32)
    pmf = np.zeros((k, q), np.float32)
    if q_ids:
        em_prims = np.asarray(q_ids, np.int64)
        e1, e2 = arrays["e1"][em_prims], arrays["e2"][em_prims]
        pt = arrays["prim_type"][em_prims]
        tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        sph_area = 4.0 * np.pi * e1[:, 0] ** 2
        cyl_area = 2.0 * np.pi * e2[:, 0] * np.linalg.norm(e1, axis=-1)
        prim_area = np.where(
            pt == geo.TRI, tri_area,
            np.where(pt == geo.CYLINDER, cyl_area, sph_area),
        ).astype(np.float32)
        for qi, owner in enumerate(q_owner):
            pmf[owner, qi] = prim_area[qi]
    row_sums = pmf.sum(-1, keepdims=True)
    pmf = np.where(row_sums > 0, pmf / np.maximum(row_sums, 1e-20), 0.0)
    prim_to_q = np.full(len(arrays["prim_type"]), -1, np.int64)
    prim_to_q[em_prims[:len(q_ids)]] = np.arange(len(q_ids))

    sel = (np.ones(k) if em_rows else np.zeros(k)) + 1e-20
    is_const = em_type[:len(em_rows)] == em_mod.CONSTANT
    if is_const.any() and (~is_const).any():
        sel[:len(em_rows)][is_const] = 0.0
    sel_pmf = (sel / sel.sum()).astype(np.float32)

    def dist(p):
        return DiscreteDistribution(
            pmf=torch.as_tensor(p, device=device),
            cdf=torch.as_tensor(np.cumsum(p, axis=-1, dtype=np.float32),
                                device=device),
        )

    def dev(a):
        return torch.as_tensor(a, device=device)

    env_image = dev(env["image"] if env["image"] is not None
                    else np.zeros((1, 1, 3), np.float32))
    has_da = bool(q_owner) and bool((em_type[:len(em_rows)] == em_mod.DIRECTIONALAREA).any())
    return em_mod.EmitterTable(
        em_type=dev(em_type),
        select=dist(sel_pmf),
        radiance=dev(radiance),
        background_index=int(const_row),
        prim_dist=dist(pmf.astype(np.float32)),
        em_prims=dev(em_prims),
        prim_area=dev(prim_area),
        prim_to_q=dev(prim_to_q),
        has_area=bool(q_ids),
        position=dev(position), direction=dev(direction),
        cutoff_cos=dev(cutoff_cos), beam_cos=dev(beam_cos),
        env_image=env_image,
        env_dist=em_mod.build_env_distribution(env_image),
        env_to_world=dev(np.asarray(env["to_world"], np.float32)),
        env_index=int(env["row"]),
        em_prim_emitter=dev(np.asarray(q_owner, np.int64)) if has_da else None,
        proj_image=dev(proj["image"] if proj["image"] is not None
                       else np.ones((1, 1, 3), np.float32)),
        proj_to_world=dev(np.asarray(proj["frame"], np.float32)),
        proj_tan=float(np.float32(proj["tan"])),
        proj_index=int(proj["row"]),
        present=frozenset(int(t) for t in em_type[:len(em_rows)]),
    )
