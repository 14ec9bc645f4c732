"""Scene container + dict-based scene loader.

PyTorch port of mitsuba_customization_tpu/render/scene.py (`load_dict`,
`SceneConfig`, `Scene`) for the subset of the flagship and matpreview
scenes:

* shapes: sphere, rectangle and mesh (vertices, faces, optional normals
  and uvs), with a rotate / scale / translate to_world;
* an "area" emitter on a shape;
* sensor, sampler, film filter: perspective, independent, box;
* integrator: path, with an optional wavefront-compaction schedule
  ("compact");
* emitter: constant;
* BSDFs: merl from a "table" array, roughconductor (GGX), diffuse.

Any other type raises NotImplementedError. Scenes past
BRUTE_FORCE_MAX_PRIMS primitives get the cluster structure
(ops/clusters.py) and intersector = "cluster"; past clusters.MAX_PRIMS
the loader raises. The device is explicit: `load_dict(d, device)`. The
host-side numpy helpers are copied from the JAX package, not imported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.distr import DiscreteDistribution
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.models import diffuse as diffuse_mod
from mitsuba_customization_tpu_torch.models import roughconductor as rough_mod
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF
from mitsuba_customization_tpu_torch.ops import clusters as cl_mod
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import sensors as sensor_mod

BRUTE_FORCE_MAX_PRIMS = 64

# Default copper-ish conductor IOR (per-channel eta - i k).
_DEFAULT_ETA = (0.2004, 0.9240, 1.1022)
_DEFAULT_K = (3.9129, 2.4528, 2.1421)


@dataclasses.dataclass
class SceneConfig:
    """Static scene facts (the JAX SceneConfig's fields this port reads)."""

    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 2
    rr_depth: int = 5
    integrator: str = "path"
    sampler: str = "independent"
    rfilter: str = "box"
    hide_emitters: bool = False
    # False when the scene has no emitter at all: the integrator then
    # skips NEE sampling and shadow rays statically.
    nee: bool = True
    # "brute" (all pairs) or "cluster" (ops/clusters.py, K3 and K4)
    intersector: str = "brute"
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

    @property
    def device(self):
        return self.geometry.p0.device

    def ray_intersect(self, ray):
        """Nearest hit -> SurfaceInteraction (K3 in cluster mode, else
        brute force)."""
        cyl = self.has_cylinders
        if self.config.intersector == "cluster":
            t, prim, u, v, g = cl_mod.intersect(self.clusters, ray)
            return geo.interaction_from_g(g, ray, t, prim, u, v, cyl)
        t, prim, u, v = geo.intersect_brute(self.geometry, ray, cyl)
        return geo.compute_interaction(self.geometry, ray, t, prim, u, v, cyl)

    def ray_test(self, ray):
        """Shadow-ray occlusion (K4 in cluster mode, else brute force). No
        null-material prims are ported, so the shadow geometry is the
        geometry."""
        if self.config.intersector == "cluster":
            return cl_mod.occluded(self.clusters, ray)
        return geo.occluded_brute(self.geometry, ray, self.has_cylinders)


# --------------------------------------------------------------------------
# Host-side helpers (numpy)
# --------------------------------------------------------------------------


def resolve_spectrum(val, default=(1.0, 1.0, 1.0)):
    """Scalar, [r, g, b] or {"type": "rgb"/"uniform", "value": ...} -> RGB."""
    if isinstance(val, dict):
        t = val.get("type", "rgb")
        if t not in ("rgb", "uniform"):
            raise NotImplementedError(f"spectrum type '{t}' is not ported")
        val = val.get("value", default)
    arr = np.asarray(val, dtype=np.float32)
    return np.full(3, arr, np.float32) if arr.ndim == 0 else arr


def _as_transform(t):
    """A 4x4 array, or a dict {scale, rotate(axis, angle), translate}
    composed in that order."""
    if t is None:
        return np.eye(4, dtype=np.float32)
    if not isinstance(t, dict):
        return np.asarray(t, dtype=np.float32)
    unknown = set(t) - {"scale", "rotate", "translate"}
    if unknown:
        raise NotImplementedError(f"to_world keys {sorted(unknown)} are not ported")
    mat = np.eye(4)
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

    def add_mesh(self, v, f, n, uv, mat_id, emitter_id, shape_id):
        """Triangles with vertex normals n, or area-weighted ones when n is
        None (the JAX package's fallback), and uvs (zeros when None)."""
        v = np.asarray(v, np.float32)
        f = np.asarray(f, np.int64)
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

_SENSOR_TYPES = {"perspective"}
_SHAPE_TYPES = {"sphere", "rectangle", "mesh"}
_BSDF_TYPES = {"diffuse", "roughconductor", "merl"}


def load_dict(d: dict, device) -> Scene:
    """Compile a mi.load_dict-style nested dict into a Scene on `device`."""
    if d.get("type") != "scene":
        raise ValueError("root dict must have type='scene'")
    device = torch.device(device)
    cfg = SceneConfig()
    mat_types: list[int] = []
    mat_slots: list[int] = []
    stacks: dict[int, list] = {}
    tab_tables: list[np.ndarray] = []
    named_bsdfs: dict[str, int] = {}
    em_rows: list[dict] = []
    emissive_prim_ranges: list[tuple] = []  # (emitter_id, prim_start, prim_end)
    const_row = -1

    def rgb(bd, key, default):
        return resolve_spectrum(bd.get(key, default), default)

    def compile_bsdf(bd) -> int:
        if isinstance(bd, str):
            if bd not in named_bsdfs:
                raise ValueError(f"unknown bsdf reference '{bd}'")
            return named_bsdfs[bd]
        btype = bd.get("type", "diffuse")
        if btype not in _BSDF_TYPES:
            raise NotImplementedError(f"bsdf type '{btype}' is not ported")
        if btype == "merl":
            if "table" not in bd:
                raise NotImplementedError("merl from a file is not ported")
            table = np.asarray(bd["table"], dtype=np.float32)
            if tab_tables and tab_tables[0].shape != table.shape:
                raise ValueError(
                    "all tabulated BRDFs in one scene must share a "
                    f"resolution; got {table.shape} vs {tab_tables[0].shape}"
                )
            tab_tables.append(table)
            mat_types.append(bsdf_mod.TABULATED)
            mat_slots.append(len(tab_tables) - 1)
            return len(mat_types) - 1
        if btype == "diffuse":
            refl = bd.get("reflectance", [0.5, 0.5, 0.5])
            if isinstance(refl, dict) and refl.get("type") not in ("rgb", "uniform"):
                raise NotImplementedError("textured diffuse is not ported")
            kid = bsdf_mod.DIFFUSE
            params = diffuse_mod.DiffuseParams(
                reflectance=rgb(bd, "reflectance", [0.5, 0.5, 0.5])
            )
        else:  # roughconductor
            if bd.get("distribution", "ggx") != "ggx":
                raise NotImplementedError("only the GGX distribution is ported")
            kid = bsdf_mod.ROUGHCONDUCTOR
            alpha = float(bd.get("alpha", 0.1))
            params = rough_mod.RoughConductorParams(
                alpha_u=np.float32(bd.get("alpha_u", alpha)),
                alpha_v=np.float32(bd.get("alpha_v", alpha)),
                eta=rgb(bd, "eta", _DEFAULT_ETA),
                k=rgb(bd, "k", _DEFAULT_K),
                specular_reflectance=rgb(bd, "specular_reflectance", [1, 1, 1]),
            )
        stacks.setdefault(kid, []).append(params)
        mat_types.append(kid)
        mat_slots.append(len(stacks[kid]) - 1)
        return len(mat_types) - 1

    gb = _GeomBuilder()
    sensor = None
    shape_count = 0

    def add_shape(val):
        nonlocal shape_count
        t = val.get("type")
        if "interior" in val or "exterior" in val:
            raise NotImplementedError("participating media are not ported")
        if val.get("face_normals", False) or "vertex_colors" in val:
            raise NotImplementedError("face_normals / vertex_colors are not ported")
        mat_id = compile_bsdf(val.get("bsdf", {"type": "diffuse"}))
        emitter_id = -1
        if "emitter" in val:
            espec = val["emitter"]
            if espec.get("type") != "area":
                raise NotImplementedError(
                    f"shape emitter '{espec.get('type')}' is not ported"
                )
            em_rows.append(dict(
                type=em_mod.AREA,
                radiance=resolve_spectrum(espec.get("radiance", [1, 1, 1])),
            ))
            emitter_id = len(em_rows) - 1
        prim_start = gb.count
        to_w = _as_transform(val.get("to_world"))
        if t == "sphere":
            center = _apply_transform(
                to_w, np.asarray(val.get("center", [0, 0, 0]), np.float64)
            )
            scale = np.cbrt(abs(np.linalg.det(to_w[:3, :3])))
            gb.add_sphere(center, float(val.get("radius", 1.0)) * scale,
                          mat_id, emitter_id, shape_count)
        else:
            if t == "mesh":
                v = np.asarray(val["vertices"], np.float32)
                f = np.asarray(val["faces"], np.int32)
                n, uv = val.get("normals"), val.get("uvs")
                n = None if n is None else np.asarray(n, np.float32)
                uv = None if uv is None else np.asarray(uv, np.float32)
            else:  # rectangle
                v, f, uv = _unit_rectangle()
                n = None
            v = _apply_transform(to_w, v.astype(np.float64)).astype(np.float32)
            if n is not None:
                n = _apply_normal_transform(to_w, n)
            gb.add_mesh(v, f, n, uv, mat_id, emitter_id, shape_count)
        if emitter_id >= 0:
            emissive_prim_ranges.append((emitter_id, prim_start, gb.count))
        shape_count += 1

    # Pass 1: named top-level BSDFs (so shapes can reference them).
    for key, val in d.items():
        if key != "type" and isinstance(val, dict) and val.get("type") in _BSDF_TYPES:
            named_bsdfs[key] = compile_bsdf(val)

    # Pass 2: everything else.
    for key, val in d.items():
        if key == "type" or not isinstance(val, dict):
            continue
        t = val.get("type")
        if t in _BSDF_TYPES:
            continue
        if key == "integrator":
            if val.get("type", "path") != "path":
                raise NotImplementedError(f"integrator '{val.get('type')}' is not ported")
            cfg.integrator = "path"
            cfg.max_depth = int(val.get("max_depth", cfg.max_depth))
            cfg.rr_depth = int(val.get("rr_depth", cfg.rr_depth))
            cfg.hide_emitters = bool(val.get("hide_emitters", False))
            if val.get("compact") is not None:
                cfg.compact = tuple(float(f) for f in val["compact"])
            continue
        if t in _SENSOR_TYPES:
            film = val.get("film", {})
            cfg.width = int(film.get("width", cfg.width))
            cfg.height = int(film.get("height", cfg.height))
            rf = film.get("rfilter", "box")
            cfg.rfilter = rf.get("type", "box") if isinstance(rf, dict) else rf
            if cfg.rfilter != "box":
                raise NotImplementedError(f"film filter '{cfg.rfilter}' is not ported")
            samp = val.get("sampler", {})
            cfg.sampler = samp.get("type", cfg.sampler)
            if cfg.sampler != "independent":
                raise NotImplementedError(f"sampler '{cfg.sampler}' is not ported")
            cfg.spp = int(samp.get("sample_count", cfg.spp))
            sensor = sensor_mod.make_sensor(
                device,
                to_world=_as_transform(val.get("to_world")),
                fov_x=float(val.get("fov", 45.0)),
                near_clip=float(val.get("near_clip", 1e-3)),
            )
            continue
        if t == "constant":
            em_rows.append(dict(
                type=em_mod.CONSTANT,
                radiance=resolve_spectrum(val.get("radiance", [1, 1, 1])),
            ))
            const_row = len(em_rows) - 1
            continue
        if t in _SHAPE_TYPES:
            add_shape(val)
            continue
        raise NotImplementedError(f"scene entry '{key}' (type={t}) is not ported")

    if gb.count > cl_mod.MAX_PRIMS:
        raise NotImplementedError(
            f"scene has {gb.count} primitives, past the cluster structure's "
            f"capacity ({cl_mod.MAX_PRIMS}); the JAX package's skip-link BVH "
            "for such scenes is not ported"
        )
    arrays = gb.arrays()
    geometry = geometry_from_numpy(arrays, device)
    clusters = None
    if gb.count > BRUTE_FORCE_MAX_PRIMS:
        cfg.intersector = "cluster"
        clusters = cl_mod.build(geo.Geometry(**arrays), device)

    def stack_params(plist):
        return type(plist[0])(*(
            torch.as_tensor(np.stack(f), device=device) for f in zip(*plist)
        ))

    kernel_stacks = {kid: stack_params(plist) for kid, plist in stacks.items()}
    if tab_tables:
        kernel_stacks[bsdf_mod.TABULATED] = TabulatedBRDF.build_stack(
            torch.as_tensor(np.stack(tab_tables), device=device)
        )
    if not mat_types:
        mat_types, mat_slots = [bsdf_mod.DIFFUSE], [0]
    bsdfs = bsdf_mod.BSDFTable(
        mat_type=torch.as_tensor(mat_types, dtype=torch.int64, device=device),
        mat_slot=torch.as_tensor(mat_slots, dtype=torch.int64, device=device),
        stacks=kernel_stacks,
    )
    cfg.nee = len(em_rows) > 0
    if sensor is None:
        sensor = sensor_mod.make_sensor(device)
    return Scene(
        geometry=geometry,
        bsdfs=bsdfs,
        emitters=_build_emitter_table(em_rows, emissive_prim_ranges, arrays,
                                      const_row, device),
        sensor=sensor,
        config=cfg,
        clusters=clusters,
        has_cylinders=bool((arrays["prim_type"] == geo.CYLINDER).any()),
    )


def _build_emitter_table(em_rows, emissive_prim_ranges, arrays, const_row,
                         device):
    """EmitterTable: the emissive prims with their per-emitter area pmfs,
    and uniform NEE selection over the emitters.

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
    for i, row in enumerate(em_rows):
        em_type[i] = row["type"]
        radiance[i] = row["radiance"]

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

    return em_mod.EmitterTable(
        em_type=torch.as_tensor(em_type, device=device),
        select=dist(sel_pmf),
        radiance=torch.as_tensor(radiance, device=device),
        background_index=int(const_row),
        prim_dist=dist(pmf.astype(np.float32)),
        em_prims=torch.as_tensor(em_prims, device=device),
        prim_area=torch.as_tensor(prim_area, device=device),
        prim_to_q=torch.as_tensor(prim_to_q, device=device),
        has_area=bool(q_ids),
    )
