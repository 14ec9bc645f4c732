"""Differentiable scene parameters (`traverse` / `update`), and a port
Scene from the leaves of a JAX-package Scene.

`traverse(scene)` is the flat dict of a Scene's differentiable leaves and
`update(scene, params)` writes them back into a new Scene, rebuilding the
MERL luminance-sampling CDFs from a new table and the envmap's sampling
distribution from a new image: the port of
mitsuba_customization_tpu/render/params.py (mitsuba3's mi.traverse and
SceneParameters), with the same dotted keys:
    bsdf.<kernel>.<field>   e.g. bsdf.roughconductor.alpha_u, (M,) for
                            the M materials of that kernel; the float
                            fields of the texture stack, e.g.
                            bsdf.textured_diffuse.images (T, H, W, 3)
    bsdf.tabulated.table    the stacked (n_mat, n_th, n_td, n_pd, 3) tables
    emitter.radiance        (K, 3) emitter radiances
    emitter.env_image       (H, W, 3) the envmap's image
    medium.sigma_t, medium.albedo (K, 3), medium.phase_g (K,),
    medium.density          the (Kg, D, H, W) density grid stack; keys
                            of scenes with media; an update recomputes
                            the majorants
`params_from_numpy` takes a JAX `traverse` dict as numpy arrays, so both
packages differentiate the same values.

`scene_from_numpy(arrays, config, device)` takes the JAX Scene's leaves as
{path: np.ndarray}, with paths as `jax.tree_util.keystr` writes them (for
example ".geometry.p0" or ".bsdfs.stacks[4].sampling.cdf_cond"), and its
SceneConfig (any object with the same attribute names). The parity tests
use it to run both packages on identical arrays. Only the subset the port
renders is accepted (the ported BSDF kernels, the texture stack, normal
maps and blends, the shadow geometry and cluster set of a scene with null
materials, brute, cluster or bvh intersector (the JAX tree's arrays
when use_bvh), every emitter type, every sensor
(a batch sensor's stacked fields and child_types too), sampler and film
filter, an SDF grid, the media table, the integrators, an optional
compaction schedule); anything else raises NotImplementedError. The JAX
package's TPU-only copies (`emitters.em_geom`, the tabulated `corners` /
`perm` / `condT`) are not read.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.distr import (
    DiscreteDistribution,
    Marginal2D,
)
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.models.conductor import ConductorParams
from mitsuba_customization_tpu_torch.models.dielectric import DielectricParams
from mitsuba_customization_tpu_torch.models.diffuse import DiffuseParams
from mitsuba_customization_tpu_torch.models.passthrough import PassthroughParams
from mitsuba_customization_tpu_torch.models.plastic import PlasticParams
from mitsuba_customization_tpu_torch.models.principled import PrincipledParams
from mitsuba_customization_tpu_torch.models.roughconductor import (
    RoughConductorParams,
)
from mitsuba_customization_tpu_torch.models.roughdielectric import (
    RoughDielectricParams,
)
from mitsuba_customization_tpu_torch.models.roughplastic import RoughPlasticParams
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF
from mitsuba_customization_tpu_torch.models.texture import TextureStack
from mitsuba_customization_tpu_torch.models.thindielectric import (
    ThinDielectricParams,
)
from mitsuba_customization_tpu_torch.ops import clusters as cl_mod
from mitsuba_customization_tpu_torch.ops import merl_sorted
from mitsuba_customization_tpu_torch.render import bvh as bvh_mod
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.core.sampler import SAMPLERS
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import medium as medium_mod
from mitsuba_customization_tpu_torch.render import sdf as sdf_mod
from mitsuba_customization_tpu_torch.render import sensors as sensor_mod
from mitsuba_customization_tpu_torch.render.film import FILTER_NAMES
from mitsuba_customization_tpu_torch.render.scene import (
    INTEGRATOR_TYPES,
    Scene,
    SceneConfig,
    geometry_from_numpy,
    pack_bvh,
)

_STACK = re.compile(r"^bsdfs\.stacks\[(\d+)\]\.(.+)$")

KERNEL_NAMES = bsdf_mod.KERNEL_NAMES
# the parameter NamedTuple of each analytic kernel
PARAMS = {
    bsdf_mod.DIFFUSE: DiffuseParams,
    bsdf_mod.CONDUCTOR: ConductorParams,
    bsdf_mod.ROUGHCONDUCTOR: RoughConductorParams,
    bsdf_mod.ROUGHCONDUCTOR_BECKMANN: RoughConductorParams,
    bsdf_mod.DIELECTRIC: DielectricParams,
    bsdf_mod.THINDIELECTRIC: ThinDielectricParams,
    bsdf_mod.ROUGHDIELECTRIC: RoughDielectricParams,
    bsdf_mod.PLASTIC: PlasticParams,
    bsdf_mod.ROUGHPLASTIC: RoughPlasticParams,
    bsdf_mod.PASSTHROUGH: PassthroughParams,
    bsdf_mod.PRINCIPLED: PrincipledParams,
}
# medium keys -> MediumTable fields
MEDIUM_KEYS = {"medium.sigma_t": "sigma_t", "medium.albedo": "albedo",
               "medium.phase_g": "phase_g", "medium.density": "grid"}


def traverse(scene):
    """The differentiable parameter dict of a Scene: its own tensors."""
    params = {}
    for kid, stack in scene.bsdfs.stacks.items():
        kname = KERNEL_NAMES[kid]
        if kid == bsdf_mod.TABULATED:
            params[f"bsdf.{kname}.table"] = stack.table
        else:
            for field, value in zip(stack._fields, stack):
                # texture bindings (int) and absent volume / attribute
                # tables (None) are not parameters
                if value is not None and value.is_floating_point():
                    params[f"bsdf.{kname}.{field}"] = value
    params["emitter.radiance"] = scene.emitters.radiance
    if scene.emitters.env_index >= 0:
        params["emitter.env_image"] = scene.emitters.env_image
    if scene.media.n_media:
        for key, field in MEDIUM_KEYS.items():
            params[key] = getattr(scene.media, field)
    return params


def update(scene, params):
    """A new Scene with `params` (keys of traverse) written in. The tensors
    go in as they are, not copied, so gradients reach the caller's
    tensors; a new table gets its sampling CDFs rebuilt
    (TabulatedBRDF.build_stack, from the detached table) and, where it
    requires grad, the GradSink through which it enters autograd once:
    the K1 calls of the render add their backward into one buffer. A new
    envmap image gets its sampling distribution rebuilt from the image
    itself, as the JAX package's update does: its gradient then also
    reaches the image through the NEE directions it samples. New medium
    parameters get the majorants recomputed (medium.recompute_majorant)
    and, where the density grid requires grad, its GradSink: the backward
    of every tracking call of the render adds into one grid-sized
    buffer."""
    unknown = set(params) - set(traverse(scene))
    if unknown:
        raise KeyError(f"not parameters of this scene: {sorted(unknown)}")
    stacks = dict(scene.bsdfs.stacks)
    for kid, stack in stacks.items():
        pre = f"bsdf.{KERNEL_NAMES[kid]}."
        if kid == bsdf_mod.TABULATED:
            if pre + "table" in params:
                stacks[kid] = TabulatedBRDF.build_stack(params[pre + "table"])
        else:
            stacks[kid] = stack._replace(**{
                f: params[pre + f] for f in stack._fields if pre + f in params
            })
    emitters = scene.emitters
    if "emitter.radiance" in params:
        emitters = emitters._replace(radiance=params["emitter.radiance"])
    if "emitter.env_image" in params:
        img = params["emitter.env_image"]
        emitters = emitters._replace(env_image=img,
                                     env_dist=em_mod.build_env_distribution(img))
    media = scene.media
    new = {field: params[key] for key, field in MEDIUM_KEYS.items() if key in params}
    if new:
        media = media._replace(**new)
        media = media._replace(majorant=medium_mod.recompute_majorant(media),
                               grid_sink=merl_sorted.grad_sink(media.grid))
    return dataclasses.replace(
        scene, bsdfs=scene.bsdfs._replace(stacks=stacks), emitters=emitters, media=media
    )


def params_from_numpy(arrays, device):
    """The port's parameter dict from a JAX `traverse` dict as numpy
    arrays ({key: ndarray}), float32 on `device`."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def _config(config):
    # The JAX loader sets use_bvh on every scene past 64 prims and builds
    # its BVH beside the clusters; `intersector` says which one traces.
    cfg = SceneConfig(**{f: getattr(config, f) for f in SceneConfig.__dataclass_fields__})
    if (cfg.integrator not in INTEGRATOR_TYPES or cfg.rfilter not in FILTER_NAMES
            or cfg.sampler not in SAMPLERS
            or cfg.intersector not in ("brute", "cluster", "bvh")):
        raise NotImplementedError(f"scene configuration not ported: {config}")
    if cfg.compact is not None:
        cfg.compact = tuple(float(f) for f in cfg.compact)
    return cfg


def _texture_stack(pre, a, get):
    """A TextureStack from the JAX leaves under `pre` (absent = None)."""
    ints = ("tex_type", "slot", "dims", "vol_dims", "vol_slot")
    return TextureStack(**{
        f: get(pre + f, torch.int64 if f in ints else torch.float32)
        for f in TextureStack._fields if pre + f in a
    })


def scene_from_numpy(arrays, config, device):
    """Port Scene on `device` from {keystr path: ndarray} and a SceneConfig."""
    a = {k.lstrip("."): np.asarray(v) for k, v in arrays.items()}
    used = set()

    def get(name, dtype=torch.float32):
        used.add(name)
        return torch.tensor(a[name], dtype=dtype, device=device)

    geometry = geometry_from_numpy(
        {f: a[f"geometry.{f}"] for f in geo.Geometry._fields}, device
    )
    used.update(f"geometry.{f}" for f in geo.Geometry._fields)

    stacks = {}
    kids = sorted({int(mt.group(1)) for mt in map(_STACK.match, a) if mt})
    for kid in kids:
        pre = f"bsdfs.stacks[{kid}]."
        if kid in PARAMS:
            stacks[kid] = PARAMS[kid](*(get(pre + f) for f in PARAMS[kid]._fields))
        elif kid == bsdf_mod.TEXTURED_DIFFUSE:
            stacks[kid] = _texture_stack(pre, a, get)
        elif kid == bsdf_mod.TABULATED:
            # the JAX package's TPU layouts (corners, perm, condT) are not used
            used.update(pre + f for f in ("corners", "perm", "condT"))
            stacks[kid] = TabulatedBRDF(
                table=get(pre + "table"),
                sampling=Marginal2D(*(
                    get(pre + "sampling." + f) for f in Marginal2D._fields
                )),
            )
        else:
            raise NotImplementedError(f"BSDF kernel {kid} is not ported")
    normal = {}
    if "bsdfs.nm_slot" in a:
        normal = dict(normal_tex=_texture_stack("bsdfs.normal_tex.", a, get),
                      nm_slot=get("bsdfs.nm_slot", torch.int64))
    blend = {}
    if "bsdfs.blend_a" in a:
        blend = dict(blend_a=get("bsdfs.blend_a", torch.int64),
                     blend_b=get("bsdfs.blend_b", torch.int64),
                     blend_w=get("bsdfs.blend_w"))
    bsdfs = bsdf_mod.BSDFTable(
        mat_type=get("bsdfs.mat_type", torch.int64),
        mat_slot=get("bsdfs.mat_slot", torch.int64),
        stacks=stacks, **blend, **normal,
    )

    em_type = get("emitters.em_type", torch.int64)
    em = {f: get("emitters." + f) for f in ("position", "direction", "cutoff_cos",
                                            "beam_cos", "env_image", "env_to_world",
                                            "proj_image", "proj_to_world")}
    emitters = em_mod.EmitterTable(
        em_type=em_type,
        select=DiscreteDistribution(
            get("emitters.select.pmf"), get("emitters.select.cdf")
        ),
        radiance=get("emitters.radiance"),
        background_index=int(a["emitters.background_index"]),
        prim_dist=DiscreteDistribution(
            get("emitters.prim_dist.pmf"), get("emitters.prim_dist.cdf")
        ),
        em_prims=get("emitters.em_prims", torch.int64),
        prim_area=get("emitters.prim_area"),
        prim_to_q=get("emitters.prim_to_q", torch.int64),
        has_area=bool((a["emitters.em_type"] == em_mod.AREA).any()),
        env_dist=Marginal2D(*(get("emitters.env_dist." + f) for f in Marginal2D._fields)),
        env_index=int(a["emitters.env_index"]),
        em_prim_emitter=(get("emitters.em_prim_emitter", torch.int64)
                         if "emitters.em_prim_emitter" in a else None),
        proj_tan=float(a["emitters.proj_tan"]),
        proj_index=int(a.get("emitters.proj_index", -1)),
        present=frozenset(int(t) for t in a["emitters.em_type"]),
        **em,
    )
    used.update(f"emitters.{f}" for f in ("background_index", "env_index", "proj_tan",
                                          "proj_index"))

    def cluster_set(pre):
        """The JAX ClusterSet at `pre` ("clusters." or "shadow_clusters."),
        or None. The JAX slabs are (C, NFIELDS, 128) field-major with
        padding lanes; the port's are (C, L, NFIELDS) slot-major."""
        if pre + "slabs" not in a:
            return None
        used.update(pre + f for f in ("sc_box", "cl_box", "cl_meta", "slabs"))
        slabs = a[pre + "slabs"].transpose(0, 2, 1)[:, :cl_mod.L, :cl_mod.NFIELDS]
        return cl_mod.cluster_set(a[pre + "sc_box"], a[pre + "cl_box"],
                                  a[pre + "cl_meta"], np.ascontiguousarray(slabs), device)

    clusters = cluster_set("clusters.")
    shadow_clusters = cluster_set("shadow_clusters.")
    shadow_geometry = None
    if "shadow_geometry.p0" in a:
        shadow_geometry = geometry_from_numpy(
            {f: a[f"shadow_geometry.{f}"] for f in geo.Geometry._fields}, device)
        used.update(f"shadow_geometry.{f}" for f in geo.Geometry._fields)

    sensor = sensor_mod.Sensor(**{
        f: get("sensor." + f, torch.int64 if f in ("sensor_type", "child_types")
               else torch.float32)
        for f in sensor_mod.Sensor._fields if "sensor." + f in a})
    sdf = None
    if "sdf.values" in a:
        # the JAX tree's fields; the corner layout is derived from its values
        fields = {f: get("sdf." + f, torch.int64 if f in ("mat_id", "shape_id")
                         else torch.float32)
                  for f in sdf_mod.SDFGrid._fields if f != "corners"}
        sdf = sdf_mod.SDFGrid(**fields, corners=sdf_mod.corner_layout(fields["values"]))
    ints = ("m_type", "phase_type", "grid_slot", "grid_dims", "shape_interior")
    media = medium_mod.MediumTable(**{
        f: get("media." + f, torch.int64 if f in ints else torch.float32)
        for f in medium_mod.MediumTable._fields if "media." + f in a})
    media = media._replace(has_het=bool((a["media.m_type"] == medium_mod.HETEROGENEOUS).any()))
    checked = ("shadow_geometry.", "shadow_clusters.", "clusters.", "sdf.",
               "bsdfs.", "emitters.", "media.")
    used.update(k for k in a if k.startswith("emitters.em_geom."))
    for k in a:
        if k.startswith(checked) and k not in used:
            raise NotImplementedError(f"scene leaf '{k}' is not ported")
    cfg = _config(config)
    if (cfg.intersector == "cluster") != (clusters is not None):
        raise NotImplementedError("cluster intersector without clusters")
    # the JAX Scene always holds a tree, a dummy one without use_bvh
    tree = None
    if cfg.use_bvh:
        tree = bvh_mod.bvh_from_numpy(*(a["bvh." + f] for f in bvh_mod.BVH._fields), device)
    elif cfg.intersector == "bvh":
        raise NotImplementedError("bvh intersector without use_bvh")
    pack_bvh(cfg, tree, geometry, shadow_geometry)
    return Scene(
        geometry=geometry, bsdfs=bsdfs, emitters=emitters, sensor=sensor,
        config=cfg, clusters=clusters,
        has_cylinders=bool((a["geometry.prim_type"] == geo.CYLINDER).any()),
        shadow_geometry=shadow_geometry, shadow_clusters=shadow_clusters, sdf=sdf,
        media=media, bvh=tree,
    )
