"""Build a port Scene from the leaves of a JAX-package Scene.

`scene_from_numpy(arrays, config, device)` takes the JAX Scene's leaves as
{path: np.ndarray}, with paths as `jax.tree_util.keystr` writes them (for
example ".geometry.p0" or ".bsdfs.stacks[4].sampling.cdf_cond"), and its
SceneConfig (any object with the same attribute names). The parity tests
use it to run both packages on identical arrays. Only the subset the port
renders is accepted (brute or cluster intersector, area and constant
emitters, an optional compaction schedule); anything else raises
NotImplementedError. The JAX package's BVH and its TPU-only copies
(`emitters.em_geom`, the tabulated `corners` / `perm` / `condT`) are
not read.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.distr import (
    DiscreteDistribution,
    Marginal2D,
)
from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
from mitsuba_customization_tpu_torch.models.diffuse import DiffuseParams
from mitsuba_customization_tpu_torch.models.roughconductor import (
    RoughConductorParams,
)
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF
from mitsuba_customization_tpu_torch.ops import clusters as cl_mod
from mitsuba_customization_tpu_torch.render import emitters as em_mod
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render import sensors as sensor_mod
from mitsuba_customization_tpu_torch.render.scene import (
    Scene,
    SceneConfig,
    geometry_from_numpy,
)

_STACK = re.compile(r"^bsdfs\.stacks\[(\d+)\]\.(.+)$")


def _config(config):
    cfg = SceneConfig(**{
        f: getattr(config, f) for f in SceneConfig.__dataclass_fields__
    })
    if ((cfg.integrator, cfg.rfilter, cfg.sampler) != ("path", "box", "independent")
            or cfg.intersector not in ("brute", "cluster")):
        raise NotImplementedError(f"scene configuration not ported: {config}")
    if cfg.compact is not None:
        cfg.compact = tuple(float(f) for f in cfg.compact)
    return cfg


def scene_from_numpy(arrays, config, device="cpu"):
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
        if kid == bsdf_mod.DIFFUSE:
            stacks[kid] = DiffuseParams(get(pre + "reflectance"))
        elif kid == bsdf_mod.ROUGHCONDUCTOR:
            stacks[kid] = RoughConductorParams(*(
                get(pre + f) for f in RoughConductorParams._fields
            ))
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
    bsdfs = bsdf_mod.BSDFTable(
        mat_type=get("bsdfs.mat_type", torch.int64),
        mat_slot=get("bsdfs.mat_slot", torch.int64),
        stacks=stacks,
    )

    em_type = get("emitters.em_type", torch.int64)
    if not ((em_type == em_mod.CONSTANT) | (em_type == em_mod.AREA)).all() or (
        int(a["emitters.env_index"]) >= 0 or "emitters.proj_index" in a
    ):
        raise NotImplementedError("only area and constant emitters are ported")
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
    )
    used.add("emitters.background_index")

    clusters = None
    if "clusters.slabs" in a:
        used.update(f"clusters.{f}" for f in ("sc_box", "cl_box", "cl_meta", "slabs"))
        # the JAX slabs are (C, NFIELDS, 128) field-major with padding
        # lanes; the port's are (C, L, NFIELDS) slot-major
        slabs = a["clusters.slabs"].transpose(0, 2, 1)[:, :cl_mod.L, :cl_mod.NFIELDS]
        clusters = cl_mod.cluster_set(
            a["clusters.sc_box"], a["clusters.cl_box"], a["clusters.cl_meta"],
            np.ascontiguousarray(slabs), device,
        )

    if int(a["sensor.sensor_type"]) != sensor_mod.PERSPECTIVE:
        raise NotImplementedError("only the perspective sensor is ported")
    used.add("sensor.sensor_type")
    sensor = sensor_mod.Sensor(
        to_world=get("sensor.to_world"),
        fov_x=get("sensor.fov_x"),
        near_clip=get("sensor.near_clip"),
    )
    if a.get("media.m_type", np.zeros(0)).size:
        raise NotImplementedError("participating media are not ported")
    checked = ("shadow_geometry.", "shadow_clusters.", "clusters.", "sdf.",
               "bsdfs.")
    for k in a:
        if k.startswith(checked) and k not in used:
            raise NotImplementedError(f"scene leaf '{k}' is not ported")
    cfg = _config(config)
    if (cfg.intersector == "cluster") != (clusters is not None):
        raise NotImplementedError("cluster intersector without clusters")
    return Scene(
        geometry=geometry, bsdfs=bsdfs, emitters=emitters, sensor=sensor,
        config=cfg, clusters=clusters,
        has_cylinders=bool((a["geometry.prim_type"] == geo.CYLINDER).any()),
    )
