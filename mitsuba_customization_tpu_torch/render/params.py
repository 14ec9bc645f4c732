"""Build a port Scene from the leaves of a JAX-package Scene.

`scene_from_numpy(arrays, config, device)` takes the JAX Scene's leaves as
{path: np.ndarray}, with paths as `jax.tree_util.keystr` writes them (for
example ".geometry.p0" or ".bsdfs.stacks[4].sampling.cdf_cond"), and its
SceneConfig (any object with the same attribute names). The parity tests
use it to run both packages on identical arrays. Only the subset the port
renders is accepted; anything else raises NotImplementedError.
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
    intersector = getattr(config, "intersector", "brute")
    if (cfg.integrator, cfg.rfilter, cfg.sampler, intersector) != (
        "path", "box", "independent", "brute"
    ) or getattr(config, "compact", None) is not None:
        raise NotImplementedError(f"scene configuration not ported: {config}")
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
    if (geometry.prim_type == geo.CYLINDER).any() or (geometry.emitter_id >= 0).any():
        raise NotImplementedError("cylinders and area emitters are not ported")

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
        raise NotImplementedError("only constant emitters are ported")
    emitters = em_mod.EmitterTable(
        em_type=em_type,
        select=DiscreteDistribution(
            get("emitters.select.pmf"), get("emitters.select.cdf")
        ),
        radiance=get("emitters.radiance"),
        background_index=int(a["emitters.background_index"]),
    )
    used.add("emitters.background_index")

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
    for k in a:
        if k.startswith(("shadow_geometry.", "clusters.", "sdf.", "bsdfs.")) \
                and k not in used:
            raise NotImplementedError(f"scene leaf '{k}' is not ported")
    return Scene(
        geometry=geometry, bsdfs=bsdfs, emitters=emitters, sensor=sensor,
        config=_config(config),
    )
