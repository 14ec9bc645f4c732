"""Emitters: the constant (sky) emitter and scene-level NEE sampling.

PyTorch port of the constant-emitter part of
mitsuba_customization_tpu/render/emitters.py: `EmitterTable`,
`sample_direction`, `eval_hit`, `pdf_hit_direction`, `pdf_miss_direction`
and `eval_background`. Area and the other emitter types are not ported;
the scene loader rejects them, so no surface in a ported scene emits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core.distr import DiscreteDistribution
from mitsuba_customization_tpu_torch.core.warp import square_to_uniform_sphere
from mitsuba_customization_tpu_torch.render.records import DirectionSample

AREA = 0
CONSTANT = 1

INV_FOUR_PI = 1.0 / (4.0 * math.pi)


class EmitterTable(NamedTuple):
    """All emitters of a scene (K of them)."""

    em_type: torch.Tensor  # (K,) int64
    select: DiscreteDistribution  # NEE selection over the K emitters
    radiance: torch.Tensor  # (K, 3)
    background_index: int  # constant emitter id, -1 if none

    @property
    def n_emitters(self):
        return self.em_type.shape[0]


def sample_direction(table: EmitterTable, p_ref, sample3) -> DirectionSample:
    """Pick an emitter, sample a direction toward it; radiance and pdf in
    solid angle at p_ref. sample3 (..., 3): emitter selection (reused) and
    a 2-D direction sample."""
    k, u0 = table.select.sample_reuse(sample3[..., 0])
    u2 = torch.stack([u0, sample3[..., 1]], -1)
    sel_pmf = table.select.eval_pmf(k)
    is_const = table.em_type[k] == CONSTANT
    shape = p_ref.shape[:-1]
    pdf = torch.full(shape, INV_FOUR_PI, device=p_ref.device)
    return DirectionSample(
        d=torch.where(is_const[..., None], square_to_uniform_sphere(u2), 0.0),
        dist=torch.full(shape, float("inf"), device=p_ref.device),
        pdf=torch.where(is_const, pdf * sel_pmf, 0.0),
        radiance=torch.where(is_const[..., None], table.radiance[k], 0.0),
        delta=torch.zeros(shape, dtype=torch.bool, device=p_ref.device),
    )


def pdf_hit_direction(table: EmitterTable, si, p_ref):
    """NEE density of a BSDF ray that hit si: zero, since no surface of a
    ported scene emits (area emitters are not ported)."""
    return torch.zeros_like(si.t)


def pdf_miss_direction(table: EmitterTable, d_world):
    """NEE density of a BSDF ray that escaped (the constant sky)."""
    p = torch.zeros(d_world.shape[:-1], device=d_world.device)
    if table.background_index >= 0:
        p = p + table.select.pmf[table.background_index] * INV_FOUR_PI
    return p


def eval_background(table: EmitterTable, d_world):
    """Radiance carried by escaped rays."""
    rad = torch.zeros_like(d_world)
    if table.background_index >= 0:
        rad = rad + table.radiance[table.background_index]
    return rad


def eval_hit(table: EmitterTable, si):
    """Radiance emitted by a surface hit toward the ray origin (area
    emitters, front side only)."""
    valid = si.emitter >= 0
    em = si.emitter.clamp(min=0)
    front = (si.n * si.to_world(si.wi)).sum(-1) > 0.0
    is_area = table.em_type[em] == AREA
    return torch.where(
        (valid & front & is_area)[..., None], table.radiance[em], 0.0
    )
