"""Smooth (perfectly specular) conductor: a delta BSDF. eval and pdf are
zero; sample returns the mirror direction with weight F * tint.

PyTorch port of mitsuba_customization_tpu/models/conductor.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models.fresnel import fresnel_conductor


class ConductorParams(NamedTuple):
    eta: torch.Tensor  # (..., 3)
    k: torch.Tensor  # (..., 3)
    specular_reflectance: torch.Tensor  # (..., 3)


def eval(params: ConductorParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape), device=wi.device)


def pdf(params: ConductorParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape)[:-1], device=wi.device)


def sample(params: ConductorParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight, sampled_delta = True); the delta event's
    pdf is reported as 1."""
    wo = m.reflect(wi)
    active = m.cos_theta(wi) > 0.0
    weight = params.specular_reflectance * fresnel_conductor(
        m.cos_theta(wi), params.eta, params.k)
    return (wo, torch.where(active, 1.0, 0.0),
            torch.where(active[..., None], weight, 0.0), torch.ones_like(active))
