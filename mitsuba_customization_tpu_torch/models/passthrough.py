"""Delta pass-through lobe: wo = -wi with the transmittance as weight (the
transparent component of the `mask` BSDF).

PyTorch port of mitsuba_customization_tpu/models/passthrough.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m


class PassthroughParams(NamedTuple):
    transmittance: torch.Tensor  # (..., 3)


def eval(params: PassthroughParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape), device=wi.device)


def pdf(params: PassthroughParams, wi, wo):
    return torch.zeros(torch.broadcast_shapes(wi.shape, wo.shape)[:-1], device=wi.device)


def sample(params: PassthroughParams, wi, sample2, sample1=None):
    """Returns (-wi, pdf 1, transmittance, sampled_delta = True)."""
    active = m.cos_theta(wi).abs() > 0.0
    return (-wi, torch.where(active, 1.0, 0.0),
            torch.where(active[..., None], params.transmittance, 0.0),
            torch.ones_like(active))
