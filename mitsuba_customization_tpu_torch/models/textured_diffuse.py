"""Diffuse BSDF with a textured reflectance (bitmap, checkerboard, mesh
attribute or volume).

PyTorch port of mitsuba_customization_tpu/models/textured_diffuse.py:
mitsuba3's diffuse.cpp with a nested texture, compiled as its own kernel
so the masked dispatch (models/bsdf.py) stays branch-free. Lanes carry a
texture binding (`slot` into the scene's TextureStack) and evaluate it at
their texture coordinates `uv`.
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.warp import (
    INV_PI,
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu_torch.models import texture as tex_mod

# The dispatch contract (models/bsdf.py reads these): the stack goes in
# whole with each lane's slot, its texture coordinates and its lane mask.
NEEDS_SLOT = True
NEEDS_UV = True
NEEDS_MASK = True


def _reflectance(stack, slot, uv, mask=None):
    if uv is None:
        return m.gather_rows(stack.value0, slot)
    if mask is not None:
        uv = torch.where(mask[..., None], uv, 0.0)
    return tex_mod.eval(stack, slot, uv)


def eval(stack, wi, wo, slot=None, uv=None, mask=None):
    refl = _reflectance(stack, slot, uv, mask)
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    val = refl * (INV_PI * torch.clamp(m.cos_theta(wo), min=0.0))[..., None]
    return torch.where(active[..., None], val, 0.0)


def pdf(stack, wi, wo, slot=None, uv=None, mask=None):
    active = (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return torch.where(active, square_to_cosine_hemisphere_pdf(wo), 0.0)


def sample(stack, wi, sample2, sample1=None, slot=None, uv=None, mask=None):
    """Returns (wo, pdf, weight, sampled_delta)."""
    wo = square_to_cosine_hemisphere(sample2)
    p = square_to_cosine_hemisphere_pdf(wo)
    refl = _reflectance(stack, slot, uv, mask)
    active = (m.cos_theta(wi) > 0.0) & (p > 0.0)
    return (wo, torch.where(active, p, 0.0),
            torch.where(active[..., None], refl, 0.0), torch.zeros_like(active))
