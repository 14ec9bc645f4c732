"""Normal and bump mapping: a per-material perturbation of the shading
frame.

PyTorch port of mitsuba_customization_tpu/models/normalmap.py (mitsuba3
src/bsdfs/{normalmap,bumpmap}.cpp). The wrapped child keeps its own
kernel; the perturbation applies once per interaction in the integrator
(apply_normal_maps) through a per-material binding in the BSDFTable
(`normal_tex`, `nm_slot`). Bump maps become normal maps when the scene is
loaded, by a finite-difference height gradient (bump_to_normal).
"""

from __future__ import annotations

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.frame import Frame
from mitsuba_customization_tpu_torch.models import texture as tex_mod


def bump_to_normal(height, scale=1.0):
    """(H, W) height bitmap (numpy) -> (H, W, 3) tangent-space normal map
    in the [0, 1] encoding, (0.5, 0.5, 1) = unperturbed."""
    h = np.asarray(height, np.float32)
    if h.ndim == 3:
        h = h.mean(-1)
    gy, gx = np.gradient(h)
    n = np.stack([-gx * scale * h.shape[1], -gy * scale * h.shape[0], np.ones_like(h)],
                 axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def apply_normal_maps(bsdfs, si):
    """si with the shading frame of every lane rebuilt from its (perturbed,
    where the material binds a normal map) normal, and wi re-localized.
    Without a normal map in the scene (a host fact) si is returned as it
    is."""
    if bsdfs.normal_tex is None:
        return si
    slot = m.gather_rows(bsdfs.nm_slot, si.mat_id)
    has = (slot >= 0) & si.valid
    enc = tex_mod.eval(bsdfs.normal_tex, torch.clamp(slot, min=0), si.uv)
    n_local = m.normalize(enc * 2.0 - 1.0)
    n_world = m.normalize(si.frame.to_world(n_local))
    frame = Frame.from_normal(torch.where(has[..., None], n_world, si.frame.n))
    return si._replace(frame=frame, wi=frame.to_local(si.frame.to_world(si.wi)))
