"""Ray, interaction and sampling records (structure-of-arrays over lanes).

PyTorch port of mitsuba_customization_tpu/render/records.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mitsuba_customization_tpu_torch.core.frame import Frame


class Ray(NamedTuple):
    """Ray bundle: origin (..., 3), unit direction (..., 3), maxt (...)."""

    o: torch.Tensor
    d: torch.Tensor
    maxt: torch.Tensor

    @staticmethod
    def make(o, d, maxt=None):
        if maxt is None:
            maxt = torch.full(o.shape[:-1], float("inf"), dtype=o.dtype,
                              device=o.device)
        return Ray(o=o, d=d, maxt=maxt)


class SurfaceInteraction(NamedTuple):
    """Per-lane hit record.

    valid (...) bool; t (...); p, n (..., 3); frame: shading Frame;
    uv (..., 2); wi (..., 3) incident direction in the local shading frame
    (pointing away from the surface); prim, mat_id, emitter (...) int64
    (prim and emitter are -1 where there is none); bary (..., 2).
    """

    valid: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    n: torch.Tensor
    frame: Frame
    uv: torch.Tensor
    wi: torch.Tensor
    prim: torch.Tensor
    mat_id: torch.Tensor
    emitter: torch.Tensor
    bary: Optional[torch.Tensor] = None

    def to_world(self, v_local):
        return self.frame.to_world(v_local)

    def to_local(self, v_world):
        return self.frame.to_local(v_world)


class DirectionSample(NamedTuple):
    """Emitter direction sample: d (..., 3), dist (...), pdf (...) in solid
    angle (0 = invalid), radiance (..., 3), delta (...) bool; p_area (...)
    the area density of the sampled point on an area emitter (times the
    selection pmf; 0 for other emitters), which bdpt's MIS reads."""

    d: torch.Tensor
    dist: torch.Tensor
    pdf: torch.Tensor
    radiance: torch.Tensor
    delta: torch.Tensor
    p_area: torch.Tensor
