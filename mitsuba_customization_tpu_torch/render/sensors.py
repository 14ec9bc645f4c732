"""Perspective sensor: film positions -> primary rays.

PyTorch port of the perspective branch of
mitsuba_customization_tpu/render/sensors.py (`look_at`, `make_sensor`,
`sample_ray`). The other sensor types are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.render.records import Ray

PERSPECTIVE = 0


class Sensor(NamedTuple):
    """Camera parameters (0-d float32 tensors and a (4, 4) camera-to-world
    matrix). Camera space: +z = view direction, +x right, +y up."""

    to_world: torch.Tensor
    fov_x: torch.Tensor  # horizontal field of view in degrees
    near_clip: torch.Tensor


def look_at(origin, target, up):
    """Camera-to-world matrix (mitsuba3 Transform4f::look_at), numpy f32."""
    origin = np.asarray(origin, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    mat = np.eye(4)
    mat[:3, 0] = right
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return mat.astype(np.float32)


def make_sensor(device, to_world=None, fov_x=45.0, near_clip=1e-3):
    if to_world is None:
        to_world = np.eye(4, dtype=np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Sensor(
        to_world=f32(to_world),
        fov_x=f32(fov_x),
        near_clip=f32(near_clip),
    )


def sample_ray(sensor: Sensor, film_uv, aspect):
    """Primary rays for film_uv (..., 2) in [0,1)^2, (0,0) = top-left;
    aspect = width / height. Returns a world-space Ray."""
    tan_half = torch.tan(sensor.fov_x * (math.pi / 180.0) * 0.5)
    # camera-space film plane at z = 1: x right, y up
    x = (2.0 * film_uv[..., 0] - 1.0) * tan_half
    y = (1.0 - 2.0 * film_uv[..., 1]) * tan_half / aspect
    d_cam = m.normalize(torch.stack([x, y, torch.ones_like(x)], -1))

    rot = sensor.to_world[:3, :3]
    trans = sensor.to_world[:3, 3]
    # rot @ d written elementwise (no matmul); the camera origin is 0
    d_w = m.normalize(
        d_cam[..., 0:1] * rot[:, 0] + d_cam[..., 1:2] * rot[:, 1]
        + d_cam[..., 2:3] * rot[:, 2]
    )
    o_w = trans.expand_as(d_w) + d_w * sensor.near_clip
    return Ray.make(o_w, d_w)
