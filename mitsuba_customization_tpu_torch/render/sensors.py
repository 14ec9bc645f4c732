"""Sensors: perspective, thinlens, orthographic, radiancemeter,
irradiancemeter, distant and batch.

PyTorch port of mitsuba_customization_tpu/render/sensors.py (`Sensor`,
`look_at`, `make_sensor`, `sample_ray`). A sensor maps film positions and
aperture samples to primary rays. `radiancemeter` shoots one ray (+z in
sensor space) per sample; `irradiancemeter` cosine-samples the +z
hemisphere (render multiplies the film by SceneConfig.sensor_scale = pi);
`distant` records radiance arriving along +z onto a target-plane film. A
batch sensor (mitsuba3 src/sensors/batch.cpp) carries its children's
fields stacked on a leading axis and `child_types`: the film splits into
vertical strips, one per child.

The JAX package computes every type's rays and selects with `where`; the
port computes only the types present (a host fact: `types_present` reads
the sensor's type tensor, once per call of sample_ray unless the caller
hands it in as `present`, as a captured frame's plan does), so the rays
are the same and fewer kernels run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_uniform_disk_concentric,
)
from mitsuba_customization_tpu_torch.render.records import Ray

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
RADIANCEMETER = 3
IRRADIANCEMETER = 4
DISTANT = 5

SENSOR_TYPES = {
    "perspective": PERSPECTIVE,
    "thinlens": THINLENS,
    "orthographic": ORTHOGRAPHIC,
    "radiancemeter": RADIANCEMETER,
    "irradiancemeter": IRRADIANCEMETER,
    "distant": DISTANT,
}


class Sensor(NamedTuple):
    """Camera parameters: 0-d tensors and a (4, 4) camera-to-world matrix,
    or for a batch sensor the children's fields stacked on a leading (B,)
    axis and `child_types` set. Camera space: +z = view direction, +x
    right, +y up."""

    sensor_type: torch.Tensor  # () int64, or (B,) for a batch sensor
    to_world: torch.Tensor  # (4, 4), (B, 4, 4) for batch
    fov_x: torch.Tensor  # horizontal field of view in degrees
    aperture_radius: torch.Tensor  # thinlens
    focus_distance: torch.Tensor  # thinlens
    near_clip: torch.Tensor
    ortho_scale: torch.Tensor  # half-width of the orthographic view volume
    child_types: Optional[torch.Tensor] = None  # (B,) int64 marks a batch sensor


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


def make_sensor(sensor_type=PERSPECTIVE, to_world=None, fov_x=45.0, aperture_radius=0.0,
                focus_distance=1.0, near_clip=1e-3, ortho_scale=1.0, *, device):
    """A Sensor on `device`; sensor_type is a name of SENSOR_TYPES or its
    integer."""
    if isinstance(sensor_type, str):
        if sensor_type not in SENSOR_TYPES:
            raise ValueError(f"unknown sensor type '{sensor_type}'")
        sensor_type = SENSOR_TYPES[sensor_type]
    if to_world is None:
        to_world = np.eye(4, dtype=np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Sensor(
        sensor_type=torch.as_tensor(int(sensor_type), dtype=torch.int64, device=device),
        to_world=f32(to_world),
        fov_x=f32(fov_x),
        aperture_radius=f32(aperture_radius),
        focus_distance=f32(focus_distance),
        near_clip=f32(near_clip),
        ortho_scale=f32(ortho_scale),
    )


def stack_sensors(children):
    """A batch sensor from child Sensors (their fields stacked)."""
    stacked = Sensor(*(torch.stack(fs) for fs in zip(*(c[:-1] for c in children))))
    return stacked._replace(child_types=stacked.sensor_type)


def _col(x):
    """A per-lane (N,) field as (N, 1); a shared 0-d one as it is."""
    return x[..., None] if x.dim() > 0 else x


def types_present(sensor):
    """The sensor types of a sensor, or of a batch sensor's children (a
    host fact: the set of ints)."""
    types = sensor.sensor_type if sensor.child_types is None else sensor.child_types
    return {int(t) for t in types.reshape(-1).tolist()}


def sample_ray(sensor: Sensor, film_uv, aperture_uv, aspect, *, present=None):
    """World-space primary rays for film_uv (..., 2) in [0,1)^2, (0,0) =
    top-left, aperture_uv (..., 2) (thinlens; may be None when no thinlens
    type is present) and aspect = width / height. present: the sensor's
    types_present, read here when None.

    A batch sensor selects each lane's child by its strip of the film and
    reads that child's fields by plain indexing, then runs the per-type
    formulas below with per-lane fields."""
    if present is None:
        present = types_present(sensor)
    if sensor.child_types is not None:
        b = sensor.child_types.shape[0]
        xi = torch.clamp((film_uv[..., 0] * b).to(torch.int64), 0, b - 1)
        local_x = film_uv[..., 0] * b - xi
        per_lane = Sensor(*(f[xi] for f in sensor[:-1]))
        uv2 = torch.stack([local_x, film_uv[..., 1]], -1)
        return _sample_ray(per_lane, uv2, aperture_uv, aspect / b, present)
    return _sample_ray(sensor, film_uv, aperture_uv, aspect, present)


def _sample_ray(sensor, film_uv, aperture_uv, aspect, present):
    """sample_ray of one sensor (0-d fields) or of per-lane fields, for the
    sensor types in `present`."""
    st = sensor.sensor_type
    x = y = tan_half = d_persp = None
    if present & {PERSPECTIVE, THINLENS, ORTHOGRAPHIC, DISTANT}:
        tan_half = torch.tan(sensor.fov_x * (math.pi / 180.0) * 0.5)
        # camera-space film plane at z = 1: x right, y up
        x = (2.0 * film_uv[..., 0] - 1.0) * tan_half
        y = (1.0 - 2.0 * film_uv[..., 1]) * tan_half / aspect
    if present & {PERSPECTIVE, THINLENS}:
        d_persp = m.normalize(torch.stack([x, y, torch.ones_like(x)], -1))
    shape = film_uv.shape[:-1] + (3,)
    zero = film_uv.new_zeros(())
    # a row of an identity made on the device: no host-to-device copy
    z_axis = torch.eye(3, dtype=torch.float32, device=film_uv.device)[2].expand(shape)
    rays = {}  # type -> (o_cam, d_cam)
    if PERSPECTIVE in present:
        rays[PERSPECTIVE] = (zero.expand(shape), d_persp)
    if THINLENS in present:
        # origin on the aperture disk, aimed at the focus plane
        ap = square_to_uniform_disk_concentric(aperture_uv) * _col(sensor.aperture_radius)
        o_lens = torch.stack([ap[..., 0], ap[..., 1], torch.zeros_like(x)], -1)
        focus_p = d_persp * _col(m.safe_div(sensor.focus_distance, d_persp[..., 2]))
        rays[THINLENS] = (o_lens, m.normalize(focus_p - o_lens))
    if present & {ORTHOGRAPHIC, DISTANT}:
        o_ortho = torch.stack([x / tan_half * sensor.ortho_scale,
                               y / tan_half * sensor.ortho_scale, torch.zeros_like(x)], -1)
        rays[ORTHOGRAPHIC] = (o_ortho, z_axis)
        # the target plane pushed back far outside the scene
        rays[DISTANT] = (o_ortho - 1.0e4 * z_axis, z_axis)
    if RADIANCEMETER in present:
        rays[RADIANCEMETER] = (zero.expand(shape), z_axis)
    if IRRADIANCEMETER in present:
        rays[IRRADIANCEMETER] = (zero.expand(shape),
                                 square_to_cosine_hemisphere(film_uv))
    kinds = sorted(present)
    o_cam, d_cam = rays[kinds[0]]
    for k in kinds[1:]:
        sel = _col(st == k)
        o_cam = torch.where(sel, rays[k][0], o_cam)
        d_cam = torch.where(sel, rays[k][1], d_cam)

    rot = sensor.to_world[..., :3, :3]
    trans = sensor.to_world[..., :3, 3]

    def rotate(v):
        # rot @ v written elementwise (no matmul), for a shared (3, 3)
        # rotation or a per-lane (N, 3, 3) one
        return (v[..., 0:1] * rot[..., :, 0] + v[..., 1:2] * rot[..., :, 1]
                + v[..., 2:3] * rot[..., :, 2])

    d_w = m.normalize(rotate(d_cam))
    o_w = rotate(o_cam) + trans + d_w * _col(sensor.near_clip)
    return Ray.make(o_w, d_w)
