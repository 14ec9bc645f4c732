"""MERL binary BRDF reader and writer.

PyTorch port of mitsuba_customization_tpu/models/merl.py (the reader in
numpy; the JAX package may use its C++ helper, with the same result).
File format:

    int32 dims[3] = {90, 90, 180}          (theta_h, theta_d, phi_d)
    float64 data[3 * 90 * 90 * 180]        channel-major (R plane, G, B)
    idx within a plane = phi_d + theta_d * 180 + theta_h * 180 * 90
    channel scales on read: R 1/1500, G 1.15/1500, B 1.66/1500

Negative entries mark unmeasured configurations and clamp to zero.
Evaluation and sampling are models/tabulated's (eval, eval_raw, pdf and
sample are its functions, under the JAX package's names here).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from mitsuba_customization_tpu_torch.models import tabulated
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF

MERL_DIMS = (90, 90, 180)
MERL_SCALE = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0])


def read_merl(path):
    """A MERL .binary file -> (90, 90, 180, 3) float32 table (sr^-1)."""
    with open(path, "rb") as f:
        dims = struct.unpack("<3i", f.read(12))
        if tuple(dims) != MERL_DIMS:
            raise ValueError(
                f"{path}: MERL dims {dims} != {MERL_DIMS} — "
                "use measured_custom.read_custom for other resolutions"
            )
        n = dims[0] * dims[1] * dims[2]
        data = np.fromfile(f, dtype="<f8", count=3 * n)
    if data.size != 3 * n:
        raise ValueError(f"{path}: truncated MERL file")
    table = np.moveaxis(data.reshape(3, *MERL_DIMS), 0, -1) * MERL_SCALE
    return np.maximum(table, 0.0).astype(np.float32)


def write_merl(path, table):
    """Write a (90, 90, 180, 3) scaled table as a MERL .binary file (the
    inverse of read_merl)."""
    table = np.asarray(table, dtype=np.float64)
    if table.shape != (*MERL_DIMS, 3):
        raise ValueError(f"table shape {table.shape} != {(*MERL_DIMS, 3)}")
    planes = np.moveaxis(table / MERL_SCALE, -1, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", *MERL_DIMS))
        planes.astype("<f8").tofile(f)


def load(path, device) -> TabulatedBRDF:
    """A MERL file as a BSDF on `device`, its sampling CDFs built."""
    return TabulatedBRDF.build(torch.as_tensor(read_merl(path), device=device))


# the BSDF interface: the shared tabulated core's, as in the JAX package
eval = tabulated.eval
eval_raw = tabulated.eval_raw
pdf = tabulated.pdf
sample = tabulated.sample
