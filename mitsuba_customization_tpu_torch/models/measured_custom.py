"""The custom measured-BRDF container (any resolution), reader and writer.

PyTorch port of mitsuba_customization_tpu/models/measured_custom.py:

    char     magic[8]  = "CMBRDF01"
    int32    dims[3]                     (n_theta_h, n_theta_d, n_phi_d)
    float32  scale[3]                    per-channel scale applied on read
    float64  data[3 * prod(dims)]        channel-major planes, MERL index
                                         order within a plane

Evaluation and sampling are models/tabulated's (eval, eval_raw, pdf and
sample are its functions, under the JAX package's names here).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from mitsuba_customization_tpu_torch.models import tabulated
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF

MAGIC = b"CMBRDF01"


def read_custom(path):
    """A CMBRDF01 file -> (n_th, n_td, n_pd, 3) float32 table."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        dims = struct.unpack("<3i", f.read(12))
        scale = np.array(struct.unpack("<3f", f.read(12)))
        n = dims[0] * dims[1] * dims[2]
        data = np.fromfile(f, dtype="<f8", count=3 * n)
    if data.size != 3 * n:
        raise ValueError(f"{path}: truncated file")
    table = np.moveaxis(data.reshape(3, *dims), 0, -1) * scale
    return np.maximum(table, 0.0).astype(np.float32)


def write_custom(path, table, scale=(1.0, 1.0, 1.0)):
    """Write a scaled (n_th, n_td, n_pd, 3) table as a CMBRDF01 file."""
    table = np.asarray(table, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    planes = np.moveaxis(table / scale, -1, 0)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<3i", *table.shape[:3]))
        f.write(struct.pack("<3f", *scale.astype(np.float32)))
        planes.astype("<f8").tofile(f)


def load(path, device) -> TabulatedBRDF:
    """A CMBRDF01 file as a BSDF on `device`, its sampling CDFs built."""
    return TabulatedBRDF.build(torch.as_tensor(read_custom(path), device=device))


# the BSDF interface: the shared tabulated core's, as in the JAX package
eval = tabulated.eval
eval_raw = tabulated.eval_raw
pdf = tabulated.pdf
sample = tabulated.sample
