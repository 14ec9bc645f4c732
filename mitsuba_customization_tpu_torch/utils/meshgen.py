"""Procedural mesh generation: the matpreview benchmark object.

A copy of mitsuba_customization_tpu/utils/meshgen.py (numpy only), so the
port builds the matpreview scene without importing the JAX package: a
deterministic displaced icosphere whose subdivision level n gives
20 * 4**n triangles, its area-weighted vertex normals, and latitude bands
for painting several materials onto it.
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def icosphere_blob(n_sub=5, bump=0.18):
    """Deterministic displaced icosphere.

    Returns (vertices (V, 3) f32, faces (F, 3) i32) with F = 20 * 4**n_sub
    (n_sub=5 -> 20480 triangles). `bump` displaces radially with a smooth
    spherical-harmonic-ish pattern so face normals vary like a sculpted
    object rather than a sphere.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v = _normalize(v)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(n_sub):
        mid = {}
        nv = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = _normalize((v[a] + v[b])[None])[0]
                mid[key] = len(nv)
                nv.append(p)
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(nv)
        f = np.asarray(nf, np.int64)
    theta = np.arccos(np.clip(v[:, 2], -1, 1))
    phi = np.arctan2(v[:, 1], v[:, 0])
    r = 1.0 + bump * np.sin(3.0 * theta) * np.cos(2.0 * phi)
    v = v * r[:, None]
    return v.astype(np.float32), f.astype(np.int32)


def vertex_normals(v, f):
    """Area-weighted smooth vertex normals (V, 3) f32."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)  # length = 2*area -> area weighting
    n = np.zeros_like(v, dtype=np.float64)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    return _normalize(n + 1e-20).astype(np.float32)


def face_bands(v, f, n_bands):
    """Partition faces into n_bands contiguous latitude bands (by face
    centroid z), returning a list of face-index arrays. Used to paint
    multiple materials onto one mesh (configs[4]: 10 MERL materials)."""
    cz = v[f].mean(axis=1)[:, 2]
    order = np.argsort(cz, kind="stable")
    return [
        np.sort(order[i * len(f) // n_bands:(i + 1) * len(f) // n_bands])
        for i in range(n_bands)
    ]
