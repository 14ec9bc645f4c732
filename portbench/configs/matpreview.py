"""The matpreview scene as a scene dict: the inputs of the `matpreview`
configuration, frozen here so that a change to the program's own scene
builders cannot move the benchmark's inputs.

A displaced icosphere blob of 20 * 4**n_sub triangles (n_sub = 5: 20,480)
painted in latitude bands with synthetic MERL-format tables (the
repository ships no measured `.binary` tables), a GGX rough-conductor
floor, a rectangle area light and a constant sky, seen by a perspective
camera: Mitsuba 3's material-preview set-up. numpy only; the same
arguments give the same dict.
"""

from __future__ import annotations

import numpy as np

BAND_COLORS = [
    [1.0, 0.8, 0.5], [0.4, 0.6, 1.0], [1.0, 0.4, 0.4], [0.5, 1.0, 0.6],
    [0.9, 0.9, 0.9], [0.8, 0.5, 1.0], [1.0, 1.0, 0.4], [0.4, 1.0, 1.0],
    [1.0, 0.6, 0.8], [0.6, 0.7, 0.9],
]


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def icosphere_blob(n_sub=5, bump=0.18):
    """(vertices (V, 3) float32, faces (F, 3) int32), F = 20 * 4**n_sub: an
    icosphere subdivided n_sub times, displaced radially by
    1 + bump sin(3 theta) cos(2 phi)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = _normalize(np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64))
    f = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(n_sub):
        mid = {}
        nv = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(nv)
                nv.append(_normalize((v[a] + v[b])[None])[0])
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(nv)
        f = np.asarray(nf, np.int64)
    theta = np.arccos(np.clip(v[:, 2], -1, 1))
    phi = np.arctan2(v[:, 1], v[:, 0])
    v = v * (1.0 + bump * np.sin(3.0 * theta) * np.cos(2.0 * phi))[:, None]
    return v.astype(np.float32), f.astype(np.int32)


def vertex_normals(v, f):
    """Area-weighted smooth vertex normals (V, 3) float32."""
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v, dtype=np.float64)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    return _normalize(n + 1e-20).astype(np.float32)


def face_bands(v, f, n_bands):
    """The faces in n_bands contiguous bands of centroid z (index arrays)."""
    order = np.argsort(v[f].mean(axis=1)[:, 2], kind="stable")
    return [np.sort(order[i * len(f) // n_bands:(i + 1) * len(f) // n_bands])
            for i in range(n_bands)]


def synthetic_merl_table(lobe_width, color):
    """A MERL-format (90, 90, 180, 3) float32 table: a diffuse floor plus a
    specular ridge at theta_h ~ 0 of the given width, tinted `color`."""
    n_th, n_td, n_pd = 90, 90, 180
    th = (np.pi / 2) * ((np.arange(n_th) + 0.5) / n_th) ** 2
    lobe = np.exp(-((np.tan(np.minimum(th, 1.5)) / lobe_width) ** 2))
    mono = 0.03 + 0.6 * np.broadcast_to(lobe[:, None, None], (n_th, n_td, n_pd))
    return (mono[..., None] * np.asarray(color)).astype(np.float32)


def look_at(origin, target, up):
    """Camera-to-world 4x4 float32 (Mitsuba 3's Transform4f::look_at)."""
    origin, target, up = (np.asarray(a, np.float64) for a in (origin, target, up))
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    mat = np.eye(4)
    mat[:3, 0], mat[:3, 1], mat[:3, 2], mat[:3, 3] = right, np.cross(fwd, right), fwd, origin
    return mat.astype(np.float32)


def build(res, spp, depth, n_sub=5, n_materials=10):
    """The scene dict at a res x res film, spp samples a pixel and path
    depth `depth` (no compaction schedule: the harness probes one)."""
    v, f = icosphere_blob(n_sub=n_sub)
    vn = vertex_normals(v, f)
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {
            "type": "perspective",
            "fov": 40,
            "to_world": look_at([0, 1.6, -3.6], [0, 0.1, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "floor": {
            "type": "rectangle",
            "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 12.0,
                         "translate": [0, -1.2, 0]},
            "bsdf": {"type": "roughconductor", "alpha": 0.25},
        },
        "light": {
            "type": "rectangle",
            "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "scale": 1.2,
                         "translate": [1.5, 3.2, -1.0]},
            "emitter": {"type": "area", "radiance": [18.0, 17.0, 15.0]},
        },
        "sky": {"type": "constant", "radiance": [0.08, 0.09, 0.12]},
    }
    for i, fi in enumerate(face_bands(v, f, n_materials)):
        d[f"blob_{i}"] = {
            "type": "mesh", "vertices": v, "faces": f[fi], "normals": vn,
            "bsdf": {"type": "merl", "table": synthetic_merl_table(
                0.08 + 0.04 * i, BAND_COLORS[i % len(BAND_COLORS)])},
        }
    return d
