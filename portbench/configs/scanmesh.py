"""The scanmesh scene as a scene dict: a scanned object at a real scan's
triangle count under measured materials, frozen here as the `scanmesh`
configuration's inputs.

The object is a closed cube-sphere of 6 * n_quads**2 quads (n_quads = 776:
7,226,112 triangles, 0.1 % over the XYZ RGB Asian Dragon's 7,219,045 in
the Stanford 3D Scanning Repository), each face's grid bent onto the
sphere by the tangent warp and displaced radially by a seeded field of
octaves of rectified sines, whose creases are deep enough that light
leaving the surface strikes it again. Smooth (area-weighted) vertex
normals; the faces in n_materials bands of height, each band a mesh
holding only the vertices its faces use, painted with matpreview's
synthetic MERL tables; matpreview's GGX floor, area light and sky, and its
camera moved back (matpreview.py beside this file). numpy only, with no
loop over faces or vertices; the same arguments give the same dict.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# the field: per octave (frequency, amplitude), WAVES sines each
OCTAVES = ((3.0, 1.0), (6.0, 0.5), (12.0, 0.25), (24.0, 0.12), (48.0, 0.06))
WAVES = 4
# the object's radius at its highest point
RADIUS = 1.1
# matpreview's camera moved back along its line of sight, so that the
# object spans about two thirds of the film
EYE, TARGET = (0.0, 1.75, -3.96), (0.0, 0.1, 0.0)


def _matpreview():
    import importlib.util

    path = Path(__file__).with_name("matpreview.py")
    spec = importlib.util.spec_from_file_location("portbench_matpreview_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cube_sphere(n_quads):
    """(unit directions (V, 3) float64, faces (F, 3) int64) of a closed
    cube-sphere: the integer points of the surface of the cube [0, n]^3
    (V = 6 n^2 + 2, each shared by the faces that meet there), two
    triangles a quad wound outward, F = 12 n^2."""
    n = int(n_quads)
    g = np.arange(n + 1)
    ii, jj = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    keys, quads = [], []
    m = n + 1
    for axis in range(3):
        u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
        for side in (0, n):
            c = np.empty((ii.size, 3), np.int64)
            c[:, axis], c[:, u_ax], c[:, v_ax] = side, ii, jj
            keys.append((c[:, 0] * m + c[:, 1]) * m + c[:, 2])
            base = ii.size * len(quads)
            q = (ii * m + jj).reshape(m, m)[:-1, :-1].ravel() + base
            # corners (i, j), (i+1, j), (i+1, j+1), (i, j+1): e_u x e_v is
            # e_axis, outward on the far side, inward on the near one
            quad = np.stack([q, q + m, q + m + 1, q + 1], 1)
            quads.append(quad if side == n else quad[:, ::-1])
    uniq, inv = np.unique(np.concatenate(keys), return_inverse=True)
    quads = inv.ravel()[np.concatenate(quads)]
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    lattice = np.stack([uniq // (m * m), (uniq // m) % m, uniq % m], 1)
    # the tangent warp evens out the quads' sizes over each face
    q = np.tan((np.pi / 4) * (2.0 * lattice / n - 1.0))
    return q / np.linalg.norm(q, axis=1, keepdims=True), faces


def radius(dirs, seed):
    """The displaced radius of unit directions (V, 3): 1 plus octaves of
    |sin(f w.x + p)| along seeded directions w, whose zeros cut V-shaped
    creases, scaled so that the highest point lies at RADIUS."""
    rng = np.random.default_rng(seed)
    r = np.ones(dirs.shape[0])
    for freq, amp in OCTAVES:
        w = rng.normal(size=(WAVES, 3))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        phase = rng.uniform(0.0, 2.0 * np.pi, WAVES)
        # the sines in float32, several times as fast as in float64 here
        arg = (freq * (dirs @ w.T) + phase).astype(np.float32)
        r += (amp / WAVES) * np.abs(np.sin(arg)).sum(1, dtype=np.float64)
    return r * (RADIUS / r.max())


def vertex_normals(v, f):
    """Area-weighted smooth vertex normals (V, 3) float32, summed by
    bincount."""
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    idx = f.T.ravel()
    n = np.stack([np.bincount(idx, weights=np.tile(fn[:, k], 3), minlength=len(v))
                  for k in range(3)], 1)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)).astype(np.float32)


def scan_object(n_quads=776, seed=7):
    """(vertices (V, 3) float32, faces (F, 3) int64, normals (V, 3)
    float32) of the displaced cube-sphere."""
    dirs, f = cube_sphere(n_quads)
    v = (dirs * radius(dirs, seed)[:, None]).astype(np.float32)
    return v, f, vertex_normals(v, f)


def bands(v, f, n_bands):
    """The faces in n_bands bands of centroid height (y) of equal size:
    (faces of band b) as index arrays, ascending."""
    height = v[f[:, 0], 1] + v[f[:, 1], 1] + v[f[:, 2], 1]
    order = np.argsort(height, kind="stable")
    return [np.sort(order[i * len(f) // n_bands:(i + 1) * len(f) // n_bands])
            for i in range(n_bands)]


def build(res, spp, depth, n_quads=776, n_materials=10, seed=7):
    """The scene dict at a res x res film, spp samples a pixel and path
    depth `depth` (no compaction schedule: the configuration stores one)."""
    mp = _matpreview()
    d = mp.build(res, spp, depth, n_sub=0, n_materials=1)
    del d["blob_0"]
    d["sensor"]["to_world"] = mp.look_at(EYE, TARGET, [0, 1, 0])
    v, f, vn = scan_object(n_quads, seed)
    used = np.zeros(len(v), bool)
    for i, fb in enumerate(bands(v, f, n_materials)):
        faces = f[fb]
        used[:] = False
        used[faces.ravel()] = True
        keep = np.flatnonzero(used)
        remap = np.cumsum(used) - 1
        d[f"scan_{i}"] = {
            "type": "mesh", "vertices": v[keep], "faces": remap[faces].astype(np.int32),
            "normals": vn[keep],
            "bsdf": {"type": "merl", "table": mp.synthetic_merl_table(
                0.08 + 0.04 * i, mp.BAND_COLORS[i % len(mp.BAND_COLORS)])},
        }
    return d
