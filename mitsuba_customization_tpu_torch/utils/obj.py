"""Wavefront OBJ mesh reader and writer.

A copy of mitsuba_customization_tpu/utils/obj.py (numpy only; mitsuba3
src/shapes/obj.cpp's role), so the port loads OBJ files without importing
the JAX package. `read_obj` returns (vertices (V, 3) f32, faces (F, 3)
i32, normals (V, 3) f32 or None, uvs (V, 2) f32 or None). Polygons are
fan-triangulated; OBJ's per-corner (v/vt/vn) indices are re-indexed per
vertex by splitting vertices on distinct corner tuples.
"""

from __future__ import annotations

import numpy as np


def read_obj(path):
    positions, normals, uvs = [], [], []
    corner_map = {}
    out_pos, out_n, out_uv, faces = [], [], [], []
    has_n = has_uv = False

    def corner(tok):
        nonlocal has_n, has_uv
        if tok in corner_map:
            return corner_map[tok]
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(uvs) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(normals) + ni
        idx = len(out_pos)
        out_pos.append(positions[vi])
        out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
        out_n.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
        if ti is not None:
            has_uv = True
        if ni is not None:
            has_n = True
        corner_map[tok] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                positions.append(tuple(float(x) for x in line.split()[1:4]))
            elif line.startswith("vn "):
                normals.append(tuple(float(x) for x in line.split()[1:4]))
            elif line.startswith("vt "):
                vals = line.split()[1:3]
                uvs.append((float(vals[0]), float(vals[1])))
            elif line.startswith("f "):
                idx = [corner(t) for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[i], idx[i + 1]))

    v = np.asarray(out_pos, dtype=np.float32)
    fc = np.asarray(faces, dtype=np.int32)
    n = np.asarray(out_n, dtype=np.float32) if has_n else None
    uv = np.asarray(out_uv, dtype=np.float32) if has_uv else None
    return v, fc, n, uv


def write_obj(path, vertices, faces):
    """Minimal OBJ writer: positions and triangles."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")
