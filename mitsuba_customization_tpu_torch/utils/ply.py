"""PLY mesh reader (ascii and binary_little_endian) and a binary writer.

A copy of mitsuba_customization_tpu/utils/ply.py's `read_ply` (numpy only;
mitsuba3 src/shapes/ply.cpp's role), with the same return contract as
utils/obj.read_obj: (vertices, faces, normals or None, uvs or None). A
binary face element whose one property is a list of triangles is read in
one step instead of row by row (the same arrays). An ascii face row is
read as its count and indices (the JAX package's reader raises TypeError
on ascii faces). `write_ply` writes binary or ascii files.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_binary_rows(f, count, props):
    """Row-by-row binary records (elements with list properties)."""
    rows = []
    for _ in range(count):
        row = []
        for p in props:
            if p[0] == "list":
                n = np.frombuffer(f.read(np.dtype(p[1]).itemsize), "<" + p[1])[0]
                row.append(np.frombuffer(f.read(int(n) * np.dtype(p[2]).itemsize),
                                         "<" + p[2]))
            else:
                row.append(np.frombuffer(f.read(np.dtype(p[1]).itemsize), "<" + p[1])[0])
        rows.append(row)
    return rows


def _read_binary_triangles(f, count, prop):
    """A face element whose only property is a list: when every face is a
    triangle, its (count, 3) index array; else None and the file position
    is restored."""
    start = f.tell()
    dt = np.dtype([("n", "<" + prop[1]), ("i", "<" + prop[2], (3,))])
    buf = f.read(count * dt.itemsize)
    if len(buf) == count * dt.itemsize:
        rec = np.frombuffer(buf, dt)
        if (rec["n"] == 3).all():
            return rec["i"]
    f.seek(start)
    return None


def read_ply(path):
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            toks = line.decode("ascii", "replace").split()
            if not toks or toks[0] == "comment":
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                cur = (toks[1], int(toks[2]), [])
                elements.append(cur)
            elif toks[0] == "property":
                if toks[1] == "list":
                    cur[2].append(("list", _PLY_TYPES[toks[2]], _PLY_TYPES[toks[3]], toks[4]))
                else:
                    cur[2].append((toks[-1], _PLY_TYPES[toks[1]]))
            elif toks[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format '{fmt}'")

        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = (props, [f.readline().split() for _ in range(count)])
            elif any(p[0] == "list" for p in props):
                rows = None
                if len(props) == 1:
                    rows = _read_binary_triangles(f, count, props[0])
                if rows is None:
                    rows = _read_binary_rows(f, count, props)
                data[name] = (props, rows)
            else:
                dt = np.dtype([("f" + str(i), "<" + p[1]) for i, p in enumerate(props)])
                data[name] = (props, np.frombuffer(f.read(count * dt.itemsize), dt))

    vprops, vdata = data["vertex"]
    names = [p[0] for p in vprops]

    def col(n):
        i = names.index(n)
        if isinstance(vdata, np.ndarray):
            return vdata["f" + str(i)].astype(np.float32)
        return np.asarray([float(r[i]) for r in vdata], np.float32)

    v = np.stack([col("x"), col("y"), col("z")], -1)
    n = np.stack([col("nx"), col("ny"), col("nz")], -1) if "nx" in names else None
    uv = None
    for ux, uy in (("u", "v"), ("s", "t")):
        if ux in names:
            uv = np.stack([col(ux), col(uy)], -1)
            break

    f_arr = np.zeros((0, 3), np.int32)
    if "face" in data:
        fdata = data["face"][1]
        if isinstance(fdata, np.ndarray):  # binary triangles, read in one step
            f_arr = fdata.astype(np.int32)
        else:
            faces = []
            for row in fdata:
                if isinstance(row[0], np.ndarray):  # a binary row: the list itself
                    idx = np.asarray(row[0], np.int64)
                else:  # an ascii row: the count, then the indices
                    idx = np.asarray([int(x) for x in row[1:1 + int(row[0])]], np.int64)
                for i in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[i], idx[i + 1]))
            if faces:
                f_arr = np.asarray(faces, np.int32)
    return v, f_arr, n, uv


def write_ply(path, vertices, faces, normals=None, uvs=None, binary=True):
    """Write a PLY file (binary_little_endian, or ascii): float32 x y z
    [nx ny nz] [u v] per vertex and a uchar-counted list of int32 vertex
    indices per triangle."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    cols = [v] + [np.asarray(a, np.float32) for a in (normals, uvs) if a is not None]
    names = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals is not None else []) + (
        ["u", "v"] if uvs is not None else [])
    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
              f"element vertex {len(v)}"] + [f"property float {n}" for n in names] + [
        f"element face {len(f)}", "property list uchar int vertex_indices", "end_header"]
    vert = np.concatenate(cols, -1)
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fh.write(vert.astype("<f4").tobytes())
            rec = np.zeros(len(f), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
            rec["n"], rec["i"] = 3, f
            fh.write(rec.tobytes())
        else:
            for row in vert:
                fh.write((" ".join(repr(float(x)) for x in row) + "\n").encode("ascii"))
            for row in f:
                fh.write(f"3 {row[0]} {row[1]} {row[2]}\n".encode("ascii"))
