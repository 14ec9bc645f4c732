"""Mitsuba `.serialized` mesh reader and writer.

A copy of mitsuba_customization_tpu/utils/serialized.py (numpy, struct and
zlib only; mitsuba3 src/shapes/serialized.cpp's role). File layout (public
format, shared by Mitsuba 0.4-3):

    uint16 LE magic 0x041C
    uint16 LE version (3 = double precision supported, 4 = current)
    per mesh: one zlib-compressed stream containing
        uint32 flags (bit 0x0001 per-vertex normals, 0x0002 uvs,
                      0x0008 vertex colors, 0x0010 face normals,
                      0x1000 single precision, 0x2000 double precision)
        name: null-terminated UTF-8 (version >= 4)
        uint64 vertex_count, uint64 face_count
        positions   (V, 3) float32/float64
        [normals    (V, 3)]
        [uvs        (V, 2)]
        [colors     (V, 3)]
        faces       (F, 3) uint32 (uint64 when vertex_count > 2^32)
    footer: uint64 LE byte offset of each mesh stream, then
    uint32 LE mesh count, i.e. the last 4 bytes give N and the preceding
    8*N bytes the offsets.

Returns the same contract as utils.obj.read_obj:
(vertices f32 (V,3), faces i32 (F,3), normals-or-None, uvs-or-None).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x041C
_F_HAS_NORMALS = 0x0001
_F_HAS_UVS = 0x0002
_F_HAS_COLORS = 0x0008
_F_FACE_NORMALS = 0x0010
_F_SINGLE = 0x1000
_F_DOUBLE = 0x2000


def _read_stream(buf, version):
    data = zlib.decompress(buf)
    off = 0

    def take(n):
        nonlocal off
        piece = data[off:off + n]
        off += n
        return piece

    (flags,) = struct.unpack("<I", take(4))
    if version >= 4:
        end = data.index(b"\x00", off)
        off = end + 1  # skip shape name
    v_count, f_count = struct.unpack("<QQ", take(16))
    fp = np.float64 if flags & _F_DOUBLE else np.float32

    def arr(count, comps, dtype):
        a = np.frombuffer(
            take(count * comps * np.dtype(dtype).itemsize), dtype=dtype
        )
        return a.reshape(count, comps)

    v = arr(v_count, 3, fp).astype(np.float32)
    n = uv = None
    if flags & _F_HAS_NORMALS:
        n = arr(v_count, 3, fp).astype(np.float32)
    if flags & _F_HAS_UVS:
        uv = arr(v_count, 2, fp).astype(np.float32)
    if flags & _F_HAS_COLORS:
        arr(v_count, 3, fp)  # parsed, not yet surfaced
    idx_t = np.uint64 if v_count > 0xFFFFFFFF else np.uint32
    f = arr(f_count, 3, idx_t).astype(np.int32)
    return v, f, n, uv


def read_serialized(path, shape_index=0):
    """Load mesh `shape_index` from a .serialized container."""
    with open(path, "rb") as fh:
        raw = fh.read()
    magic, version = struct.unpack_from("<HH", raw, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: bad serialized magic 0x{magic:04x}")
    (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if not 0 <= shape_index < count:
        raise ValueError(
            f"{path}: shape_index {shape_index} out of range ({count} meshes)"
        )
    table = len(raw) - 4 - 8 * count
    offsets = list(struct.unpack_from(f"<{count}Q", raw, table))
    offsets.append(table)
    start = offsets[shape_index] + 4  # skip per-stream magic+version copy
    return _read_stream(raw[start:offsets[shape_index + 1]], version)


def write_serialized(path, meshes):
    """Write meshes = [(v, f, normals_or_None, uvs_or_None), ...] as one
    .serialized file (version 4, single precision)."""
    out = bytearray()
    offsets = []
    for v, f, n, uv in meshes:
        offsets.append(len(out))
        out += struct.pack("<HH", MAGIC, 4)
        flags = _F_SINGLE
        if n is not None:
            flags |= _F_HAS_NORMALS
        if uv is not None:
            flags |= _F_HAS_UVS
        body = struct.pack("<I", flags) + b"mesh\x00"
        body += struct.pack(
            "<QQ", int(np.asarray(v).shape[0]), int(np.asarray(f).shape[0])
        )
        body += np.asarray(v, np.float32).tobytes()
        if n is not None:
            body += np.asarray(n, np.float32).tobytes()
        if uv is not None:
            body += np.asarray(uv, np.float32).tobytes()
        body += np.asarray(f, np.uint32).tobytes()
        out += zlib.compress(body)
    for o in offsets:
        out += struct.pack("<Q", o)
    out += struct.pack("<I", len(meshes))
    with open(path, "wb") as fh:
        fh.write(bytes(out))
