"""Minimal OpenEXR 2.0 and PFM reader/writer (numpy and zlib only).

Copy of mitsuba_customization_tpu/utils/exr.py for the PyTorch port (the
port imports nothing of the JAX package): it reads and writes the same
bytes. EXR is Mitsuba's native HDR interchange format; no OpenEXR library
is needed.

Supported subset (covers files Mitsuba and this renderer produce):
* single-part scanline images, RGB/RGBA/Y float32 or half channels
* compression: NONE and ZIP/ZIPS (zlib + the EXR delta/interleave predictor)
* writes: float32 RGB scanlines, ZIP-compressed by default

Format reference: OpenEXR file layout documentation (openexr.com).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
# pixel types
UINT = 0
HALF = 1
FLOAT = 2

NO_COMPRESSION = 0
ZIPS_COMPRESSION = 2  # zlib, 1 scanline per block
ZIP_COMPRESSION = 3  # zlib, 16 scanlines per block

_LINES_PER_BLOCK = {NO_COMPRESSION: 1, ZIPS_COMPRESSION: 1,
                    ZIP_COMPRESSION: 16}


def _write_attr(f, name, type_name, data):
    f.write(name.encode() + b"\x00")
    f.write(type_name.encode() + b"\x00")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def _predictor_encode(data):
    """EXR ZIP pre-filter (ImfZip::compress): split even/odd bytes into two
    halves, then delta-encode the result (enc[i] = raw[i]-raw[i-1]+384)."""
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    split = np.empty_like(arr)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    s16 = split.astype(np.int16)
    d = np.empty_like(s16)
    d[0] = s16[0]
    d[1:] = s16[1:] - s16[:-1] + 384
    return (d & 0xFF).astype(np.uint8).tobytes()


def _predictor_decode(data):
    """Inverse of _predictor_encode: delta-decode, then re-interleave."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    # out[i] = (out[i-1] + d[i] - 128) mod 256, out[0] = d[0]; closed form
    # out[i] = (d[0] + sum_{1..i}(d[j] - 128)) mod 256
    rec = (d[0] + np.concatenate([[0], np.cumsum(d[1:] - 128)])) % 256
    rec = rec.astype(np.uint8)
    half = (len(rec) + 1) // 2
    out = np.empty_like(rec)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def write_exr(path, image, compression=ZIP_COMPRESSION):
    """Write an (H, W, 3) float32 RGB image as a scanline EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_exr expects (H, W, 3)")
    h, w, _ = img.shape
    lpb = _LINES_PER_BLOCK[compression]

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        # channels attribute: alphabetical order B, G, R
        chan = b""
        for name in (b"B", b"G", b"R"):
            chan += name + b"\x00"
            chan += struct.pack("<iiii", FLOAT, 0, 1, 1)
        chan += b"\x00"
        _write_attr(f, "channels", "chlist", chan)
        _write_attr(
            f, "compression", "compression", struct.pack("<B", compression)
        )
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", struct.pack("<B", 0))
        _write_attr(
            f, "pixelAspectRatio", "float", struct.pack("<f", 1.0)
        )
        _write_attr(
            f, "screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)
        )
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header

        n_blocks = (h + lpb - 1) // lpb
        # build blocks
        blocks = []
        for b in range(n_blocks):
            y0 = b * lpb
            rows = img[y0 : y0 + lpb]
            # per scanline: B, G, R planes
            planes = np.concatenate(
                [
                    np.stack(
                        [rows[i, :, 2], rows[i, :, 1], rows[i, :, 0]], 0
                    ).reshape(-1)
                    for i in range(rows.shape[0])
                ]
            ).astype("<f4")
            raw = planes.tobytes()
            if compression == NO_COMPRESSION:
                data = raw
            else:
                comp = zlib.compress(_predictor_encode(raw))
                data = comp if len(comp) < len(raw) else raw
            blocks.append((y0, data))

        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * n_blocks)  # placeholder
        offsets = []
        for y0, data in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)
        f.seek(offset_table_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))


def _read_attrs(f):
    attrs = {}
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            name += c
        if name == b"":
            break
        type_name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            type_name += c
        (size,) = struct.unpack("<i", f.read(4))
        attrs[name.decode()] = (type_name.decode(), f.read(size))
    return attrs


def _parse_channels(data):
    chans = []
    i = 0
    while data[i] != 0:
        j = data.index(b"\x00", i)
        name = data[i:j].decode()
        ptype, _, xs, ys = struct.unpack("<iiii", data[j + 1 : j + 17])
        chans.append((name, ptype))
        i = j + 17
    return chans


def read_exr(path):
    """Read a scanline EXR into (H, W, C) float32 (C=3 RGB or 1 Y).

    RGBA collapses to RGB. Raises on unsupported features (tiled, deep,
    PIZ/PXR24/B44 compression).
    """
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != MAGIC:
            raise ValueError("not an EXR file")
        if version & 0x200 or version & 0x800:
            raise ValueError("tiled/deep EXR not supported")
        attrs = _read_attrs(f)
        chans = _parse_channels(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        if comp not in _LINES_PER_BLOCK:
            raise ValueError(f"unsupported EXR compression {comp}")
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        w = x1 - x0 + 1
        h = y1 - y0 + 1
        lpb = _LINES_PER_BLOCK[comp]
        n_blocks = (h + lpb - 1) // lpb
        f.read(8 * n_blocks)  # offset table (we read sequentially)

        names = [c[0] for c in chans]
        out = {n: np.zeros((h, w), np.float32) for n in names}
        dtypes = {n: t for n, t in chans}
        bpp = {UINT: 4, HALF: 2, FLOAT: 4}
        line_bytes = sum(bpp[t] * w for _, t in chans)

        for _ in range(n_blocks):
            y, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            rows = min(lpb, y1 - y + 1)
            raw_len = line_bytes * rows
            if size < raw_len:
                data = _predictor_decode(zlib.decompress(data))
            pos = 0
            for r in range(rows):
                for name, t in chans:
                    nb = bpp[t] * w
                    seg = data[pos : pos + nb]
                    pos += nb
                    if t == FLOAT:
                        vals = np.frombuffer(seg, "<f4")
                    elif t == HALF:
                        vals = np.frombuffer(seg, "<f2").astype(np.float32)
                    else:
                        vals = np.frombuffer(seg, "<u4").astype(np.float32)
                    out[name][y - y0 + r] = vals

    if all(c in out for c in ("R", "G", "B")):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    if "Y" in out:
        return out["Y"][..., None]
    # fall back to whatever channels exist, alphabetical
    return np.stack([out[n] for n in sorted(out)], -1)


# ---------------------------------------------------------------- PFM


def write_pfm(path, image):
    """Write (H, W, 3) or (H, W) float32 as PFM (bottom-up, little-endian)."""
    img = np.asarray(image, np.float32)
    color = img.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little-endian
        f.write(img[::-1].astype("<f4").tobytes())


def read_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(
            f.read(), "<f4" if scale < 0 else ">f4"
        )
        img = data.reshape(h, w, 3) if color else data.reshape(h, w)
        return np.ascontiguousarray(img[::-1]).astype(np.float32)
