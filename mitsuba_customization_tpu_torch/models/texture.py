"""Textures: bitmap (bilinear, wrap), checkerboard, mesh attribute and
volume grids.

PyTorch port of mitsuba_customization_tpu/models/texture.py (mitsuba3
src/textures/{bitmap,checkerboard,mesh_attribute,volume}.cpp). All bitmaps
of a scene stack into one zero-padded (T, H, W, 3) tensor with each slot's
actual (H, W) kept beside it, so lanes with different textures evaluate
together; it is the shape of the AD key `bsdf.textured_diffuse.images`.
Per-lane reads gather from flat views with index_select, whose backward is
one index_add_ (see models/bsdf._gather_params).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.math import gather_rows

# texture types (the JAX package's ids)
CONSTANT = 0
BITMAP = 1
CHECKERBOARD = 2
MESH_ATTRIBUTE = 3  # barycentric vertex-attribute interpolation
VOLUME = 4  # 3-D grid sampled at the world hit position

# Texture-coordinate widths: plain (..., 2) uv; mesh_attribute also needs
# the hit's barycentrics and prim id, volume textures the world position:
# [u, v, bary_u, bary_v, float(prim), px, py, pz].
TC_FULL = 5
TC_VOL = 8


class TextureStack(NamedTuple):
    """Per-material texture bindings and the shared bitmap stack.

    tex_type (M,) int64; value0 / value1 (M, 3) (constant or checker
    colors; mesh_attribute and volume scale; volume fill); uv_scale (M, 2);
    slot (M,) int64 into images (T, H, W, 3); dims (T, 2) int64 actual
    (H, W); attr (P, 9) per-prim corner attributes or None (no
    mesh_attribute rows: a host fact); vol_grid (Tv, D, H, W, 3), vol_w2g
    (M, 3, 4) world -> unit-cube affine, vol_dims (M, 3) int64, vol_slot
    (M,) int64, all None without volume rows.
    """

    tex_type: torch.Tensor
    value0: torch.Tensor
    value1: torch.Tensor
    uv_scale: torch.Tensor
    slot: torch.Tensor
    images: torch.Tensor
    dims: torch.Tensor
    attr: Any = None
    vol_grid: Any = None
    vol_w2g: Any = None
    vol_dims: Any = None
    vol_slot: Any = None


def _pad_volumes(volumes):
    md = max(v.shape[0] for v in volumes)
    mh = max(v.shape[1] for v in volumes)
    mw = max(v.shape[2] for v in volumes)
    out = np.zeros((len(volumes), md, mh, mw, 3), np.float32)
    for i, v in enumerate(volumes):
        out[i, : v.shape[0], : v.shape[1], : v.shape[2]] = v
    return out


def build_stack(rows, attr=None, *, device="cuda"):
    """TextureStack on `device` from rows: dicts {type, value0, value1,
    uv_scale, image (H, W[, 3]) or None, volume (D, H, W[, 3]) or None,
    vol_to_world 4x4 or None}; attr: optional (P, 9) per-prim corner
    attribute table read by mesh_attribute rows. The positional order is
    the JAX package's; `device` is the port's own."""
    m_count = len(rows)
    tex_type = np.zeros(m_count, np.int64)
    value0 = np.zeros((m_count, 3), np.float32)
    value1 = np.zeros((m_count, 3), np.float32)
    uv_scale = np.ones((m_count, 2), np.float32)
    slot = np.zeros(m_count, np.int64)
    images = []
    max_h = max_w = 1
    volumes = []
    vol_w2g = np.zeros((m_count, 3, 4), np.float32)
    vol_dims = np.ones((m_count, 3), np.int64)
    vol_slot = np.zeros(m_count, np.int64)
    for i, row in enumerate(rows):
        tex_type[i] = row["type"]
        value0[i] = row.get("value0", (1, 1, 1))
        value1[i] = row.get("value1", (0, 0, 0))
        uv_scale[i] = row.get("uv_scale", (1, 1))
        img = row.get("image")
        if img is not None:
            slot[i] = len(images)
            img = np.asarray(img, np.float32)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            images.append(img[..., :3])
            max_h = max(max_h, img.shape[0])
            max_w = max(max_w, img.shape[1])
        vol = row.get("volume")
        if vol is not None:
            vol = np.asarray(vol, np.float32)
            if vol.ndim == 3:
                vol = np.repeat(vol[..., None], 3, axis=-1)
            vol_slot[i] = len(volumes)
            vol_dims[i] = vol.shape[:3]
            volumes.append(vol)
            to_w = (np.asarray(row["vol_to_world"], np.float64)
                    if row.get("vol_to_world") is not None else np.eye(4))
            inv = np.linalg.inv(to_w)
            vol_w2g[i, :, :3] = inv[:3, :3].astype(np.float32)
            vol_w2g[i, :, 3] = inv[:3, 3].astype(np.float32)
    if not images:
        images = [np.zeros((1, 1, 3), np.float32)]
    dims = np.asarray([im.shape[:2] for im in images], np.int64)
    padded = np.zeros((len(images), max_h, max_w, 3), np.float32)
    for t, im in enumerate(images):
        padded[t, : im.shape[0], : im.shape[1]] = im

    def dev(a):
        return torch.as_tensor(a, device=device)

    return TextureStack(
        tex_type=dev(tex_type), value0=dev(value0), value1=dev(value1),
        uv_scale=dev(uv_scale), slot=dev(slot), images=dev(padded), dims=dev(dims),
        attr=None if attr is None else dev(np.asarray(attr, np.float32)),
        vol_grid=dev(_pad_volumes(volumes)) if volumes else None,
        vol_w2g=dev(vol_w2g) if volumes else None,
        vol_dims=dev(vol_dims) if volumes else None,
        vol_slot=dev(vol_slot) if volumes else None,
    )


def _texels(grid, flat_idx):
    """(..., 3) texels of a (..., 3) grid at flat indices into its leading
    axes."""
    return gather_rows(grid.reshape(-1, 3), flat_idx)


def _bitmap_eval(stack: TextureStack, mat_slot, uv):
    """Bilinear, wrap addressing, v flipped (image row 0 = top, uv v = 0 =
    bottom: mitsuba3 bitmap.cpp's convention)."""
    s = gather_rows(stack.slot, mat_slot)
    hw = gather_rows(stack.dims, s)  # (..., 2)
    h = hw[..., 0].to(torch.float32)
    w = hw[..., 1].to(torch.float32)
    scale = gather_rows(stack.uv_scale, mat_slot)
    u = uv[..., 0] * scale[..., 0]
    v = uv[..., 1] * scale[..., 1]
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    fx = u * w - 0.5
    fy = (1.0 - v) * h - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    hi = torch.clamp(hw[..., 0], min=1)
    wi_ = torch.clamp(hw[..., 1], min=1)
    _, big_h, big_w, _ = stack.images.shape
    base = s * big_h

    def at(yi, xi):
        return _texels(stack.images, (base + torch.remainder(yi, hi)) * big_w
                       + torch.remainder(xi, wi_))

    c00 = at(y0, x0)
    c01 = at(y0, x0 + 1)
    c10 = at(y0 + 1, x0)
    c11 = at(y0 + 1, x0 + 1)
    return (1 - ty) * ((1 - tx) * c00 + tx * c01) + ty * ((1 - tx) * c10 + tx * c11)


def _checker_eval(stack: TextureStack, mat_slot, uv):
    scale = gather_rows(stack.uv_scale, mat_slot)
    su = uv[..., 0] * scale[..., 0] * 2.0
    sv = uv[..., 1] * scale[..., 1] * 2.0
    cell = torch.floor(su).to(torch.int64) + torch.floor(sv).to(torch.int64)
    odd = torch.remainder(cell, 2) != 0
    return torch.where(odd[..., None], gather_rows(stack.value1, mat_slot),
                       gather_rows(stack.value0, mat_slot))


def _mesh_attr_eval(stack: TextureStack, mat_slot, tc):
    """Barycentric interpolation of per-prim corner attributes (tc in the
    TC_FULL layout); times the row's scale (value0)."""
    prim = torch.clamp(tc[..., 4].to(torch.int64), 0, stack.attr.shape[0] - 1)
    c = gather_rows(stack.attr, prim)  # (..., 9)
    bu = tc[..., 2:3]
    bv = tc[..., 3:4]
    w = 1.0 - bu - bv
    val = w * c[..., 0:3] + bu * c[..., 3:6] + bv * c[..., 6:9]
    return val * gather_rows(stack.value0, mat_slot)


def _volume_eval(stack: TextureStack, mat_slot, p):
    """Trilinear 3-D grid lookup at world position p: the row's world ->
    unit-cube affine maps p into its grid; outside [0, 1]^3 the value is
    the fill (value1)."""
    w2g = gather_rows(stack.vol_w2g, mat_slot)  # (..., 3, 4)
    g = (w2g[..., :3] * p[..., None, :]).sum(-1) + w2g[..., 3]
    dims = gather_rows(stack.vol_dims, mat_slot)
    slot = gather_rows(stack.vol_slot, mat_slot)
    d = dims[..., 0].to(torch.float32)
    h = dims[..., 1].to(torch.float32)
    w = dims[..., 2].to(torch.float32)
    fz = torch.clamp(g[..., 2], 0.0, 1.0) * (d - 1)
    fy = torch.clamp(g[..., 1], 0.0, 1.0) * (h - 1)
    fx = torch.clamp(g[..., 0], 0.0, 1.0) * (w - 1)

    def lo(f, n):
        return torch.minimum(torch.clamp(torch.floor(f).to(torch.int64), min=0),
                             torch.clamp(n - 2, min=0))

    z0, y0, x0 = lo(fz, dims[..., 0]), lo(fy, dims[..., 1]), lo(fx, dims[..., 2])
    tz = (fz - z0)[..., None]
    ty = (fy - y0)[..., None]
    tx = (fx - x0)[..., None]
    z1 = torch.minimum(z0 + 1, dims[..., 0] - 1)
    y1 = torch.minimum(y0 + 1, dims[..., 1] - 1)
    x1 = torch.minimum(x0 + 1, dims[..., 2] - 1)
    _, big_d, big_h, big_w, _ = stack.vol_grid.shape

    def at(zi, yi, xi):
        return _texels(stack.vol_grid, ((slot * big_d + zi) * big_h + yi) * big_w + xi)

    c0 = (at(z0, y0, x0) * (1 - tx) + at(z0, y0, x1) * tx) * (1 - ty) + (
        at(z0, y1, x0) * (1 - tx) + at(z0, y1, x1) * tx) * ty
    c1 = (at(z1, y0, x0) * (1 - tx) + at(z1, y0, x1) * tx) * (1 - ty) + (
        at(z1, y1, x0) * (1 - tx) + at(z1, y1, x1) * tx) * ty
    val = (c0 * (1 - tz) + c1 * tz) * gather_rows(stack.value0, mat_slot)
    inside = ((g >= 0.0) & (g <= 1.0)).all(-1)
    return torch.where(inside[..., None], val, gather_rows(stack.value1, mat_slot))


def eval(stack: TextureStack, mat_slot, uv):
    """Per-lane RGB texture value of each lane's binding `mat_slot` at uv:
    (..., 2) plain coordinates, or the widened TC_FULL / TC_VOL vector
    when mesh_attribute / volume rows can be reached."""
    t = gather_rows(stack.tex_type, mat_slot)
    out = gather_rows(stack.value0, mat_slot)
    out = torch.where((t == BITMAP)[..., None], _bitmap_eval(stack, mat_slot, uv), out)
    out = torch.where((t == CHECKERBOARD)[..., None], _checker_eval(stack, mat_slot, uv),
                      out)
    if stack.attr is not None and uv.shape[-1] >= TC_FULL:
        out = torch.where((t == MESH_ATTRIBUTE)[..., None],
                          _mesh_attr_eval(stack, mat_slot, uv), out)
    if stack.vol_grid is not None and uv.shape[-1] >= TC_VOL:
        out = torch.where((t == VOLUME)[..., None],
                          _volume_eval(stack, mat_slot, uv[..., 5:8]), out)
    return out
