"""Film and reconstruction filters: samples accumulated into the image.

PyTorch port of mitsuba_customization_tpu/render/film.py. Lanes are
pixel-major, so the box filter is a reshape-mean (`develop_box`,
`develop_box_blocked`); the other filters (gaussian, tent, mitchell,
catmullrom, lanczos) splat each sample into its 3x3 pixel neighbourhood
(`splat`, `splat_slab`, `develop`). A splat is one `index_add_` of the
nine stacked offsets by flat pixel index (ty * W + tx); its backward is an
`index_select`, the port's convention for per-lane reads.
"""

from __future__ import annotations

import math

import torch

BOX = 0
GAUSSIAN = 1
TENT = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

FILTER_NAMES = {
    "box": BOX,
    "gaussian": GAUSSIAN,
    "tent": TENT,
    "mitchell": MITCHELL,
    "catmullrom": CATMULLROM,
    "lanczos": LANCZOS,
}


def _mitchell_1d(x, b, c):
    x = x.abs()
    x2, x3 = x * x, x * x * x
    p1 = (12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x
          + (8 * b + 24 * c))
    return torch.where(x < 1.0, p1, torch.where(x < 2.0, p2, 0.0)) / 6.0


def _lanczos_1d(x, a=2.0):
    x = x.abs()
    pix = math.pi * torch.clamp(x, min=1e-6)
    val = a * torch.sin(pix) * torch.sin(pix / a) / (pix * pix)
    return torch.where(x < 1e-6, 1.0, torch.where(x < a, val, 0.0))


def _filter_weight(filter_type, dx, dy):
    """The reconstruction filter at offset (dx, dy) pixels."""
    if filter_type == BOX:
        return ((dx.abs() <= 0.5) & (dy.abs() <= 0.5)).to(dx.dtype)
    if filter_type == GAUSSIAN:
        # std 0.5 (the hdrfilm default gaussian)
        s2 = 2.0 * 0.5 * 0.5
        return torch.exp(-(dx * dx + dy * dy) / s2)
    if filter_type == TENT:
        return torch.clamp(1.0 - dx.abs(), min=0.0) * torch.clamp(1.0 - dy.abs(), min=0.0)
    if filter_type == MITCHELL:
        return _mitchell_1d(dx, 1 / 3, 1 / 3) * _mitchell_1d(dy, 1 / 3, 1 / 3)
    if filter_type == CATMULLROM:
        return _mitchell_1d(dx, 0.0, 0.5) * _mitchell_1d(dy, 0.0, 0.5)
    if filter_type == LANCZOS:
        return _lanczos_1d(dx) * _lanczos_1d(dy)
    raise ValueError(f"unknown filter {filter_type}")


def develop(values, pixel_xy, height, width, filter_type=BOX, spp=None):
    """(N, C) samples at continuous film positions pixel_xy (N, 2) (x, y)
    -> an (H, W, C) image: the 3x3 splat normalised by its weights."""
    img, wsum = splat(values, pixel_xy, height, width, filter_type)
    return img / torch.clamp(wsum, min=1e-12)[..., None]


def splat(values, pixel_xy, height, width, filter_type):
    """Raw weighted splat sums (img (H, W, C), wsum (H, W)): passes add
    them, develop time divides (ImageBlock::put semantics)."""
    return splat_slab(values, pixel_xy, 0, height, height, width, filter_type)


def splat_slab(values, pixel_xy, y0, rows, height, width, filter_type):
    """`splat` into the row slab [y0, y0 + rows) of the full film (the
    sharded render's per-device slab with its halo). Rows outside [0,
    height) or outside the slab are dropped: summed over slabs, the same
    estimator as the full-film splat."""
    c = values.shape[-1]
    px, py = pixel_xy[..., 0], pixel_xy[..., 1]
    ix = torch.floor(px - 0.5).to(torch.int64)
    iy = torch.floor(py - 0.5).to(torch.int64)
    idx, wts = [], []
    for oy in range(-1, 2):
        for ox in range(-1, 2):
            tx, ty = ix + ox, iy + oy
            dx = (tx.to(px.dtype) + 0.5) - px
            dy = (ty.to(py.dtype) + 0.5) - py
            w = _filter_weight(filter_type, dx, dy)
            tyl = ty - y0
            inside = ((tx >= 0) & (tx < width) & (ty >= 0) & (ty < height)
                      & (tyl >= 0) & (tyl < rows))
            wts.append(torch.where(inside, w, 0.0))
            idx.append(torch.clamp(tyl, 0, rows - 1) * width + torch.clamp(tx, 0, width - 1))
    idx = torch.cat(idx)
    w = torch.cat(wts)
    vals = (values.repeat(9, 1) * w[:, None])
    img = values.new_zeros((rows * width, c)).index_add_(0, idx, vals)
    wsum = w.new_zeros(rows * width).index_add_(0, idx, w)
    return img.reshape(rows, width, c), wsum.reshape(rows, width)


def develop_box(values, height, width, spp):
    """Pixel-major lanes (H*W*spp ordering): box filter = mean over spp."""
    c = values.shape[-1]
    return values.reshape(height, width, spp, c).mean(2)


def develop_box_blocked(values, height, width, spp, block):
    """develop_box for block-ordered lanes:
    (by, bx, y_in_block, x_in_block, spp, c) -> (H, W, c)."""
    c = values.shape[-1]
    v = values.reshape(
        height // block, width // block, block, block, spp, c
    ).mean(4)
    return v.permute(0, 2, 1, 3, 4).reshape(height, width, c)
