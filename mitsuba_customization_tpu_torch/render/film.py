"""Box-filter film development.

PyTorch port of `develop_box` and `develop_box_blocked` from
mitsuba_customization_tpu/render/film.py. The splat filters are not
ported.
"""

from __future__ import annotations


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
