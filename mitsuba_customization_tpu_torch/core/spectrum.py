"""Color handling. PyTorch port of `luminance` from
mitsuba_customization_tpu/core/spectrum.py (linear Rec.709 RGB)."""

from __future__ import annotations


def luminance(rgb):
    """CIE Y of a linear-RGB color (..., 3) -> (...)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
