"""Color handling: luminance, the sRGB transfer functions, and the
build-time resolution of spectra to linear RGB.

PyTorch port of mitsuba_customization_tpu/core/spectrum.py (linear Rec.709
RGB). `srgb_to_linear` / `linear_to_srgb` act on tensors; the spectrum
helpers (`spectrum_to_rgb`, `blackbody_rgb`, `d65_rgb`) run on the host in
numpy when a scene is loaded, with the CIE tables copied from the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch


def luminance(rgb):
    """CIE Y of a linear-RGB color (..., 3) -> (...)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def srgb_to_linear(c):
    """sRGB gamma -> linear (IEC 61966-2-1), elementwise."""
    return torch.where(
        c <= 0.04045,
        c / 12.92,
        torch.pow(torch.clamp((c + 0.055) / 1.055, min=1e-8), 2.4),
    )


def linear_to_srgb(c):
    """Linear -> sRGB gamma, elementwise."""
    c = torch.clamp(c, min=0.0)
    return torch.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=1e-8), 1.0 / 2.4) - 0.055,
    )


# CIE 1931 color matching functions, 380-760 nm every 20 nm. Columns:
# wavelength, xbar, ybar, zbar.
_CIE = np.array([
    [380, 0.0014, 0.0000, 0.0065], [400, 0.0143, 0.0004, 0.0679],
    [420, 0.1344, 0.0040, 0.6456], [440, 0.3483, 0.0230, 1.7471],
    [460, 0.2908, 0.0600, 1.6692], [480, 0.0956, 0.1390, 0.8130],
    [500, 0.0049, 0.3230, 0.2720], [520, 0.0633, 0.7100, 0.0782],
    [540, 0.2904, 0.9540, 0.0203], [560, 0.5945, 0.9950, 0.0039],
    [580, 0.9163, 0.8700, 0.0017], [600, 1.0622, 0.6310, 0.0008],
    [620, 0.8544, 0.3810, 0.0002], [640, 0.4479, 0.1750, 0.0000],
    [660, 0.1649, 0.0610, 0.0000], [680, 0.0468, 0.0170, 0.0000],
    [700, 0.0114, 0.0041, 0.0000], [720, 0.0029, 0.0010, 0.0000],
    [740, 0.0007, 0.0002, 0.0000], [760, 0.0002, 0.0001, 0.0000],
], dtype=np.float64)

# XYZ -> linear Rec.709
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])

# CIE D65 relative spectral power, 380-760 nm every 20 nm
_D65 = np.array([
    49.98, 82.75, 93.43, 104.86, 117.81, 115.92, 109.35, 104.79, 104.41,
    100.00, 95.79, 90.01, 87.70, 83.70, 80.21, 78.27, 71.61, 61.60, 75.09,
    63.38,
])


def spectrum_to_rgb(wavelengths, values, normalize=False):
    """A sampled spectrum integrated against the CIE matching functions ->
    linear RGB (3,) float32, negatives clipped. normalize=True scales the
    result to luminance 1 (the emitter convention)."""
    wl = np.asarray(wavelengths, np.float64)
    sv = np.interp(_CIE[:, 0], wl, np.asarray(values, np.float64),
                   left=0.0, right=0.0)
    xyz = (_CIE[:, 1:] * sv[:, None]).sum(0) / _CIE[:, 2].sum()
    rgb = np.maximum(_XYZ_TO_RGB @ xyz, 0.0)
    if normalize and rgb.max() > 0:
        y = 0.212671 * rgb[0] + 0.715160 * rgb[1] + 0.072169 * rgb[2]
        rgb = rgb / max(y, 1e-12)
    return rgb.astype(np.float32)


def blackbody_rgb(temperature, normalize=True):
    """Planck emitter color at `temperature` K -> linear RGB."""
    wl_m = _CIE[:, 0] * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    radiance = (2 * h * c * c) / (
        wl_m ** 5 * (np.exp(h * c / (wl_m * kb * float(temperature))) - 1.0)
    )
    return spectrum_to_rgb(_CIE[:, 0], radiance, normalize=normalize)


def d65_rgb(scale=1.0):
    """The D65 illuminant's color at luminance 1, times `scale`."""
    return spectrum_to_rgb(_CIE[:, 0], _D65, normalize=True) * np.float32(scale)
