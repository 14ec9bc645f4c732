"""Image IO: EXR / PFM / PNG / NPY output and bitmap reading.

PyTorch port of mitsuba_customization_tpu/utils/io.py (mitsuba3
src/core/bitmap.cpp's role). EXR and PFM go through the numpy reader and
writer in utils/exr.py. Pillow is imported only inside the PNG / JPG
branches: a machine without it reads and writes EXR, PFM and NPY, and a
PNG there raises ImportError naming Pillow.
"""

from __future__ import annotations

import numpy as np

from mitsuba_customization_tpu_torch.utils import exr


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - depends on the machine
        raise ImportError("PNG / JPG images need Pillow (PIL), which is not "
                          "installed; use EXR, PFM or NPY") from e
    return Image


def _linear_to_srgb(c):
    """Linear -> sRGB gamma (numpy, float32; core/spectrum.linear_to_srgb's
    formula)."""
    c = np.maximum(np.asarray(c, np.float32), np.float32(0.0))
    return np.where(
        c <= np.float32(0.0031308), c * np.float32(12.92),
        np.float32(1.055) * np.power(np.maximum(c, np.float32(1e-8)),
                                     np.float32(1.0 / 2.4)) - np.float32(0.055),
    ).astype(np.float32)


def write_image(path, image):
    """Write by extension: .exr / .pfm float-exact, .npy, else tonemapped
    8-bit PNG. `image` is an (H, W, 3) array or tensor."""
    p = str(path)
    img = np.asarray(_numpy(image), np.float32)
    if p.endswith(".exr"):
        exr.write_exr(p, img)
    elif p.endswith(".pfm"):
        exr.write_pfm(p, img)
    elif p.endswith(".npy"):
        write_npy(p, img)
    else:
        write_png(p, img)


def _numpy(image):
    if hasattr(image, "detach"):  # a torch tensor, on any device
        return image.detach().cpu().numpy()
    return image


def write_png(path, image, tonemap=True):
    """Write an (H, W, 3) linear-RGB float image as 8-bit sRGB PNG."""
    Image = _pillow()
    img = np.asarray(_numpy(image), dtype=np.float32)
    if tonemap:
        img = _linear_to_srgb(np.clip(img, 0.0, 1.0))
    img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(img8).save(path)


def write_npy(path, image):
    """Float-exact image dump."""
    np.save(path, np.asarray(_numpy(image), dtype=np.float32))


def read_image(path):
    """Read an image file into linear-RGB float32 (H, W, 3) (numpy)."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".exr"):
        img = exr.read_exr(path)
        return (np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img
                ).astype(np.float32)
    if path.endswith(".pfm"):
        img = exr.read_pfm(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img.astype(np.float32)
    Image = _pillow()
    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    # PNG / JPG are sRGB-encoded: linearize
    lin = np.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)
