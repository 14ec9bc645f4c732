"""Whether the frames the window produced are right: frames and pixels drawn
from the seed, each pixel held against the plain reference
(portbench/reference/path_tracer.py) rendering that pixel at the frame's
seed with the same sampler streams.

Two numbers are compared, each with its limit from the configuration's
"limits" (set in PERF.md from sound runs and the control):
- pixels_off: the share of checked pixels whose largest channel gap
  exceeds REL times the reference's largest channel plus ABS. A sound
  frame differs only where a path's float rounding made it take another
  branch (another triangle at an edge, a Russian-roulette draw at its
  threshold).
- rel_l1: the summed absolute gap over the summed reference, over every
  checked pixel and channel.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import files

REL, ABS = 1e-3, 1e-4


def numbers(got, want):
    """(pixels_off, rel_l1) of program pixels `got` against reference
    pixels `want`, both (M, 3)."""
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    off = gap.max(-1) > REL * np.abs(want).max(-1) + ABS
    return float(off.mean()), float(gap.sum() / max(np.abs(want).sum(), 1e-30))


def plan(n_frames, res_hw, seed, n_check, n_pixels):
    """(frame indices, pixel indices per frame) drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    frames = np.sort(rng.choice(n_frames, size=min(n_check, n_frames), replace=False))
    pixels = [np.sort(rng.choice(res_hw, size=min(n_pixels, res_hw), replace=False))
              for _ in frames]
    return frames, pixels


def check(d, images, first, seed, device, log, limits, n_check, n_pixels, reference):
    """{name: {"value", "limit"}} over n_check frames drawn from `images`
    (frame i rendered at seed first + i), n_pixels pixels each, against the
    plain reference module `reference` (by name)."""
    import torch

    ref = files.reference(reference)
    h, w = images[0].shape[:2]
    t0 = time.perf_counter()
    scene = ref.scene_of(d, device, torch.float32)
    frames, pixels = plan(len(images), h * w, seed, n_check, n_pixels)
    got, want = [], []
    for f, pix in zip(frames, pixels):
        p = torch.as_tensor(pix, device=device)
        want.append(ref.render_pixels(scene, (first + int(f)) & 0xFFFFFFFF, p)
                    .float().cpu().numpy())
        got.append(images[f].reshape(-1, images[f].shape[-1])[pix, :3])
    off, l1 = numbers(np.concatenate(got), np.concatenate(want))
    log(f"reference: frames {frames.tolist()} of {len(images)}, {n_pixels} pixels each, "
        f"{time.perf_counter() - t0:.2f} s")
    return {"pixels_off": {"value": off, "limit": limits["pixels_off"]},
            "rel_l1": {"value": l1, "limit": limits["rel_l1"]}}
