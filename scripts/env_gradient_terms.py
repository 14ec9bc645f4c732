#!/usr/bin/env python3
"""How much of the envmap's gradient comes through its sampling
distribution.

    python3 scripts/env_gradient_terms.py [--device cpu|cuda] [--res 16]
        [--spp 16] [--seeds 4]

The JAX package's `params.update` rebuilds the envmap's sampling
distribution from `emitter.env_image`, and its NEE direction toward the
envmap is not detached, so the image's gradient carries a term through the
sampled directions; the port does the same (render/params.update). On a
diffuse sphere over a diffuse floor under a 32x64 HDR sky (the scene of
tests/test_torch_emitters.py), this prints, for the distribution built
from the image under autograd ("attached") and from the detached image
("detached"): the share of texels with a nonzero gradient of the MSE
against a zero image and the relative L2 difference of the two gradients;
then the projection of d mean(image) / d image onto a seeded direction by
both, and a central difference of the same derivative (step 0.05, 4x the
spp), per seed.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mitsuba_customization_tpu_torch as mt  # noqa: E402
from mitsuba_customization_tpu_torch.render import ad  # noqa: E402
from mitsuba_customization_tpu_torch.render import emitters as em  # noqa: E402
from mitsuba_customization_tpu_torch.render import params  # noqa: E402

KEY = "emitter.env_image"


def sky(rng, h, w):
    """tests/test_torch_emitters._sky: a gradient, noise, a sun disc."""
    y = (np.arange(h) + 0.5) / h
    img = (0.2 + 0.8 * (1 - y))[:, None, None] * np.float32([0.5, 0.7, 1.0])
    img = img + 0.05 * rng.random((h, w, 3))
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img[(yy - 0.3 * h) ** 2 + (xx - 0.6 * w) ** 2 < (0.03 * h) ** 2 + 1] = [900.0, 850.0, 700.0]
    return img.astype(np.float32)


def scene_dict(res, spp):
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": mt.look_at([0, 1.5, -4], [0, 0.3, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.8] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 6.0}},
        "ball": {"type": "sphere", "center": [0, 0.8, 0], "radius": 0.8,
                 "bsdf": {"type": "diffuse"}},
        "env": {"type": "envmap", "bitmap": sky(np.random.default_rng(2), 32, 64),
                "scale": 0.5, "to_world": {"rotate": {"axis": [0, 1, 0], "angle": 40}}},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    scene = mt.load_dict(scene_dict(args.res, args.spp), args.device)
    img = params.traverse(scene)[KEY]
    build = em.build_env_distribution
    variants = {"attached": build, "detached": lambda im: build(im.detach())}
    target = torch.zeros((args.res, args.res, 3), device=img.device)
    v = torch.tensor(np.random.default_rng(1).normal(size=tuple(img.shape)),
                     dtype=torch.float32, device=img.device) * img
    grads, proj = {}, {}
    try:
        for name, fn in variants.items():
            params.em_mod.build_env_distribution = fn
            # the eager step: a captured step would replay the first variant's graph
            grads[name] = ad._eager_loss_and_grad(scene, {KEY: img}, target, args.spp,
                                                  0)[1][KEY]
            proj[name] = []
            for seed in range(args.seeds):
                x = img.clone().requires_grad_(True)
                (g,) = torch.autograd.grad(
                    ad.render_ad(scene, {KEY: x}, spp=4 * args.spp, seed=seed).mean(), x)
                proj[name].append(float((g * v).sum()))
    finally:
        params.em_mod.build_env_distribution = build
    a, b = grads["attached"], grads["detached"]
    for name, g in grads.items():
        print(f"{name}: nonzero texel share {float((g != 0).any(-1).float().mean()):.4f}")
    print(f"relative L2 difference |attached - detached| / |detached|: "
          f"{float((a - b).norm() / b.norm()):.4f}")
    eps, fd = 0.05, []
    with torch.no_grad():
        for seed in range(args.seeds):
            lp = float(ad.render_ad(scene, {KEY: img + eps * v}, spp=16 * args.spp,
                                    seed=100 + seed).mean())
            lm = float(ad.render_ad(scene, {KEY: img - eps * v}, spp=16 * args.spp,
                                    seed=100 + seed).mean())
            fd.append((lp - lm) / (2 * eps))
    for name, p in proj.items():
        print(f"d mean(image) / d image along v, {name}: {p} (mean {np.mean(p):.4f})")
    print(f"central difference: {fd} (mean {np.mean(fd):.4f})")


if __name__ == "__main__":
    main()
