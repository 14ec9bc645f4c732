"""The volpath scene as a scene dict: the matpreview scene (matpreview.py)
under the volumetric path integrator with two media bounded by null
shapes, frozen here as the `volpath` configuration's inputs: a homogeneous
isotropic fog ball (sigma_t (0.8, 0.9, 1.0), albedo 0.7) and a cube of
heterogeneous smoke (sigma_t (4, 4.5, 5), albedo 0.8, Henyey-Greenstein g
= 0.6) whose density is a seeded smooth grid_res^3 float32 grid filling
the cube (Mitsuba 3's gridvolume form). numpy only."""

from __future__ import annotations

from pathlib import Path

import numpy as np

FOG = {"type": "homogeneous", "sigma_t": [0.8, 0.9, 1.0], "albedo": [0.7, 0.7, 0.7]}
FOG_CENTER, FOG_RADIUS = [-0.75, 0.05, -1.55], 0.4
CUBE_CENTER, CUBE_HALF = [0.8, -0.05, -1.55], 0.35


def _matpreview():
    import importlib.util

    path = Path(__file__).with_name("matpreview.py")
    spec = importlib.util.spec_from_file_location("portbench_matpreview_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smooth_volume(rng, n, waves=6):
    """A smooth seeded (n, n, n) float32 field in [0, 1]: a sum of products
    of sines along the three axes."""
    c = (np.arange(n, dtype=np.float32) + 0.5) / n
    f = np.zeros((n, n, n), np.float32)
    for _ in range(waves):
        k, ph = rng.integers(1, 6, 3), rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        sz, sy, sx = (np.sin(np.float32(2 * np.pi) * ki * c + p) for ki, p in zip(k, ph))
        f += sz[:, None, None] * (sy[:, None] * sx[None, :])[None]
    f -= f.min()
    f /= f.max()
    return f


def build(res, spp, depth, n_sub=5, n_materials=10, grid_res=256, grid_seed=10):
    """The scene dict at a res x res film, spp samples a pixel, path depth
    `depth`."""
    d = _matpreview().build(res, spp, depth, n_sub=n_sub, n_materials=n_materials)
    d["integrator"] = {"type": "volpath", "max_depth": depth}
    d["fog_ball"] = {"type": "sphere", "center": FOG_CENTER, "radius": FOG_RADIUS,
                     "bsdf": {"type": "null"}, "interior": FOG}
    h = CUBE_HALF
    grid_to_world = np.diag([2 * h, 2 * h, 2 * h, 1.0]).astype(np.float32)
    grid_to_world[:3, 3] = np.asarray(CUBE_CENTER, np.float32) - h
    d["smoke_box"] = {
        "type": "cube", "bsdf": {"type": "null"},
        "to_world": {"scale": h, "translate": CUBE_CENTER},
        "interior": {"type": "heterogeneous", "sigma_t": [4.0, 4.5, 5.0],
                     "albedo": [0.8, 0.8, 0.8], "phase": {"type": "hg", "g": 0.6},
                     "density": {"grid": smooth_volume(np.random.default_rng(grid_seed),
                                                       grid_res),
                                 "to_world": grid_to_world}},
    }
    return d
