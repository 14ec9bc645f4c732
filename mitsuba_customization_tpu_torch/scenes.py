"""Scene dicts the port is exercised on.

`flagship_dict` is the same dict literal as the JAX package's flagship
scene (`__graft_entry__._flagship_scene`): a sphere with a synthetic
MERL-format (90, 90, 180, 3) table, a GGX roughconductor sphere, a diffuse
floor rectangle and a constant sky, rendered by the path integrator. It
lets scripts and tests build the scene without the JAX package.
"""

from __future__ import annotations

import numpy as np

from mitsuba_customization_tpu_torch.render.sensors import look_at


def flagship_table():
    """Synthetic MERL-format table: a diffuse floor plus a specular ridge
    at theta_h ~ 0 (no MERL data ships in the repository)."""
    n_th, n_td, n_pd = 90, 90, 180
    u = (np.arange(n_th) + 0.5) / n_th
    th = (np.pi / 2) * u**2
    lobe = np.exp(-((np.tan(np.minimum(th, 1.5)) / 0.2) ** 2))
    mono = 0.03 + 0.6 * np.broadcast_to(lobe[:, None, None], (n_th, n_td, n_pd))
    return (mono[..., None] * np.asarray([1.0, 0.8, 0.5])).astype(np.float32)


def flagship_dict(res=64, spp=4, depth=4):
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {
            "type": "perspective",
            "fov": 45,
            "to_world": look_at([0, 1.5, -4], [0, 0, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "merl_sphere": {
            "type": "sphere",
            "center": [-0.8, 0, 0],
            "radius": 0.9,
            "bsdf": {"type": "merl", "table": flagship_table()},
        },
        "ggx_sphere": {
            "type": "sphere",
            "center": [1.2, 0, 0.5],
            "radius": 0.9,
            "bsdf": {"type": "roughconductor", "alpha": 0.15},
        },
        "floor": {
            "type": "rectangle",
            "to_world": {
                "rotate": {"axis": [1, 0, 0], "angle": -90},
                "scale": 8.0,
                "translate": [0, -0.95, 0],
            },
            "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]},
        },
        "light": {"type": "constant", "radiance": [0.8, 0.9, 1.0]},
    }
