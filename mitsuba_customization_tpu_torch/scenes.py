"""Scene dicts the port is exercised on, and the compaction probe.

`flagship_dict` is the same dict literal as the JAX package's flagship
scene (`__graft_entry__._flagship_scene`): a sphere with a synthetic
MERL-format (90, 90, 180, 3) table, a GGX roughconductor sphere, a diffuse
floor rectangle and a constant sky, rendered by the path integrator.

`matpreview_dict` is the literal of the repository's headline scene
(`__graft_entry__._matpreview_scene`): a displaced icosphere (20 * 4**n_sub
triangles) painted with `n_materials` synthetic MERL tables in latitude
bands, a GGX roughconductor floor, a rectangle area light and a dim
constant sky. `probe_compact_schedule` is the JAX package's benchmark
probe (`bench._probe_compact_schedule`). They let scripts and tests build
the scenes without the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mitsuba_customization_tpu_torch.render.sensors import look_at
from mitsuba_customization_tpu_torch.utils.meshgen import (
    face_bands,
    icosphere_blob,
    vertex_normals,
)


def flagship_table():
    """Synthetic MERL-format table: a diffuse floor plus a specular ridge
    at theta_h ~ 0 (no MERL data ships in the repository)."""
    return synthetic_merl_table(0.2, [1.0, 0.8, 0.5])


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


def synthetic_merl_table(lobe_width, color):
    """MERL-format (90, 90, 180, 3) table: a diffuse floor plus a specular
    ridge at theta_h ~ 0 of the given width, tinted `color`."""
    n_th, n_td, n_pd = 90, 90, 180
    u = (np.arange(n_th) + 0.5) / n_th
    th = (np.pi / 2) * u**2
    lobe = np.exp(-((np.tan(np.minimum(th, 1.5)) / lobe_width) ** 2))
    mono = 0.03 + 0.6 * np.broadcast_to(lobe[:, None, None], (n_th, n_td, n_pd))
    return (mono[..., None] * np.asarray(color)).astype(np.float32)


_BAND_COLORS = [
    [1.0, 0.8, 0.5], [0.4, 0.6, 1.0], [1.0, 0.4, 0.4], [0.5, 1.0, 0.6],
    [0.9, 0.9, 0.9], [0.8, 0.5, 1.0], [1.0, 1.0, 0.4], [0.4, 1.0, 1.0],
    [1.0, 0.6, 0.8], [0.6, 0.7, 0.9],
]


def matpreview_dict(res=512, spp=16, depth=8, n_sub=5, n_materials=10,
                    compact=None):
    """The matpreview scene: n_sub = 5 gives 20,480 blob triangles (20,484
    prims with the floor and the light)."""
    v, f = icosphere_blob(n_sub=n_sub)
    vn = vertex_normals(v, f)
    bands = face_bands(v, f, n_materials)
    d = {
        "type": "scene",
        "integrator": {
            "type": "path", "max_depth": depth, "compact": compact,
        },
        "sensor": {
            "type": "perspective",
            "fov": 40,
            "to_world": look_at([0, 1.6, -3.6], [0, 0.1, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "floor": {
            "type": "rectangle",
            "to_world": {
                "rotate": {"axis": [1, 0, 0], "angle": -90},
                "scale": 12.0,
                "translate": [0, -1.2, 0],
            },
            "bsdf": {"type": "roughconductor", "alpha": 0.25},
        },
        "light": {
            "type": "rectangle",
            "to_world": {
                "rotate": {"axis": [1, 0, 0], "angle": 90},
                "scale": 1.2,
                "translate": [1.5, 3.2, -1.0],
            },
            "emitter": {"type": "area", "radiance": [18.0, 17.0, 15.0]},
        },
        "sky": {"type": "constant", "radiance": [0.08, 0.09, 0.12]},
    }
    for i, fi in enumerate(bands):
        d[f"blob_{i}"] = {
            "type": "mesh",
            "vertices": v,
            "faces": f[fi],
            "normals": vn,
            "bsdf": {
                "type": "merl",
                "table": synthetic_merl_table(
                    0.08 + 0.04 * i, _BAND_COLORS[i % len(_BAND_COLORS)]
                ),
            },
        }
    return d


def probe_compact_schedule(scene, spp=4):
    """One pass of spp samples per pixel -> per-bounce live fractions ->
    the scene with that compaction schedule, and the schedule.

    rays_per_bounce counts the live lanes entering each bounce plus the
    NEE shadow rays, so the fractions are conservative; the schedule keeps
    20 % + 2 points of headroom (1.2 * fraction + 0.02, at most 1) so that
    thinning live lanes stays rare."""
    from mitsuba_customization_tpu_torch.render.integrator import render_lanes

    _, _, st = render_lanes(scene, spp, 0)
    rpb = st["rays_per_bounce"].cpu().numpy()
    fracs = [1.0] + [
        min(1.0, float(f) * 1.2 + 0.02) for f in (rpb[1:] / max(rpb[0], 1))
    ]
    cfg = dataclasses.replace(scene.config, compact=tuple(fracs))
    return dataclasses.replace(scene, config=cfg), fracs
