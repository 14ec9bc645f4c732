"""Scenes for the emitter stage's tests: matpreview's emitters (a rectangle
light and a constant sky) and other tables the fused route takes: emissive
spheres, cylinders and a 320-triangle emissive mesh beside them (rows of
prim_dist long enough to be searched, not scanned), area lights alone, the
sky alone. Shared by the CPU tests of the route and the GPU tests of the
kernels; imports no JAX."""

import numpy as np

from mitsuba_customization_tpu_torch import scenes

VARIANTS = ("matpreview", "shapes", "area", "constant")


def emitters_dict(which, res=32, spp=2, depth=4, n_sub=2, compact=None):
    """The matpreview scene (n_sub: its blob's subdivisions) with the
    emitters of variant `which` (VARIANTS)."""
    d = scenes.matpreview_dict(res, spp, depth, n_sub=n_sub, compact=compact)
    if which in ("shapes", "area"):
        v, f = scenes.icosphere_blob(n_sub=2)
        d["glow_ball"] = {"type": "sphere", "center": [-1.5, 0.9, 0.9], "radius": 0.3,
                          "emitter": {"type": "area", "radiance": [4.0, 3.0, 2.0]}}
        d["glow_can"] = {"type": "cylinder", "p0": [1.6, -1.2, 0.9], "p1": [1.7, 0.4, 1.3],
                         "radius": 0.15,
                         "emitter": {"type": "area", "radiance": [2.0, 3.0, 4.0]}}
        d["glow_mesh"] = {"type": "mesh",
                          "vertices": (np.asarray(v) * 0.35
                                       + np.asarray([0.0, 1.6, 1.6])).astype(np.float32),
                          "faces": f,
                          "emitter": {"type": "area", "radiance": [1.5, 2.5, 1.0]}}
    if which == "area":
        del d["sky"]
    if which == "constant":
        del d["light"]
    return d
