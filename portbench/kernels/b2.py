"""B2, the any-hit (shadow) query over the skip-link BVH
(`csrc/bvh_traverse.cu` `bvh_any`, the JAX package's
`render/bvh.occluded`): for each ray, whether any prim is hit before its
maxt.

Logical work of one call, as K4's (k4.py): every lane's maxt (4 B), the
origin and direction (24 B) of each live lane (maxt > 0), the scene's
prims (36 B a triangle) read once, and one byte of answer a lane. No
operation count, as B1's: the bound is the bytes'.
"""

import torch

TRACE_NAME = "bvh_any_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.render.bvh", "occluded")
PRIM_BYTES = 36
OUT_BYTES = 1


def record(args, kwargs, out):
    """The logical counts of one call, read from its ray (the wrapper's
    third argument)."""
    ray = args[2]
    n = int(ray.o.shape[0])
    return {"lanes": n, "live": int((torch.broadcast_to(ray.maxt, (n,)) > 0).sum())}


def work(call):
    """(bytes, operations) of one recorded call; `prims` is the scene's
    prim count, which the harness adds to every record."""
    return call["lanes"] * (4 + OUT_BYTES) + call["live"] * 24 + call["prims"] * PRIM_BYTES, 0
