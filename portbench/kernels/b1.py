"""B1, the closest-hit query over the skip-link BVH (`csrc/bvh_traverse.cu`
`bvh_closest`, the JAX package's `render/bvh.intersect`, an XLA
while_loop there): for each ray, the nearest of the scene's prims hit
before its maxt. A scene past the cluster kernels' capacity
(ops/clusters.MAX_PRIMS) traces on it.

Logical work of one call, as K3's (k3.py): every lane's maxt (4 B), the
origin and direction (24 B) of each live lane (maxt > 0), the scene's
prims (a triangle's p0, e1, e2: 36 B) read once, and the hit of every
lane (t, prim, u, v: 16 B). No operation count: how many prims a ray is
tested against is the acceleration structure's choice, not the query's.
The tree's nodes, the packed records and the visits of the walk are the
port's layout and are not counted.
"""

import torch

TRACE_NAME = "bvh_closest_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.render.bvh", "intersect")
PRIM_BYTES = 36
OUT_BYTES = 16


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
