"""K3, the closest-hit query (`csrc/cluster_closest.cu`, the JAX package's
`ops/clusters._closest_kernel`): for each ray, the nearest of the scene's
prims hit before its maxt.

Logical work of one call: every lane's maxt (4 B), the origin and
direction (24 B) of each live lane (maxt > 0), the scene's prims (a
triangle's p0, e1, e2: 36 B) read once, and the hit of every lane (t,
prim, u, v: 16 B). No operation count: how many prims a ray is tested
against is the acceleration structure's choice, not the query's, so the
bound is the bytes'. The clusters, their boxes and the visits of the walk
are the port's layout and are not counted.
"""

import torch

TRACE_NAME = "cluster_closest_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.ops.clusters", "intersect")
PRIM_BYTES = 36
OUT_BYTES = 16


def record(args, kwargs, out):
    """The logical counts of one call, read from its arguments."""
    ray = args[1]
    n = int(ray.o.shape[0])
    return {"lanes": n, "live": int((torch.broadcast_to(ray.maxt, (n,)) > 0).sum())}


def work(call):
    """(bytes, operations) of one recorded call; `prims` is the scene's
    prim count, which the harness adds to every record."""
    return call["lanes"] * (4 + OUT_BYTES) + call["live"] * 24 + call["prims"] * PRIM_BYTES, 0
