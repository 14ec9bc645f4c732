"""K4, the any-hit (shadow) query (`csrc/cluster_shadow.cu`, the JAX
package's `ops/clusters._shadow_kernel`): for each ray, whether any prim
is hit before its maxt.

Logical work of one call: every lane's maxt (4 B), the origin and
direction (24 B) of each live lane (maxt > 0), the scene's prims (36 B a
triangle) read once, and one byte of answer a lane. No operation count, as
K3's: the bound is the bytes'.
"""

import torch

TRACE_NAME = "cluster_shadow_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.ops.clusters", "occluded")
PRIM_BYTES = 36
OUT_BYTES = 1


def record(args, kwargs, out):
    """The logical counts of one call, read from its arguments."""
    ray = args[1]
    n = int(ray.o.shape[0])
    return {"lanes": n, "live": int((torch.broadcast_to(ray.maxt, (n,)) > 0).sum())}


def work(call):
    """(bytes, operations) of one recorded call; `prims` is the scene's
    prim count, which the harness adds to every record."""
    return call["lanes"] * (4 + OUT_BYTES) + call["live"] * 24 + call["prims"] * PRIM_BYTES, 0
