"""K1-bwd, the MERL lookup's backward (`csrc/merl_eval_bwd.cu`; in the JAX
package XLA's VJP of `ops/merl_sorted.eval_raw`): the table's gradient
from the cotangent of one K1 call's lanes.

Logical work of one call, from its arguments: wi and the slot index (16 B)
of each lane live in either half; wo (12 B), the cotangent (12 B) and the
forward value that the clamp at 0 tests (12 B) of each live half-lane;
one mask byte a lane a half; and each gradient bin (12 B) that the
corners of the half-lanes that evaluate with a nonzero cotangent touch,
written once (harness/merl.py). Operations: K1's 170 and 72 for the 24
corner products, a half-lane that evaluates. The zeroing of the gradient
buffer is not counted.
"""

import torch

from portbench.harness import merl

TRACE_NAME = "merl_eval_bwd_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.ops.merl_sorted", "eval_trilinear_bwd")
OPS = 170 + 72
BIN_BYTES = 12


def record(args, kwargs, out):
    """The logical counts of one call, read from its arguments."""
    names = ("table", "g", "wi", "wo", "slot", "mask", "wo_b", "mask_b")
    a = dict(zip(names, args))
    a.update({k: v for k, v in kwargs.items() if k in names})
    table, g, wi = a["table"], a["g"], a["wi"]
    n = wi.shape[0]
    halves, slot = merl.halves(a, n, wi.device)
    evaluates, bins = 0, []
    for h, (wo, m) in enumerate(halves):
        ev = m & (wi[:, 2] > 0) & (wo[:, 2] > 0)
        add = ev & (g[h * n:(h + 1) * n] != 0).any(-1)
        evaluates += int(ev.sum())
        bins.append(merl.corner_bins(table.shape, wi[add], wo[add], slot[add]))
    return {"lanes": n, "halves": len(halves),
            "either": int(torch.stack([m for _, m in halves]).any(0).sum()),
            "live": sum(int(m.sum()) for _, m in halves), "evaluates": evaluates,
            "bins": int(torch.unique(torch.cat(bins)).numel())}


def work(call):
    """(bytes, operations) of one recorded call."""
    nbytes = (call["either"] * 16 + call["live"] * (12 + 12 + 12)
              + call["lanes"] * call["halves"] + call["bins"] * BIN_BYTES)
    return nbytes, call["evaluates"] * OPS
