"""K1, the trilinear MERL lookup (`csrc/merl_eval.cu`, the JAX package's
`ops/merl_sorted._segment_kernel`): f(wi, wo) of each lane's table, for
one half or two halves that share wi and the slot.

Logical work of one call, from the call's own arguments only: wi and the
slot index (4 B, as the JAX function takes it) once for each lane live in
either half; wo for each live half-lane; one mask byte a lane a half; each
table bin (3 channels, 12 B) that the corners of the half-lanes that
evaluate (live, both directions above the horizon) touch, once
(harness/merl.py); 12 B of output a half-lane. Operations: 170 a
half-lane that evaluates (the half/difference angles with acos and atan2,
the cell indices, 8 corners over 3 channels); the lookup is bound by its
bytes. Nothing of how the port lays out, sorts or packs the lanes is
counted.
"""

import torch

from portbench.harness import merl

TRACE_NAME = "merl_eval_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.ops.merl_sorted", "eval_trilinear")
OPS = 170
BIN_BYTES = 12


def record(args, kwargs, out):
    """The logical counts of one call, read from its arguments."""
    names = ("table", "wi", "wo", "slot", "mask", "wo_b", "mask_b")
    a = dict(zip(names, args))
    a.update({k: v for k, v in kwargs.items() if k in names})
    wi, table = a["wi"], a["table"]
    halves, slot = merl.halves(a, wi.shape[0], wi.device)
    evaluates, bins = 0, []
    for wo, m in halves:
        ev = m & (wi[:, 2] > 0) & (wo[:, 2] > 0)
        evaluates += int(ev.sum())
        bins.append(merl.corner_bins(table.shape, wi[ev], wo[ev], slot[ev]))
    return {"lanes": int(wi.shape[0]), "halves": len(halves),
            "either": int(torch.stack([m for _, m in halves]).any(0).sum()),
            "live": sum(int(m.sum()) for _, m in halves), "evaluates": evaluates,
            "bins": int(torch.unique(torch.cat(bins)).numel())}


def work(call):
    """(bytes, operations) of one recorded call."""
    nbytes = (call["either"] * (12 + 4) + call["live"] * 12
              + call["lanes"] * call["halves"] * (1 + 12) + call["bins"] * BIN_BYTES)
    return nbytes, call["evaluates"] * OPS
