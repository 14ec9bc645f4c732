"""Whether an AD cell's steps are right: the plain reference
(portbench/reference/path_tracer.py: its image as a function of the
parameters, autograd, its own Adam) follows the job's first
`checked_steps` steps from the same start, on the same target and seeds,
and three numbers are
compared, each with its limit from the configuration's "limits" (set in
PERF.md from sound runs, the control and the faults):

- loss_gap: the largest relative gap between a step's loss and the
  reference's;
- grad_gap: the first gradient as the optimiser got it, by the worst
  parameter: the gap between the program's norm and the reference's,
  over the larger of the reference's norm of that parameter and of the
  median parameter's;
- step_gap: the same of each parameter's change over those steps.

A parameter whose reference gradient lies under a thousandth of the
median parameter's moves by round-off alone under Adam and is left out of
grad_gap and step_gap (none is, in the configurations so far).
"""

from __future__ import annotations

import statistics
import time

from portbench.harness import files


def gap(prog, ref, floor_ratio=1e-3):
    """The worst parameter's |prog - ref| / max(ref, median ref) over the
    parameters {key: norm} whose reference norm is at least floor_ratio
    of the median's."""
    med = statistics.median(ref.values())
    kept = [k for k in ref if ref[k] >= floor_ratio * med]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept)


def reference_steps(reference, d, start, target, seeds, lr, device, dtype=None, loss_of=None):
    """The steps of the plain reference module `reference` (by name):
    (losses, first gradient's norms, norms of each parameter's change)."""
    import torch

    ref = files.reference(reference)
    dtype = dtype or torch.float32
    opt = ref.Adam({k: v.to(device=device, dtype=dtype) for k, v in start.items()}, lr)
    losses, g1 = [], None
    for i, s in enumerate(seeds):
        loss, grads = (loss_of or ref.loss_and_grad)(d, opt.params, target, s, device, dtype)
        if i == 0:
            g1 = {k: float(v.double().norm()) for k, v in grads.items()}
        opt.step(grads)
        losses.append(float(loss))
    change = {k: float((opt.params[k].double() - start[k].to(device).double()).norm())
              for k in start}
    return losses, g1, change


def numbers(program, reference):
    (lp, gp, cp), (lr_, gr, cr) = program, reference
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr_)),
            "grad_gap": gap(gp, gr), "step_gap": gap(cp, cr)}


def check(d, start, target, seed, traffic, program, device, log, limits, reference):
    """{name: {"value", "limit"}} of the program's checked steps against
    the reference module `reference`'s."""
    t0 = time.perf_counter()
    base = int(seed) & 0xFFFFFFFF
    seeds = [(base + i + 1) & 0xFFFFFFFF for i in range(len(program[0]))]
    ref = reference_steps(reference, d, start, target, seeds, traffic["lr"], device)
    got = numbers(program, ref)
    log(f"reference: {len(seeds)} steps, {time.perf_counter() - t0:.2f} s; losses "
        f"{program[0]} against {ref[0]}")
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
