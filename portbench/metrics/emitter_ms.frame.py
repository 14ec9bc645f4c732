"""emitter_ms.frame: device ms a frame of the captured frame's kernels that
the program's span emitter recorded: emission at the hits and the
background, MIS weights, emitter sampling (K2) and the NEE contribution
(harness/spans.py; None where no traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.stage_ms(win, "emitter")
