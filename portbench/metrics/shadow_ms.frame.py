"""shadow_ms.frame: device ms a frame of the captured frame's kernels that the
program's span shadow recorded: the shadow rays' set-up, K4 and the shadow-
ray count (harness/spans.py; None where no traced replay matches a kept
graph)."""

from portbench.harness import spans


def read(win):
    return spans.stage_ms(win, "shadow")
