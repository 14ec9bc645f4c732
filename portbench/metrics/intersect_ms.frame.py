"""intersect_ms.frame: device ms a frame of the captured frame's kernels that
the program's span intersect recorded: the bounces' closest-hit set-up and
K3, normal maps and the live-lane count (harness/spans.py; None where no
traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.stage_ms(win, "intersect")
