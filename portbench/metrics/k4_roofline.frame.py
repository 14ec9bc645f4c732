"""k4_roofline.frame: K4's share of its roofline over the traced frames
(harness/roofline.py, portbench/kernels/k4.py)."""

from portbench.harness import roofline


def read(win):
    return roofline.share(win, "k4")
