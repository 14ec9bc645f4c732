"""b1_roofline.frame: B1's share of its roofline over the traced frames
(harness/roofline.py, portbench/kernels/b1.py)."""

from portbench.harness import roofline


def read(win):
    return roofline.share(win, "b1")
