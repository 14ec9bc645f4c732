"""b2_roofline.frame: B2's share of its roofline over the traced frames
(harness/roofline.py, portbench/kernels/b2.py)."""

from portbench.harness import roofline


def read(win):
    return roofline.share(win, "b2")
