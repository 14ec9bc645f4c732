"""k1_roofline.frame: K1's share of its roofline over the traced frames
(harness/roofline.py, portbench/kernels/k1.py)."""

from portbench.harness import roofline


def read(win):
    return roofline.share(win, "k1")
