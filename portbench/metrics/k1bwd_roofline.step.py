"""k1bwd_roofline.step: K1-bwd's share of its roofline over the traced steps
(harness/roofline.py, portbench/kernels/k1bwd.py)."""

from portbench.harness import roofline


def read(win):
    return roofline.share(win, "k1bwd")
