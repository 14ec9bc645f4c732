"""k3_roofline.frame: K3's share of its roofline over the traced frames
(harness/roofline.py, portbench/kernels/k3.py)."""

from portbench.harness import roofline


def read(win):
    return roofline.share(win, "k3")
