"""bvh_ms.frame: device ms a frame of the BVH kernels' launches, B1 and B2
(portbench/kernels/b1.py, b2.py), in the traced frames; None where the
trace holds neither."""


def read(win):
    events = win.of_kernel("b1") + win.of_kernel("b2")
    if not events:
        return None
    return sum(d for _, _, d in events) / 1e6 / win.reps
