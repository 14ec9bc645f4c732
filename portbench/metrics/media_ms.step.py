"""media_ms.step: device ms a step of the media's hand-written tracking
kernels, T1 and T2 forward and T1-bwd and T2-bwd (portbench/kernels/t1*.py,
t2*.py): delta and ratio tracking through the density grid and their
backward, which adds the grid's gradient."""

MEDIA = ("t1", "t2", "t1bwd", "t2bwd")


def read(win):
    ns = sum(d for k in MEDIA if k in win.kernels for _, _, d in win.of_kernel(k))
    return ns / 1e6 / win.reps if ns else None
