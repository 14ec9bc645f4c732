"""body_ms.frame: device ms a frame of every kernel that is not one of the
port's hand-written kernels (portbench/kernels): the plain-PyTorch bounce
body, compaction and film."""


def read(win):
    ns = sum(d for n, _, d in win.kernel_events() if not win.hand_written(n))
    return ns / 1e6 / win.reps
