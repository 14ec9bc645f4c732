"""body_ms.step: device ms a step of every kernel that is neither one of
the port's hand-written kernels (portbench/kernels) nor a collective
(NCCL's): the plain-PyTorch bounce body, its backward, compaction, the
loss and the optimiser."""


def read(win):
    ns = sum(d for n, _, d in win.kernel_events()
             if not win.hand_written(n) and not n.startswith("nccl"))
    return ns / 1e6 / win.reps
