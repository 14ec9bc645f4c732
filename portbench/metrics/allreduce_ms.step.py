"""allreduce_ms.step: device ms a step of the collectives' all-reduce
kernels (NCCL's) on rank 0: the loss's and every gradient's sum over the
ranks, including the wait for the slowest rank, whose slab ends last."""


def read(win):
    ns = sum(d for n, _, d in win.kernel_events() if n.startswith("nccl") and "AllReduce" in n)
    return ns / 1e6 / win.reps if ns else None
