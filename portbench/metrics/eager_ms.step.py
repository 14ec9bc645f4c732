"""eager_ms.step: device ms a step of the kernels outside the captured
step's replay: the Adam update and the parameters' clamp, the seed's
fill, on four cards the collectives' kernels (NCCL's all-reduce, also in
allreduce_ms.step, and the harness's broadcast). Kernels only: the copies
into and out of the graph's buffers are DMAs (Memcpy events), and the
profiler's annotations that the trace stamps on the device's timeline
(torch.optim's Optimizer.step#Adam.step, c10d's nccl:all_reduce) are left
out (harness/spans.py; None unless every traced step's replay matches a
kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.eager_ms(win)
