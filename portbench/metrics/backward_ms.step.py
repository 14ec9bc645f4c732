"""backward_ms.step: device ms a step of the captured step's kernels under the
program's span backward: torch.autograd.grad, the checkpoint's recompute of
every bounce and K1-bwd, T1-bwd and T2-bwd included (harness/spans.py; None
where no traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.phase_ms(win, "backward")
