"""forward_ms.step: device ms a step of the captured step's kernels under the
program's span forward: the render in ad_mode (camera, bounces, compaction,
film) and the loss up to its value (harness/spans.py; None where no traced
replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.phase_ms(win, "forward")
