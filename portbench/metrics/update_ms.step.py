"""update_ms.step: device ms a step of the captured step's kernels under the
program's span update: params.update: the tables' sampling CDFs rebuilt,
the GradSink and the scene's parameters (harness/spans.py; None where no
traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.phase_ms(win, "update")
