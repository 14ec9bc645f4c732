"""compact_ms.frame: device ms a frame of the captured frame's kernels that
the program's span compact recorded: compaction: the set-up, each bounce's
thinning, sort, gathers and write-back, and the final scatter
(harness/spans.py; None where no traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.stage_ms(win, "compact")
