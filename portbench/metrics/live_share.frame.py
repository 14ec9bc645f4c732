"""live_share.frame: 100 x the live lanes over the lanes run, summed over the
bounces of the replayed graph: the program's bounce counters (lanes run a
host fact of the plan, the compaction's caps or every lane; live lanes the
bounce's own count), as the graph's last replay left them: the last call
of the timed window after the traced calls, the same plan at another seed
(harness/spans.py; None where no traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.live_share(win)
