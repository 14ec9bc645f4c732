"""film_ms.frame: device ms a frame of the captured frame's kernels that the
program's spans camera and film recorded: each pass's lanes, camera rays
and paths' start, the rays' count and the develop (harness/spans.py; None
where no traced replay matches a kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.stage_ms(win, "film")
