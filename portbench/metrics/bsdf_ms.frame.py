"""bsdf_ms.frame: device ms a frame of the captured frame's kernels that the
program's span bsdf recorded: BSDF shading (K1), the continuation and
Russian roulette (harness/spans.py; None where no traced replay matches a
kept graph)."""

from portbench.harness import spans


def read(win):
    return spans.stage_ms(win, "bsdf")
