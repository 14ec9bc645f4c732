"""host_ms.frame: host ms a frame of the program's spans frame.plan, frame.key
and frame.inputs, inside the harness's traced ranges: the program's host
work before it hands the card anything (the plan, the cache key's walk of
the scene, the seed and the input copies) (harness/spans.py; None where the
program keeps no span records)."""

from portbench.harness import spans


def read(win):
    return spans.host_ms(win)
