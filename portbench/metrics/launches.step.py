"""launches.step: the kernels a step launches (the captured loss and
gradients, then the eager Adam update), counted in the traced steps
(copies and fills left out)."""


def read(win):
    return len(win.kernel_events()) / win.reps
