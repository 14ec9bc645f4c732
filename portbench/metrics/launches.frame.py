"""launches.frame: the kernels a captured frame launches, counted in the
traced replays (copies and fills left out)."""


def read(win):
    return len(win.kernel_events()) / win.reps
