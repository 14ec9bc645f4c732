"""idle_share.frame: the share (%) of a frame's wall time in which no device
operation ran: one minus the device's busy seconds a frame (the union of
the traced frames' device events over the traced frames) over the wall
seconds a frame of the same run's untraced window.

The two come from different stretches of one run: tracing slows the
host's launches, so the traced frames' own wall time would overstate the
idle time, while the device's work a frame is the same in both. Where the
card is busy throughout, the share can read a little below 0 (the
traced and untraced frames' spread)."""


def read(win):
    if win.call_wall_s is None:
        return None
    return 100.0 * (1.0 - win.busy_s() / win.reps / win.call_wall_s)
