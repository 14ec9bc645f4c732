"""A kernel's share of its roofline over a traced window: the least time
the card could take for its recorded calls (harness/peaks.bound_s of each
call's logical bytes and operations, portbench/kernels/<kernel>.py) over
the device time its launches took in the trace, in %."""

from portbench.harness import peaks


def share(win, kernel):
    """The share (%), or None where the trace holds no launch of the kernel,
    no call was recorded, the kernel's file counts launches only (no
    `work`), or the card's peaks are not known."""
    events = win.of_kernel(kernel)
    calls = win.calls.get(kernel) if win.calls else None
    k = win.kernels[kernel]
    if not events or not calls or win.peak is None or not hasattr(k, "work"):
        return None
    bound = sum(peaks.bound_s(*k.work(c), win.peak) for c in calls) * win.reps
    return 100.0 * bound / (sum(d for _, _, d in events) / 1e9)
