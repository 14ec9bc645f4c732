"""Tracing a bounded number of calls inside the window, checking that the
trace is whole, and the numbers the per-layer readers take from it.

The device events are read from the profiler's raw results
(`kineto_results.events()`), not from its event tree, which takes tens of
seconds for ~10^5 kernels. The host sleeps PAD_S inside the trace before
and after the calls: a trace cut to the edge of its launches loses device
events stamped just outside the window. A trace can still lose single
launches, and after a captured AD step every other trace of a process
holds no device event at all, so a trace is used only when each
hand-written kernel shows exactly the launches its recorded calls say,
and is otherwise taken again, up to TRIES times.
"""

from __future__ import annotations

import time

PAD_S = 0.05
TRIES = 3
_NOT_KERNELS = ("Memcpy", "Memset")


class TraceIncomplete(RuntimeError):
    pass


class Window:
    """A traced stretch of `reps` calls: device events (name, start ns,
    duration ns), host ranges (name, start ns, duration ns) marked by the
    harness, the host's wall time of the calls, and the calls recorded
    eagerly at the kernels' wrappers ({kernel: [record, ...]} for one
    call), with the kernels' count modules and the card's peaks."""

    def __init__(self, device_events, host_ranges, reps, window_s, calls, kernels, peak):
        self.events = device_events
        self.host = host_ranges
        self.reps = reps
        self.window_s = window_s
        self.calls = calls
        self.kernels = kernels
        self.peak = peak
        # the wall seconds of one call in the untraced window of the same
        # run (set once it has closed): tracing a graph of ~10^4 kernels
        # slows its launches, so the traced calls' own wall time overstates
        # the device's idle time
        self.call_wall_s = None

    def kernel_events(self):
        return [e for e in self.events if not e[0].startswith(_NOT_KERNELS)]

    def of_kernel(self, name):
        trace_name = self.kernels[name].TRACE_NAME
        return [e for e in self.events if trace_name in e[0]]

    def hand_written(self, event_name):
        return any(k.TRACE_NAME in event_name for k in self.kernels.values())

    def busy_s(self):
        """Seconds in which some device operation ran: the union of the
        events' intervals."""
        spans = sorted((s, s + d) for _, s, d in self.events)
        busy, end = 0, None
        for s, e in spans:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def idle_gaps(self, top=10):
        """The longest gaps between device operations, each named by the
        harness's host range that holds its middle: [[name, s], ...]."""
        spans = sorted((s, s + d) for _, s, d in self.events)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            names = [n for n, s, d in self.host if s <= mid <= s + d]
            out.append([names[-1] if names else "outside the harness's ranges", (b - a) / 1e9])
        return out

    def top_ops(self, top=10):
        """The device operations that took most time over the window."""
        tot = {}
        for n, _, d in self.events:
            tot[n] = tot.get(n, 0) + d
        return [[n, d / 1e9] for n, d in sorted(tot.items(), key=lambda x: -x[1])[:top]]

    def check(self):
        """Raise TraceIncomplete unless every hand-written kernel launched
        reps times its recorded calls and the device events span at least
        half of the traced calls' wall time."""
        missing = []
        for name, calls in self.calls.items():
            got = len(self.of_kernel(name))
            if got != self.reps * len(calls):
                missing.append(f"{name}: {got} launches traced, {self.reps * len(calls)} "
                               f"recorded ({len(calls)} a call x {self.reps})")
        if not self.events:
            missing.append("no device event")
        else:
            first = min(s for _, s, _ in self.events)
            last = max(s + d for _, s, d in self.events)
            if (last - first) / 1e9 < 0.5 * self.window_s:
                missing.append(f"device events span {(last - first) / 1e9:.4f} s of a "
                               f"{self.window_s:.4f} s window")
        if missing:
            raise TraceIncomplete("; ".join(missing))


def trace_calls(call, reps):
    """`reps` calls call(i) under torch.profiler, the host asleep PAD_S
    before and after them: (device events, host ranges named "portbench.*",
    wall seconds of the calls)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        for i in range(reps):
            call(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PAD_S)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.duration_ns())
        if e.name().startswith("portbench."):
            # the harness's host ranges (kineto also stamps them on the
            # device's timeline, where they are no device work)
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(rec)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
    return dev, host, wall


def whole_trace(call, reps, calls, kernels, peak, log):
    """A Window of `reps` calls that passes Window.check, traced up to
    TRIES times; TraceIncomplete after that."""
    for attempt in range(1, TRIES + 1):
        dev, host, wall = trace_calls(call, reps)
        win = Window(dev, host, reps, wall, calls, kernels, peak)
        try:
            win.check()
            return win
        except TraceIncomplete as e:
            log(f"trace {attempt} of {TRIES} incomplete: {e}")
            if attempt == TRIES:
                raise
    raise AssertionError("unreachable")
