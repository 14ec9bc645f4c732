"""The program's own spans and counters (the port's utils/log.py), read for
a traced window.

Each captured graph of the program keeps a table (log.GRAPHS): its nodes'
spans, its kernel nodes' names in node order and its copy and set nodes.
A traced call replays a graph as a run of the window's kernels (its
kernel events without the profiler's annotations), sorted by start: each kernel node's name in node order, a copy or set
node either as no kernel (a DMA, which the trace names Memcpy / Memset)
or as one of CUDA's own copy kernels (memcpy32_post, memset32).
Such a run is that graph's replay, and each of its kernels is credited to
its node's span. The match forgives what a trace does to a replay: up to
LOST_OK launches lost (a profiler drops single events), which no span is
credited, and up to FOREIGN_OK kernels of other work running beside it (a
collective on its own stream), which it leaves out; each replay keeps
the count of both (`matches`), and a graph's stages and phases are read
from its replays that lost nothing wherever it has one.
While a profiler runs the program's spans keep host records (log.RECORDS:
path, thread, start and end ns on the clock of kineto's host events);
those inside the window's own portbench.* ranges are the traced calls'.
Where nothing matches, or the program keeps no spans (a program from
before them), every reader here gives None.
"""

from __future__ import annotations

import bisect
import re

# the profiler's annotations' names: record_function ranges of torch.optim
# ("<Class>.<method>#<Class>.<method>") and of c10d ("nccl:<collective>")
ANNOTATION = re.compile(r"nccl:\w+|[\w.]+#[\w.]+")
HOST_ENTRY = ("frame.plan", "frame.key", "frame.inputs")
# CUDA's own kernels for a graph's copy and set nodes
CUDA_COPY = ("memcpy", "memset")
# launches a replay may lack in its trace, and other work's kernels it may
# hold between its own
LOST_OK = 2
FOREIGN_OK = 16

_last = (None, None)  # (window, its replays): the readers of one run share the match


def is_annotation(name):
    """Whether a trace's device event named `name` is one of the profiler's
    user annotations, which a trace stamps on the device's timeline over
    the kernels they hold (torch.optim's "Optimizer.step#Adam.step",
    c10d's "nccl:all_reduce"), and no kernel. A kernel's demangled name
    may hold a "#" too ("{lambda()#1}"), but never without its brackets."""
    return ANNOTATION.fullmatch(name) is not None


def real_kernels(win):
    """The window's kernel events without the profiler's annotations."""
    return [e for e in win.kernel_events() if not is_annotation(e[0])]


def registry():
    """The program's span registry (its utils/log module), or None where
    the program keeps none."""
    try:
        from mitsuba_customization_tpu_torch.utils import log
    except ImportError:
        return None
    return log if hasattr(log, "GRAPHS") and hasattr(log, "RECORDS") else None


def _order(table):
    """The nodes of a table that a trace can show, in node order: (name,
    path) of a kernel node, (None, path) of a copy or set node; none where
    the table's kernel names are unknown."""
    if table.kernels is None:
        return []
    starts = [s[1] for s in table.spans]
    nodes = sorted([(i, name) for i, name in table.kernels]
                   + [(i, None) for i in getattr(table, "copies", ())])
    return [(name, table.spans[bisect.bisect_right(starts, i) - 1][0]) for i, name in nodes]


def _walk(order, own, names, used, j, k, lost):
    """A replay of `order` from its entry k on, against the trace's names
    from position j: ([(position, path)] of the kernels it credits, lost
    launches, foreign kernels), or None. `lost` kernels before entry k are
    missing from the trace."""
    credits, foreign, n = [], 0, len(names)
    while k < len(order):
        name, path = order[k]
        here = names[j] if j < n and not used[j] else None
        if name is None:
            if here is not None and here.startswith(CUDA_COPY):
                credits.append((j, path))
                j += 1
            k += 1
        elif here == name:
            credits.append((j, path))
            j += 1
            k += 1
        elif here is not None and here not in own and foreign < FOREIGN_OK:
            foreign += 1  # another stream's kernel between two of the replay's
            j += 1
        elif lost < LOST_OK:
            lost += 1  # this launch is missing from the trace
            k += 1
        else:
            return None
    return credits, lost, foreign


def matches(win):
    """[(table, [(event, path), ...], lost, foreign)]: every traced replay
    of a kept graph, with each kernel event it credits and that event's
    span path, the launches it lost in the trace and the other work's
    kernels skipped inside it. Newest tables first; no event is in two
    replays."""
    global _last
    if _last[0] is win:
        return _last[1]
    log = registry()
    found = []
    if log is not None:
        events = sorted(real_kernels(win), key=lambda e: e[1])
        names = [e[0] for e in events]
        used = bytearray(len(events))
        for table in reversed(list(log.GRAPHS)):
            order = _order(table)
            kernels = [k for k, (name, _) in enumerate(order) if name is not None]
            if not kernels:
                continue
            own = {name for name, _ in order if name is not None}
            # a replay starts at one of its first kernels (the ones before
            # it lost) or at the copy kernels before those
            starts = {order[k][0]: k for k in reversed(kernels[:LOST_OK + 1])}
            lead = kernels[0]
            p = 0
            while p < len(names):
                k = starts.get(names[p])
                credits = None
                if k is not None and not used[p]:
                    lost = kernels.index(k)
                    back = 0
                    while (not lost and back < lead and p - back > 0 and not used[p - back - 1]
                           and names[p - back - 1].startswith(CUDA_COPY)):
                        back += 1
                    credits = _walk(order, own, names, used, p - back, k - back, lost)
                if credits and credits[0]:
                    got, n_lost, n_foreign = credits
                    for q, _ in got:
                        used[q] = 1
                    found.append((table, [(events[q], path) for q, path in got], n_lost,
                                  n_foreign))
                    p = got[-1][0] + 1
                else:
                    p += 1
    _last = (win, found)
    return found


def replays(win):
    """[(table, [(event, path), ...])]: matches(win) without the counts."""
    return [m[:2] for m in matches(win)]


def device_ms(win, key):
    """{key(span path): device ms a call} over the window's replays: each
    graph's kernels credited to key of their path, averaged over that
    graph's replays that lost no launch (all of them where each lost one)
    and summed over the graphs (a split step's two); None without a
    replay."""
    runs = matches(win)
    if not runs:
        return None
    whole = {id(table) for table, _, lost, _ in runs if not lost}
    per_graph = {}
    for table, credited, lost, _ in runs:
        if lost and id(table) in whole:
            continue
        ns, n = per_graph.setdefault(id(table), ({}, [0]))
        n[0] += 1
        for (_, _, d), path in credited:
            k = key(path)
            ns[k] = ns.get(k, 0) + d
    out = {}
    for ns, n in per_graph.values():
        for k, v in ns.items():
            out[k] = out.get(k, 0.0) + v / 1e6 / n[0]
    return out


def stage(path):
    """A frame's bounce stage of a span path: its last name, the camera's
    rays counted with the film."""
    leaf = path.rsplit("/", 1)[-1]
    return "film" if leaf == "camera" else leaf


def phase(path):
    """A step's phase of a span path: its first name (update, forward,
    backward)."""
    return path.split("/", 1)[0]


def stage_ms(win, name):
    ms = device_ms(win, stage)
    return None if ms is None else ms.get(name, 0.0)


def phase_ms(win, name):
    ms = device_ms(win, phase)
    return None if ms is None else ms.get(name, 0.0)


def eager_ms(win):
    """Device ms a call of the window's kernels outside every replay: the
    optimiser's, the parameters' clamp, the seed's fill, on four cards the
    collectives' (NCCL). Kernels only: the copies into and out of the
    graph's buffers are DMAs (Memcpy events, no kernels), and the
    profiler's annotations on the device's timeline are left out
    (is_annotation). None unless each matched graph replayed once a traced
    call."""
    runs = replays(win)
    counts = {}
    for table, _ in runs:
        counts[id(table)] = counts.get(id(table), 0) + 1
    if not counts or any(n != win.reps for n in counts.values()):
        return None
    credited = {id(e) for _, c in runs for e, _ in c}
    return sum(e[2] for e in real_kernels(win) if id(e) not in credited) / 1e6 / win.reps


def host_ms(win, leaves=HOST_ENTRY):
    """Host ms a call of the program's spans named `leaves` that lie inside
    the window's own portbench.* ranges; None where none does."""
    log = registry()
    if log is None or not win.host:
        return None
    ranges = sorted((s, s + d) for _, s, d in win.host)
    ns, found = 0, False
    for path, _, start, end in list(log.RECORDS):
        if path.rsplit("/", 1)[-1] in leaves and any(a <= start and end <= b for a, b in ranges):
            ns += end - start
            found = True
    return ns / 1e6 / win.reps if found else None


def live_share(win):
    """100 x the live lanes over the lanes run, summed over the bounces of
    the replayed graphs' counters; None without a replayed graph that
    keeps counters. The counters are the graph's outputs as its last
    replay left them when the reader runs: in the benchmark's cells the
    last call of the timed window that follows the traced calls, the same
    plan at another seed (the program reads them at no traced call: that
    takes a copy or a wait on the device, which the trace would hold)."""
    tables = {id(t): t for t, _ in replays(win) if t.counters}
    if not tables:
        return None
    live = lanes = 0
    for table in tables.values():
        for run, n_live, _ in table.counters:
            lanes += run
            live += int(n_live)
    return 100.0 * live / lanes
