"""Logging and render statistics.

PyTorch port of mitsuba_customization_tpu/utils/log.py (mitsuba3's
logger and the 0.6 Statistics singleton): a std-logging logger named
`mitsuba_customization_tpu_torch`, a process-wide registry of counters and
timers printed after renders, a JSONL metrics writer for optimisation
loops, and the port's spans and counters.

`span` is the one tracing mechanism: a named range at a layer boundary
(frame.call, frame.key, frame.replay, a bounce's stages, a step's update /
forward / backward, the optimiser, the all-reduce). Its Statistics time is
host time: around CUDA work it is the time to enqueue that work, and no
span synchronises the device. While a torch profiler runs, spans keep
records on the clock of the profiler's host events; inside a captured
graph's body they mark which nodes each span recorded, so a trace's
kernels of a replay can be put down to the spans (GraphTable).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import json
import logging
import threading
import time
import weakref
from collections import defaultdict, deque

import torch

logger = logging.getLogger("mitsuba_customization_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s [%(levelname)s] %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def set_log_level(level):
    """Trace/Debug/Info/Warn/Error: Logger::set_log_level."""
    logger.setLevel(level)


class Statistics:
    """Process-wide counters and timers: Statistics::getInstance."""

    _instance = None

    def __init__(self):
        self.counters = defaultdict(int)
        self.timers = defaultdict(float)

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = Statistics()
        return cls._instance

    def add(self, name, value=1):
        self.counters[name] += int(value)

    def set(self, name, value):
        """A counter that holds a fact (a structure's size) rather than a
        count of events."""
        self.counters[name] = int(value)

    def add_time(self, name, seconds):
        self.timers[name] += float(seconds)

    def reset(self):
        self.counters.clear()
        self.timers.clear()

    def print_stats(self):
        """Statistics::printStats: every counter and timer to the log."""
        for name, v in sorted(self.counters.items()):
            logger.info("stat %-40s %d", name, v)
        for name, v in sorted(self.timers.items()):
            logger.info("stat %-40s %.3fs", name, v)


# ---- spans: the port's one tracing mechanism ----

# what a span keeps while a torch profiler runs: (path, thread, start ns,
# end ns) on time.time_ns(), the clock of kineto's host events; the newest
# RECORDS_KEPT, whatever frames come and go
RECORDS_KEPT = 1 << 18
RECORDS: deque = deque(maxlen=RECORDS_KEPT)
# the layouts (GraphTable) of the newest GRAPHS_KEPT captured graphs
GRAPHS_KEPT = 8
GRAPHS: deque = deque(maxlen=GRAPHS_KEPT)
# the path of a captured graph's nodes that no span of its body holds
BODY = "body"

_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_GRAPH_NODE_TYPES_COPY = (1, 2)  # memcpy, memset
_CU_STREAM_CAPTURE_STATUS_ACTIVE = 1
_local = threading.local()
_lock = threading.Lock()
_shared = []  # open shared spans, newest last
_marks = None  # (node count, path) marks of the capture in progress


class span:
    """A named range of the program: `with span("frame.key"): ...`.

    Its path is the names of the spans open around it joined by "/"; a
    thread with no span open of its own nests under the newest open span
    made with `shared=True` (autograd's device thread, which runs the
    checkpoint's recompute, under "backward"). A span

    - always adds its block's host seconds and a count to Statistics under
      its path: two clock reads and a dict update, no device sync;
    - while a torch profiler runs, appends (path, thread id, start ns, end
      ns) to RECORDS, stamped with time.time_ns(), the clock of kineto's
      host events. It is not a record_function range: nothing of it enters
      the profiler's own events, host or device;
    - inside a `capture` block, marks the node count of the graph being
      captured at its entry and exit (libcuda; it adds no node), so that
      each node falls in the innermost span open when it was recorded.
    """

    __slots__ = ("name", "shared", "stage", "path", "t0", "ns0")

    def __init__(self, name, shared=False):
        self.name, self.shared, self.stage = name, shared, False

    def __enter__(self):
        _open(self)
        return self

    def __exit__(self, *exc):
        st = _stack()
        while self in st:  # stages left open inside this span close with it
            s = st.pop()
            _finish(s, st)
            if s is self:
                break
        return False


def stage(name):
    """Close the stage open in the innermost span, if one is, and open the
    stage `name` in its place: a run of a bounce's stages (intersect,
    emitter, shadow, bsdf) without a block each. The span around them
    closes the last."""
    st = _stack()
    if st and st[-1].stage:
        _finish(st.pop(), st)
    s = span(name)
    s.stage = True
    _open(s)


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _innermost(st):
    if st:
        return st[-1].path
    return _shared[-1].path if _shared else None


def _open(s):
    st = _stack()
    parent = _innermost(st)
    s.path = s.name if parent is None else f"{parent}/{s.name}"
    st.append(s)
    if s.shared:
        with _lock:
            _shared.append(s)
    if _marks is not None:
        _mark(s.path)
    s.ns0 = time.time_ns() if torch._C._autograd._profiler_enabled() else None
    s.t0 = time.perf_counter()


def _finish(s, st):
    dt = time.perf_counter() - s.t0
    if s.ns0 is not None:
        RECORDS.append((s.path, threading.get_ident(), s.ns0, time.time_ns()))
    stats = Statistics.get()
    with _lock:
        if s.shared:
            _shared.remove(s)
        stats.add(s.path)
        stats.add_time(s.path, dt)
    if _marks is not None:
        _mark(_innermost(st))


def _mark(path):
    n = NODES()
    if n is not None:
        with _lock:
            if _marks is not None:
                _marks.append((n, path))


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2, with room to spare past its end."""

    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                                 "block_y", "block_z", "shared_bytes")]
                + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")]
                + [("spare", ctypes.c_byte * 64)])


@functools.cache
def _libcuda():
    """libcuda with the calls the tables read bound, or None where the
    driver lacks one of them (the tables then stay unread; no capture
    fails for them)."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        p, out = ctypes.c_void_p, ctypes.POINTER
        info = getattr(lib, "cuStreamGetCaptureInfo_v2", None)
        if info is None:  # a libcuda that keeps only the form with edge data
            info = lib.cuStreamGetCaptureInfo_v3
            info.argtypes = (p, out(ctypes.c_int), p, out(p), p, p, p)
        else:
            info.argtypes = (p, out(ctypes.c_int), p, out(p), p, p)
        info.restype = ctypes.c_int
        lib.capture_info = info
        for name, args in (("cuGraphGetNodes", (p, p, out(ctypes.c_size_t))),
                           ("cuGraphNodeGetType", (p, out(ctypes.c_int))),
                           ("cuGraphKernelNodeGetParams_v2", (p, out(_KernelNodeParams))),
                           ("cuFuncGetName", (out(ctypes.c_char_p), p)),
                           ("cuKernelGetName", (out(ctypes.c_char_p), p))):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    except (OSError, AttributeError):
        return None
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def capture_nodes():
    """The node count of the graph being captured on this thread's current
    CUDA stream (cuStreamGetCaptureInfo, cuGraphGetNodes); None when no
    capture is running on it, the capture has failed (the operation that
    broke it raises its own error) or libcuda cannot say."""
    if not torch.cuda.is_available() or not torch.cuda.is_current_stream_capturing():
        return None
    lib = _libcuda()
    if lib is None:
        return None
    status, graph, count = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
    extra = (None,) * (len(lib.capture_info.argtypes) - 4)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if lib.capture_info(stream, ctypes.byref(status), None, ctypes.byref(graph), *extra) != 0:
        return None
    if status.value != _CU_STREAM_CAPTURE_STATUS_ACTIVE:
        return None
    if lib.cuGraphGetNodes(graph, None, ctypes.byref(count)) != 0:
        return None
    return count.value


# the node counter spans read inside a capture block (tests put a fake here)
NODES = capture_nodes
_NAMES = {}  # a kernel's function handle -> its demangled name


def graph_kernels(graph):
    """(nodes, [(node index, name)], [node index]) of a torch.cuda.CUDAGraph
    captured with keep_graph=True: the count of every node of its
    cudaGraph_t; each kernel node in cuGraphGetNodes' order (the order of
    capture) with its function's name demangled, as a profiler's trace
    names it; and its copy and set nodes (memcpy, memset), which CUDA
    runs as a DMA or as a copy kernel of its own (memcpy32_post,
    memset32, ...). RuntimeError where libcuda cannot say."""
    lib = _libcuda()
    if lib is None:
        raise RuntimeError("libcuda lacks the graph calls")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t()
    _check(lib.cuGraphGetNodes(raw, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kernels, copies, kind, params = [], [], ctypes.c_int(), _KernelNodeParams()
    kind_ref, params_ref = ctypes.byref(kind), ctypes.byref(params)
    for i, node in enumerate(nodes):
        _check(lib.cuGraphNodeGetType(node, kind_ref), "cuGraphNodeGetType")
        if kind.value in _CU_GRAPH_NODE_TYPES_COPY:
            copies.append(i)
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        _check(lib.cuGraphKernelNodeGetParams_v2(node, params_ref), "cuGraphKernelNodeGetParams")
        fn = params.func or params.kern
        if fn not in _NAMES:
            name = ctypes.c_char_p()
            if params.func:
                _check(lib.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
            else:
                _check(lib.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
            _NAMES[fn] = torch._C._demangle(name.value.decode())
        kernels.append((i, _NAMES[fn]))
    return count.value, kernels, copies


class GraphTable:
    """A captured graph's layout: its `kind` ("forward", or "backward" for a
    split step's second graph), `nodes` (all of them), `spans` [(path,
    first node, end node)] tiling [0, nodes) without overlap (each node in
    the innermost span open when it was recorded, the path relative to the
    capture block; BODY outside every span), the `marks` the capture read,
    the body's bounce `counters` its replays rewrite (Frame.counters; None
    for a backward), and `kernels` [(node index, name)] (its kernel nodes
    in node order, named as a profiler's trace names them) and `copies`
    (the indices of its copy and set nodes).

    The capture reads only node counts. The kernels' names and the copy
    nodes are read from the graph (graph_kernels) the first time they are
    asked for, or by `resolve` before the graph goes; asked for once the
    graph is gone unread, or where libcuda cannot say, they are None."""

    def __init__(self, kind, nodes, spans, kernels=None, copies=(), marks=0, counters=None,
                 graph=None):
        self.kind, self.nodes, self.spans = kind, nodes, spans
        self.marks, self.counters = marks, counters
        self._kernels, self._copies = kernels, tuple(copies)
        self._graph = None if graph is None else weakref.ref(graph)

    def resolve(self):
        """Read the kernel nodes' names and the copy nodes from the graph,
        once, while it lives."""
        ref, self._graph = self._graph, None
        graph = None if ref is None else ref()
        if graph is None:
            return
        try:
            nodes, self._kernels, copies = graph_kernels(graph)
        except RuntimeError:
            return
        self._copies = tuple(copies)
        if nodes > self.nodes:  # recorded after the capture block's last mark
            self.spans.append((BODY, self.nodes, nodes))
            self.nodes = nodes

    @property
    def kernels(self):
        self.resolve()
        return self._kernels

    @property
    def copies(self):
        self.resolve()
        return self._copies

    def kernel_paths(self):
        """The span path of each kernel node, in `kernels`' order."""
        starts = [s[1] for s in self.spans]
        return [self.spans[bisect.bisect_right(starts, i) - 1][0] for i, _ in self.kernels]


class capture:
    """The body of a graph under capture: `with torch.cuda.graph(g),
    capture() as cap: body()`. Marks the node count at the block's edges
    and at every span's entry and exit inside it, on any thread; `table`
    then lays the graph's nodes out by span. One capture block at a
    time."""

    def __enter__(self):
        global _marks
        self.root = _innermost(_stack())
        self.marks = []
        _marks = self.marks
        _mark(self.root)
        return self

    def __exit__(self, *exc):
        global _marks
        _mark(self.root)
        _marks = None
        return False

    def _rel(self, path):
        if path is None or path == self.root:
            return BODY
        if self.root is not None and path.startswith(self.root + "/"):
            return path[len(self.root) + 1:]
        return path

    def table(self, kind, graph=None, counters=None, kernels=None, copies=()):
        """The captured graph's GraphTable, kept in GRAPHS: its nodes and
        spans from the marks (None where the capture read none), its
        kernels and copies read from `graph` when first asked for, or
        given."""
        if not self.marks:
            return None
        nodes = max(n for n, _ in self.marks)
        spans, at, path = [], 0, BODY
        for n, p in self.marks:
            if n > at:
                if spans and spans[-1][0] == path:
                    spans[-1] = (path, spans[-1][1], n)
                else:
                    spans.append((path, at, n))
                at = n
            path = self._rel(p)
        out = GraphTable(kind, nodes, spans, kernels, copies, len(self.marks), counters, graph)
        GRAPHS.append(out)
        return out


class MetricsWriter:
    """Per-step JSONL metrics for optimisation loops: one object a line,
    {"step", "ts", **metrics}."""

    def __init__(self, path):
        self.f = open(path, "a", buffering=1)

    def write(self, step, **metrics):
        self.f.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")

    def close(self):
        self.f.close()
