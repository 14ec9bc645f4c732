"""The port's spans and counters (utils/log.py) on the CPU.

- a span keeps a record only while a torch profiler runs; records nest in
  call order and fall inside kineto's own record_function range opened
  around the call (the span's clock is the profiler's host clock);
- off the profiler a span adds only its Statistics count and time;
- a thread with no span of its own nests under the newest shared span
  (autograd's device thread under "backward");
- a capture block's node table, built with a fake node counter (one node
  an operator) in libcuda's place over an AD step, tiles [0, nodes)
  without overlap, the checkpoint's recompute under "backward";
- Statistics counts frame.captures, frame.replays and frame.evictions as
  the frame cache does;
- load_dict records scene.load with scene.bvh_build and
  scene.cluster_build nested in it, and the tree's counters;
- the bounce counters a frame keeps (lanes run, live lanes, shadow rays)
  sum to render(..., return_stats=True)'s rays_traced, on a compacted
  matpreview frame and an uncompacted volpath frame.
"""

import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch import scenes
from mitsuba_customization_tpu_torch.render import ad, frame_graph
from mitsuba_customization_tpu_torch.render import integrator as tint
from mitsuba_customization_tpu_torch.render.params import traverse
from mitsuba_customization_tpu_torch.utils import log
from test_torch_kernels import one_torch_thread  # noqa: F401


def _stats():
    st = log.Statistics.get()
    return dict(st.counters), dict(st.timers)


def test_spans_record_under_a_profiler_inside_kinetos_range():
    log.RECORDS.clear()
    with log.span("outside"):
        pass
    assert not log.RECORDS
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("around"):
            with log.span("call"):
                with log.span("inner"):
                    torch.ones(8).sum()
                with log.span("next"):
                    pass
    recs = list(log.RECORDS)
    assert [r[0] for r in recs] == ["call/inner", "call/next", "call"]
    assert all(r[1] == threading.get_ident() for r in recs)
    (inner, nxt, call) = [(r[2], r[3]) for r in recs]
    assert call[0] <= inner[0] <= inner[1] <= nxt[0] <= nxt[1] <= call[1]
    around = [e for e in prof.profiler.kineto_results.events() if e.name() == "around"]
    assert len(around) == 1
    start = around[0].start_ns()
    assert start <= call[0] and call[1] <= start + around[0].duration_ns()
    # the spans are no profiler events of their own
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"call", "call/inner", "inner", "next"}


def test_a_span_off_the_profiler_adds_only_its_statistics(monkeypatch):
    def no_counter():
        raise AssertionError("a span outside a capture block read the node counter")

    monkeypatch.setattr(log, "NODES", no_counter)
    log.RECORDS.clear()
    graphs = len(log.GRAPHS)
    counts, times = _stats()
    with log.span("lone"):
        with log.span("leaf"):
            pass
        log.stage("first")
        log.stage("second")
    after, after_t = _stats()
    for path in ("lone", "lone/leaf", "lone/first", "lone/second"):
        assert after[path] == counts.get(path, 0) + 1
        assert after_t[path] >= times.get(path, 0.0)
    assert not log.RECORDS and len(log.GRAPHS) == graphs
    assert log._stack() == []


def test_a_thread_without_spans_nests_under_the_shared_span():
    paths = []

    def device_thread():
        with log.span("recompute") as s:
            paths.append(s.path)

    with log.span("step"), log.span("backward", shared=True):
        t = threading.Thread(target=device_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert paths == ["step/backward/recompute"]
    t = threading.Thread(target=device_thread)
    t.start()
    t.join(timeout=30)
    assert paths[-1] == "recompute"


class _OneNodeAnOperator(TorchDispatchMode):
    """A fake graph under capture: every operator that makes a tensor of
    its own (no view, which launches nothing) adds one node."""

    def __init__(self):
        super().__init__()
        self.nodes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.nodes += not func.is_view
        return func(*args, **(kwargs or {}))


def test_the_node_table_tiles_the_graph(monkeypatch):
    """An AD step (update, forward with its bounces' stages and
    compaction, backward with the checkpoint's recompute) under a capture
    block whose node counter counts operators: the leaf spans tile [0,
    nodes) without overlap, and the recompute's stages nest under
    backward."""
    scene = mt.load_dict(scenes.matpreview_dict(16, 2, 3, n_sub=2), "cpu")
    scene, _ = scenes.probe_compact_schedule(scene, spp=2)
    params = {k: traverse(scene)[k] for k in ("bsdf.tabulated.table",
                                              "bsdf.roughconductor.alpha_u")}
    target = torch.zeros((16, 16, 3))
    fake = _OneNodeAnOperator()
    monkeypatch.setattr(log, "NODES", lambda: fake.nodes)
    with fake, log.capture() as cap:
        ad._eager_loss_and_grad(scene, params, target, 2, 1)
    kernels = [(i, f"op{i}") for i in range(0, fake.nodes, 3)]
    table = cap.table("forward", kernels=kernels)
    assert log.GRAPHS[-1] is table and table.marks == len(cap.marks)
    assert table.nodes == fake.nodes
    spans = table.spans
    assert spans[0][1] == 0 and spans[-1][2] == fake.nodes
    assert all(a[2] == b[1] for a, b in zip(spans, spans[1:]))
    assert all(first < end for _, first, end in spans)
    assert all(a[0] != b[0] for a, b in zip(spans, spans[1:]))  # adjacent ranges merged
    paths = {p for p, _, _ in spans}
    for want in ("update", "forward/camera", "forward/bounce0/intersect",
                 "forward/bounce1/shadow", "forward/bounce1/compact", "forward/bounce0/bsdf",
                 "forward/film", "backward", "backward/bounce0/intersect",
                 "backward/bounce1/bsdf"):
        assert want in paths, (want, sorted(paths))
    assert {p.split("/")[0] for p in paths} == {"update", "forward", "backward"}
    node_paths = table.kernel_paths()
    for (i, _), path in zip(kernels, node_paths):
        assert sum(first <= i < end for p, first, end in spans if p == path) == 1


def test_statistics_count_replays_and_evictions_as_the_cache_does():
    """On the CPU nothing is captured; every call of a kept frame runs its
    body (a replay's place); a frame dropped past CACHE_SIZE or replaced
    by a frame of a changed scene is an eviction."""
    scene = mt.load_dict(scenes.flagship_dict(8, 2, 2), "cpu")
    frame_graph.clear()
    before, _ = _stats()
    n = frame_graph.CACHE_SIZE + 2
    for spp in range(1, n + 1):
        tint.render_jit(scene, spp, 0)
    tint.render_jit(scene, n, 1)
    scene.geometry = scene.geometry._replace(p0=scene.geometry.p0.clone())
    tint.render_jit(scene, n, 2)
    after, _ = _stats()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert delta("frame.captures") == 0
    assert delta("frame.replays") == n + 2
    assert delta("frame.evictions") == 2 + 1
    assert delta("frame.call") == n + 2 and delta("frame.call/frame.key") == n + 2
    frame_graph.clear()


@pytest.mark.parametrize("intersector", ["cluster", "bvh"])
def test_load_records_the_scene_spans_and_the_tree_counters(monkeypatch, intersector):
    """load_dict is the span scene.load, with scene.bvh_build around the
    BVH build and scene.cluster_build around the cluster build nested in
    it (none past clusters.MAX_PRIMS); the build sets the counters
    bvh.prims, bvh.nodes and bvh.depth to the tree's (depth as the
    kernels' node pack finds it)."""
    from mitsuba_customization_tpu_torch.ops import clusters
    from mitsuba_customization_tpu_torch.render import bvh

    d = scenes.matpreview_dict(16, 2, 3, n_sub=2)
    if intersector == "bvh":
        monkeypatch.setattr(clusters, "MAX_PRIMS", 100)
    before, _ = _stats()
    log.RECORDS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        scene = mt.load_dict(d, "cpu")
    after, timers = _stats()
    assert scene.config.intersector == intersector
    nested = ["scene.load/scene.bvh_build"]
    if intersector == "cluster":
        nested.append("scene.load/scene.cluster_build")
    assert [r[0] for r in log.RECORDS] == nested + ["scene.load"]
    (load,) = [r for r in log.RECORDS if r[0] == "scene.load"]
    assert all(load[2] <= r[2] <= r[3] <= load[3] for r in log.RECORDS)
    for path in nested + ["scene.load"]:
        assert after[path] - before.get(path, 0) == 1 and timers[path] > 0
    assert "scene.load/scene.cluster_build" in nested or \
        after.get("scene.load/scene.cluster_build", 0) == before.get(
            "scene.load/scene.cluster_build", 0)
    assert after["bvh.prims"] == scene.geometry.p0.shape[0] == 324
    assert after["bvh.nodes"] == scene.bvh.n_nodes
    assert after["bvh.depth"] == bvh.pack_nodes(scene.bvh).depth > 0


@pytest.mark.parametrize("name", ["matpreview_probed", "volpath"])
def test_kept_bounce_counters_sum_to_rays_traced(name):
    if name == "volpath":
        scene = mt.load_dict(scenes.volpath_dict(16, 2, 3, grid_res=8, n_sub=2), "cpu")
    else:
        scene = mt.load_dict(scenes.matpreview_dict(32, 4, 4, n_sub=2), "cpu")
        scene, _ = scenes.probe_compact_schedule(scene, spp=4)
    spp = scene.config.spp
    frame_graph.clear()
    tint.render_jit(scene, spp, 5)
    counters = frame_graph.latest().counters
    _, stats = tint.render(scene, spp, 5, return_stats=True)
    lanes = [c[0] for c in counters]
    live = [int(c[1]) for c in counters]
    shadow = [0 if c[2] is None else int(c[2]) for c in counters]
    assert len(counters) == scene.config.max_depth
    assert sum(live) + sum(shadow) == stats["rays_traced"]
    assert counters[-1][2] is None  # the last bounce traces no shadow ray
    n = scene.config.width * scene.config.height * spp
    if name == "volpath":  # every lane, every bounce
        assert lanes == [n] * len(lanes)
    else:
        caps = tint._compact_caps(n, scene.config.compact, scene.config.max_depth)
        assert lanes == caps and lanes[-1] < n
    assert all(0 <= a <= b for a, b in zip(live, lanes)) and live[0] == n
    frame_graph.clear()


def test_tables_read_kernel_names_when_asked_or_before_the_graph_goes(monkeypatch):
    """A table's kernel names and copy nodes are read from its graph the
    first time they are asked for, once (nodes recorded past the capture
    block's last mark join the body); a graph gone unread, or a libcuda
    that cannot say, leaves them None; a frame dropped after a profiler
    ran reads them first, and one dropped without reads nothing."""
    class Graph:
        pass

    reads = []

    def graph_kernels(graph):
        reads.append(graph)
        return 5, [(0, "a"), (3, "b")], [1]

    monkeypatch.setattr(log, "graph_kernels", graph_kernels)
    graph = Graph()
    table = log.GraphTable("forward", 4, [("update", 0, 2), ("forward", 2, 4)], graph=graph)
    assert not reads
    assert table.kernels == [(0, "a"), (3, "b")] and table.copies == (1,)
    assert table.kernels and reads == [graph]
    assert table.nodes == 5 and table.spans[-1] == (log.BODY, 4, 5)
    assert table.kernel_paths() == ["update", "forward"]
    gone = log.GraphTable("forward", 4, [(log.BODY, 0, 4)], graph=Graph())
    assert gone.kernels is None and gone.copies == () and len(reads) == 1

    def cannot_say(graph):
        raise RuntimeError("libcuda lacks the graph calls")

    monkeypatch.setattr(log, "graph_kernels", cannot_say)
    assert log.GraphTable("forward", 4, [], graph=graph).kernels is None
    monkeypatch.setattr(log, "graph_kernels", graph_kernels)
    scene = mt.load_dict(scenes.flagship_dict(8, 2, 2), "cpu")
    frame = frame_graph.Frame(scene, body=None, keep=None)
    monkeypatch.setattr(log, "RECORDS", log.deque(maxlen=4))
    frame.tables = [log.GraphTable("forward", 4, [], graph=graph)]
    frame.release()
    assert len(reads) == 1
    log.RECORDS.append(("frame.call", 1, 0, 1))
    frame.release()
    assert len(reads) == 2 and frame.tables[0]._kernels == [(0, "a"), (3, "b")]


def test_no_capture_runs_off_the_card():
    assert log.capture_nodes() is None
