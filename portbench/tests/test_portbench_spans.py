"""The readers of the program's spans and counters (harness/spans.py and
the metrics that call it) on made-up windows and graph tables: the match
of a replay, the crediting of its kernels to spans, None where nothing
matches, host records selected by the window's own ranges; and every
reader that was there before reads the same with program records present
or not."""

from collections import deque

import pytest
import torch

from mitsuba_customization_tpu_torch.utils import log
from portbench.harness import files, spans
from portbench.harness import trace as tr

K = files.kernels()
FRAME = ["intersect_ms.frame", "emitter_ms.frame", "shadow_ms.frame", "bsdf_ms.frame",
         "compact_ms.frame", "film_ms.frame"]
STEP = ["update_ms.step", "forward_ms.step", "backward_ms.step", "eager_ms.step"]
NEW = FRAME + STEP + ["host_ms.frame", "host_ms.step", "live_share.frame", "live_share.step"]
OLD = ["launches.frame", "launches.step", "body_ms.frame", "body_ms.step", "media_ms.step",
       "allreduce_ms.step", "idle_share.frame", "idle_share.step", "k3_roofline.frame",
       "k4_roofline.frame", "k1_roofline.frame", "k1bwd_roofline.step"]


@pytest.fixture
def registry(monkeypatch):
    """An empty span registry in the program's place."""
    monkeypatch.setattr(log, "GRAPHS", deque(maxlen=log.GRAPHS_KEPT))
    monkeypatch.setattr(log, "RECORDS", deque(maxlen=log.RECORDS_KEPT))
    return log


def _table(kind, names, spans_, counters=None, copies=()):
    """A GraphTable whose nodes are its kernels, but for `copies` (copy or
    set nodes, named None)."""
    kernels = [(i, n) for i, n in enumerate(names) if i not in copies]
    return log.GraphTable(kind, len(names), spans_, kernels, tuple(copies), 0, counters)


FRAME_TABLE = (["cam", "closest", "em", "shadow", "merl", "sort", "dev"],
               [("camera", 0, 1), ("bounce0/intersect", 1, 2), ("bounce0/emitter", 2, 3),
                ("bounce0/shadow", 3, 4), ("bounce0/bsdf", 4, 5), ("bounce1/compact", 5, 6),
                ("film", 6, 7)])


def _frame_events(t0):
    """One replay of FRAME_TABLE's graph (each kernel 10 ns x its index + 10)
    and an eager copy after it."""
    names = FRAME_TABLE[0]
    return ([(n, t0 + 20 * i, 10 * (i + 1)) for i, n in enumerate(names)]
            + [("Memcpy DtoD", t0 + 200, 5), ("copy_kernel", t0 + 210, 3)])


def _window(events, reps=2, host=(("portbench.frame", 0, 1000),)):
    return tr.Window(events, list(host), reps, 1e-6, {}, K, None)


def _read(name, win):
    return files.metric_reader(name).read(win)


def test_a_replay_is_matched_and_its_kernels_credited(registry):
    live = [(8, torch.tensor(8), torch.tensor(5)), (4, torch.tensor(3), None)]
    registry.GRAPHS.append(_table("forward", *FRAME_TABLE, counters=live))
    win = _window(_frame_events(0) + _frame_events(500))
    runs = spans.replays(win)
    assert len(runs) == 2 and all(len(credited) == 7 for _, credited in runs)
    # ns / 1e6 over 2 replays, each replay the same
    assert _read("intersect_ms.frame", win) == pytest.approx(20e-6)
    assert _read("emitter_ms.frame", win) == pytest.approx(30e-6)
    assert _read("shadow_ms.frame", win) == pytest.approx(40e-6)
    assert _read("bsdf_ms.frame", win) == pytest.approx(50e-6)
    assert _read("compact_ms.frame", win) == pytest.approx(60e-6)
    assert _read("film_ms.frame", win) == pytest.approx((10 + 70) * 1e-6)
    total = sum(_read(m, win) for m in FRAME)
    assert total == pytest.approx(sum(range(10, 80, 10)) * 1e-6)
    assert _read("live_share.frame", win) == pytest.approx(100 * 11 / 12)


def test_step_phases_and_the_eager_rest(registry):
    names = ["cdf", "fwd", "loss", "bwd", "where_kernel_impl::{lambda()#1}(int)"]
    registry.GRAPHS.append(_table("forward", names, [
        ("update", 0, 1), ("forward/bounce0/intersect", 1, 2), ("forward", 2, 3),
        ("backward/bounce0/bsdf", 3, 4), ("backward", 4, 5)]))

    def step(t0):
        # the optimiser's annotation on the device's timeline over its kernel
        return ([("copy_kernel", t0, 7)] + [(n, t0 + 10 + 10 * i, 2) for i, n in enumerate(names)]
                + [("Optimizer.step#Adam.step", t0 + 99, 13),
                   ("multi_tensor_apply_kernel", t0 + 100, 11)])

    win = _window(step(0) + step(200))
    assert _read("update_ms.step", win) == pytest.approx(2e-6)
    assert _read("forward_ms.step", win) == pytest.approx(4e-6)
    assert _read("backward_ms.step", win) == pytest.approx(4e-6)
    assert _read("eager_ms.step", win) == pytest.approx(18e-6)  # no annotation in it
    parts = sum(_read(m, win) for m in STEP)
    assert parts * 1e6 * win.reps == pytest.approx(sum(e[2] for e in spans.real_kernels(win)))
    assert [m[2:] for m in spans.matches(win)] == [(0, 0), (0, 0)]
    # one step's replay lost a launch in its trace: it is still that step's
    # replay (its count kept), the lost launch is no one's, and the phases
    # are read from the replay that lost nothing
    lossy = _window(step(0) + [e for e in step(200) if e[0] != "loss"])
    assert [m[2:] for m in spans.matches(lossy)] == [(0, 0), (1, 0)]
    assert _read("forward_ms.step", lossy) == pytest.approx(4e-6)
    assert _read("eager_ms.step", lossy) == pytest.approx(18e-6)
    # where every replay lost one, the phases average over them
    both = _window([e for t0 in (0, 200) for e in step(t0) if e[0] != "loss"])
    assert _read("forward_ms.step", both) == pytest.approx(2e-6)
    # a collective's annotation is no kernel; its kernel between two of
    # the replay's is other work's, and eager
    nccl = _window(step(0) + step(200) + [("nccl:all_reduce", 150, 9)])
    assert _read("eager_ms.step", nccl) == pytest.approx(18e-6)
    beside = _window(step(0) + step(200) + [("ncclDevKernel_Broadcast", 235, 6)])
    assert _read("forward_ms.step", beside) == pytest.approx(4e-6)
    assert _read("eager_ms.step", beside) == pytest.approx(21e-6)
    assert [m[2:] for m in spans.matches(beside)] == [(0, 0), (0, 1)]
    # more launches lost than a trace loses: not that graph's replay
    assert _read("forward_ms.step", _window([e for e in step(0) if e[0] in ("cdf", names[-1])])) \
        is None


def test_annotations_are_told_from_kernels():
    """The profiler's annotations are no kernels; kernels whose demangled
    names hold a "#" (a lambda's) are."""
    for name in ("Optimizer.step#Adam.step", "Optimizer.zero_grad#Adam.zero_grad",
                 "nccl:all_reduce", "nccl:broadcast"):
        assert spans.is_annotation(name), name
    for name in ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
                 "at::native::(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::"
                 "{lambda()#1}::operator()() const::{lambda(bool, float, float)#1}>>(int)",
                 "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
                 "memcpy32_post", "merl_eval_kernel", "Memcpy DtoD (Device -> Device)"):
        assert not spans.is_annotation(name), name


def test_copy_nodes_cuda_runs_as_kernels(registry):
    """A copy or set node shows in a trace as a DMA (no kernel) or as one of
    CUDA's own copy kernels, credited to its node's span."""
    names = ["a", None, "b", None, "c"]
    registry.GRAPHS.append(_table("forward", names, [("update", 0, 2), ("forward", 2, 5)],
                                  copies=(1, 3)))
    win = _window([("a", 0, 1), ("memcpy32_post", 10, 2), ("b", 20, 4), ("c", 30, 8),
                   ("x_kernel", 40, 16)], reps=1)
    assert _read("update_ms.step", win) == pytest.approx(3e-6)
    assert _read("forward_ms.step", win) == pytest.approx(12e-6)
    assert _read("eager_ms.step", win) == pytest.approx(16e-6)


def test_nothing_matches_nothing_is_read(registry, monkeypatch):
    win = _window(_frame_events(0))
    assert all(_read(m, win) is None for m in NEW)  # no table kept
    names, spans_ = FRAME_TABLE
    registry.GRAPHS.append(_table("forward", names[:4] + ["x", "y", "z"], spans_))
    win = _window(_frame_events(0))
    assert all(_read(m, win) is None for m in NEW)
    # the table matches; then a program that keeps no registry
    registry.GRAPHS.append(_table("forward", *FRAME_TABLE))
    win = _window(_frame_events(0))
    assert _read("bsdf_ms.frame", win) is not None
    monkeypatch.setattr(spans, "registry", lambda: None)
    win = _window(_frame_events(0))
    assert all(_read(m, win) is None for m in NEW)


def test_two_tables_share_no_event(registry):
    registry.GRAPHS.append(_table("forward", *FRAME_TABLE))
    registry.GRAPHS.append(_table("forward", *FRAME_TABLE))
    runs = spans.replays(_window(_frame_events(0) + _frame_events(500)))
    assert len(runs) == 2 and runs[0][0] is runs[1][0] is registry.GRAPHS[-1]


def test_host_records_inside_the_windows_ranges(registry):
    host = (("portbench.frame", 1000, 500), ("portbench.read_back", 1500, 100),
            ("portbench.frame", 3000, 500))
    registry.RECORDS.extend([
        ("frame.call/frame.plan", 1, 1010, 1030),   # in
        ("frame.call/frame.key", 1, 1030, 1100),    # in
        ("frame.call/frame.replay", 1, 1100, 1400),  # another span
        ("frame.call/frame.inputs", 1, 3010, 3050),  # in
        ("frame.call/frame.key", 1, 100, 200),      # a trace taken before
        ("frame.call/frame.key", 1, 2000, 2100),    # between the ranges
    ])
    win = _window([], reps=2, host=host)
    assert _read("host_ms.frame", win) == pytest.approx((20 + 70 + 40) / 1e6 / 2)
    assert _read("host_ms.step", _window([], reps=2, host=(("portbench.grad_render", 0, 50),))) \
        is None


def test_the_readers_there_before_read_the_same_with_program_records(registry):
    events = ([("cluster_closest_kernel<1>", 0, 100), ("merl_eval_kernel", 150, 50),
               ("elementwise_kernel", 250, 100), ("ncclDevKernel_AllReduce_Sum", 400, 30),
               ("medium_delta_track_kernel", 500, 20), ("Memcpy DtoH", 600, 100)])
    calls = {"k3": [{"lanes": 1, "live": 1, "prims": 1}], "k1": []}
    peak = {"bytes_per_s": 1e9, "f32_ops_per_s": 1e18}

    def window():
        w = tr.Window(list(events), [("portbench.frame", 0, 900)], 1, 1e-6, calls, K, peak)
        w.call_wall_s = 1e-6
        return w

    def readings():
        out = {}
        for m in OLD:
            try:
                out[m] = _read(m, window())
            except (KeyError, ZeroDivisionError) as e:  # a reader with nothing of its own
                out[m] = type(e).__name__
        return out

    before = readings()
    registry.GRAPHS.append(_table("forward", ["cluster_closest_kernel<1>", "merl_eval_kernel"],
                                  [("bounce0/intersect", 0, 1), ("bounce0/bsdf", 1, 2)]))
    registry.RECORDS.append(("frame.call/frame.key", 1, 10, 20))
    assert readings() == before
    assert _read("bsdf_ms.frame", window()) == pytest.approx(50e-6)
