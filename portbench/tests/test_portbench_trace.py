"""The trace's arithmetic and its completeness check on made-up events."""

import pytest

from portbench.harness import files, roofline
from portbench.harness import trace as tr

K = files.kernels()
HOST = [("portbench.frame", 0, 520), ("portbench.read_back", 520, 1000)]


def _window(events, calls, reps=2, window_s=1.5e-6, peak=None):
    return tr.Window(events, HOST, reps, window_s, calls, K, peak)


def _frame(t0):
    return [("cluster_closest_kernel<1>", t0, 100), ("elementwise_kernel", t0 + 50, 100),
            ("Memcpy DtoH", t0 + 400, 100)]


def test_busy_union_gaps_and_top():
    w = _window(_frame(0) + _frame(600), {"k3": [{"lanes": 1, "live": 1, "prims": 1}]})
    # [0,150] + [400,500] + [600,750] + [1000,1100]
    assert w.busy_s() == pytest.approx(500e-9)
    gaps = w.idle_gaps()
    assert gaps[0] == ["portbench.frame", pytest.approx(250e-9)]
    assert gaps[-1] == ["portbench.read_back", pytest.approx(100e-9)]
    assert w.top_ops()[0][1] == pytest.approx(200e-9)
    assert len(w.kernel_events()) == 4


def test_complete_trace_passes_and_lost_launch_fails():
    calls = {"k3": [{"lanes": 1, "live": 1, "prims": 1}], "k1": []}
    _window(_frame(0) + _frame(600), calls).check()
    with pytest.raises(tr.TraceIncomplete, match="k3: 1 launches traced, 2 recorded"):
        _window(_frame(0) + _frame(600)[1:], calls).check()
    with pytest.raises(tr.TraceIncomplete, match="no device event"):
        _window([], {"k3": []}).check()


def test_short_timeline_fails():
    with pytest.raises(tr.TraceIncomplete, match="span"):
        _window(_frame(0) + _frame(600), {}, window_s=1.0).check()


def test_whole_trace_retries_then_gives_up(monkeypatch):
    calls = {"k3": [{"lanes": 1, "live": 1, "prims": 1}]}
    got = iter([([], HOST, 1e-6), (_frame(0) + _frame(600), HOST, 1.5e-6)])
    monkeypatch.setattr(tr, "trace_calls", lambda call, reps: next(got))
    logs = []
    w = tr.whole_trace(None, 2, calls, K, None, logs.append)
    assert len(w.events) == 6 and len(logs) == 1
    monkeypatch.setattr(tr, "trace_calls", lambda call, reps: ([], HOST, 1e-6))
    with pytest.raises(tr.TraceIncomplete):
        tr.whole_trace(None, 2, calls, K, None, logs.append)
    assert len(logs) == 1 + tr.TRIES


def test_roofline_share_and_silence():
    peak = {"bytes_per_s": 1e9, "f32_ops_per_s": 1e18}
    calls = {"k3": [{"lanes": 1, "live": 1, "prims": 1}]}
    w = _window(_frame(0) + _frame(600), calls, peak=peak)
    nbytes = 1 * 20 + 24 + 36
    # bound nbytes / 1e9 s a call, 2 calls over 200 ns of K3
    assert roofline.share(w, "k3") == pytest.approx(100 * 2 * nbytes / 1e9 / 200e-9)
    assert roofline.share(w, "k4") is None
    assert roofline.share(_window(_frame(0), calls, peak=None), "k3") is None


def test_metric_readers_on_a_window():
    calls = {"k3": [{"lanes": 1, "live": 1, "prims": 1}]}
    w = _window(_frame(0) + _frame(600), calls)
    assert files.metric_reader("launches.frame").read(w) == 2
    assert files.metric_reader("body_ms.frame").read(w) == pytest.approx(100e-6)
    assert files.metric_reader("idle_share.frame").read(w) is None
    w.call_wall_s = 1e-6
    # 250 ns busy a call over a 1,000 ns call in the untraced window
    assert files.metric_reader("idle_share.frame").read(w) == pytest.approx(75.0)


def test_media_reader_sums_the_tracking_kernels_or_is_silent():
    events = [("medium_delta_track_kernel", 0, 100), ("medium_ratio_track_bwd_kernel", 200, 300),
              ("medium_delta_track_bwd_kernel", 600, 50), ("elementwise_kernel", 700, 100)]
    w = _window(events, {})
    # 450 ns of tracking over 2 steps
    assert files.metric_reader("media_ms.step").read(w) == pytest.approx(225e-6)
    assert files.metric_reader("media_ms.step").read(_window(_frame(0), {})) is None
