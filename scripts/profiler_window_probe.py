#!/usr/bin/env python3
"""Short torch.profiler traces over several minutes of one process (one
CUDA GPU): which of them hold the device events of the work they wrap.

    python3 scripts/profiler_window_probe.py [--minutes 6] [--reps 5]
        [--pad-ms 20] [--out build/profiler_window_probe.json]

Each round runs some load (device work, then host work on all CPU
threads), then three traces of `reps` launches of a small kernel (a
4,194,304-float multiply), read as chip_smoke._device_events reads them
(kineto_results, device events only):

- "bare": the launches and a synchronize, edge to edge;
- "padded": the same with the host asleep --pad-ms before the first
  launch and after the synchronize, inside the trace;
- "marked": as "bare", but the launches inside a record_function range.

For every trace it records the device events found, and for "padded" and
"marked" traces the device events' times against the host range that
holds the launches: the first kernel's start after the range's start, and
the range's end after the last kernel's end (us; both in the profiler's
own time base). A device clock that wanders against the host's shows as
these gaps drifting; a kernel stamped outside the profiler's capture
window is dropped from the trace (chip_smoke.TRACE_PAD_S pads its traces
as "padded" does). Prints one line a minute and a JSON summary; writes
every trace to --out.

    python3 scripts/profiler_window_probe.py --events

takes 20 padded traces after each of: nothing, one trace of 100,000
launches, 200 short profiler sessions, a CUDA graph captured and
replayed, its replay traced, 30 s asleep; a block's traces without
device events are counted.

    python3 scripts/profiler_window_probe.py --smoke [--until 26]

runs chip_smoke.py's phases up to --until in this process, with 5 padded
traces of the small multiply after every phase function, and where a
device time read finds no kernel, the call traced here: its host events
(the CUDA runtime's calls among them) and the same read taken again: at
once, with device activity alone, of the multiply, and after 1 s asleep.
Then 20 reads each: here as chip_smoke reads, with CUPTI's buffers
flushed, from a new thread, the allocator's cache emptied, the captured
graphs freed, by the legacy profiler, in chip_smoke's timer process
(started before the first captured AD step, started anew, after this
process captures one more, anew after that) and in a child process.

    python3 scripts/profiler_window_probe.py --ipc

times K1-bwd and K3 here, in chip_smoke's timer process, and there on
the arguments as mapped through CUDA IPC.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trace(fn, reps, pad_s, mark):
    """One trace: (device events [(name, start ns, end ns)], the host
    range's (start, end) ns or None)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        if pad_s:
            time.sleep(pad_s)
        if mark:
            with torch.profiler.record_function("probe_range"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        else:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    dev, rng = [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() == "probe_range":
            rng = (e.start_ns(), e.start_ns() + e.duration_ns())
    return dev, rng


def device_count(prof):
    """(device events, host events naming a CUDA runtime or driver call)
    in a finished trace."""
    ev = prof.profiler.kineto_results.events()
    dev = sum(e.device_type() == torch.autograd.DeviceType.CUDA for e in ev)
    api = sum(e.device_type() != torch.autograd.DeviceType.CUDA
              and e.name().startswith(("cuda", "cu")) for e in ev)
    return dev, api


def cupti_flush_all(flag):
    """cuptiActivityFlushAll(flag) of the libcupti this process loaded (1:
    CUPTI_ACTIVITY_FLAG_FLUSH_FORCED, buffers not yet full too)."""
    import ctypes

    with open("/proc/self/maps") as f:
        path = next(line.split()[-1] for line in f if "libcupti" in line)
    return ctypes.CDLL(path).cuptiActivityFlushAll(ctypes.c_uint32(flag))


def padded(fn, pad_s, acts=None, flush=None):
    """One trace of fn() and a synchronize, the host asleep pad_s on each
    side inside it (and where `flush` is given, CUPTI's buffers flushed
    after the synchronize): the finished profiler."""
    acts = acts or [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        if flush is not None:
            cupti_flush_all(flush)
        time.sleep(pad_s)
    return prof


def small_kernel():
    x = torch.rand(1 << 22, device="cuda")
    return lambda: [x.mul_(1.0000001) for _ in range(5)]


def canary(fn, n, pad_s=0.05, flush=None):
    """How many of n padded traces of fn hold no device event."""
    return sum(device_count(padded(fn, pad_s, flush=flush))[0] == 0 for _ in range(n))


def events_mode():
    """20 padded traces after each candidate event."""
    fn = small_kernel()
    y = torch.rand(1 << 20, device="cuda")
    graph = torch.cuda.CUDAGraph()

    def big_trace():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(100_000):
                y.add_(1e-7)
            torch.cuda.synchronize()

    def sessions():
        for _ in range(200):
            padded(fn, 0.0)

    def capture():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                y.mul_(0.999).add_(1e-3)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for _ in range(200):
                y.mul_(0.999).add_(1e-3)
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize()

    def traced_replay():
        padded(graph.replay, 0.05)

    out = {}
    for label, event in (("nothing", lambda: None), ("a trace of 100,000 launches", big_trace),
                         ("200 short sessions", sessions), ("a graph captured, replayed", capture),
                         ("its replay traced", traced_replay),
                         ("30 s asleep", lambda: time.sleep(30))):
        event()
        out[label] = canary(fn, 20)
        print(f"events: after {label}: {out[label]} of 20 padded traces without device events",
              flush=True)
    return out


def smoke_mode(until):
    """chip_smoke.py's phases up to `until` with a canary at each phase's
    end and a diagnosis of every device time read that finds no kernel."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    fn = small_kernel()
    lap, read = chip_smoke.lap, chip_smoke._device_ms

    class Stop(Exception):
        pass

    def lap_and_canary(label):
        lap(label)
        print(f"smoke canary after phase {label}: {canary(fn, 5)} of 5 padded traces without "
              "device events", flush=True)
        if label.split()[0].split("-")[-1] == str(until):
            raise Stop

    def diagnosed(name, call, *args, reps=5, **kwargs):
        try:
            return read(name, call, *args, reps=reps, **kwargs)
        except AssertionError as e:
            failed = str(e)

        def f():
            call(*args, **kwargs)

        f()
        torch.cuda.synchronize()
        prof = padded(lambda: [f() for _ in range(reps)], chip_smoke.TRACE_PAD_S)
        hosts = sorted({e.name()[:40] for e in prof.profiler.kineto_results.events()
                        if e.device_type() != torch.autograd.DeviceType.CUDA})
        again = {
            "at once": device_count(padded(f, chip_smoke.TRACE_PAD_S)),
            "device activity alone": device_count(padded(
                f, chip_smoke.TRACE_PAD_S, [torch.profiler.ProfilerActivity.CUDA])),
            "the multiply": device_count(padded(fn, chip_smoke.TRACE_PAD_S)),
        }
        time.sleep(1.0)
        again["after 1 s"] = device_count(padded(f, chip_smoke.TRACE_PAD_S))
        print(f"smoke diagnosis: {failed}; here, its device and runtime-call events "
              f"{device_count(prof)}, host event names {hosts[:30]}; the read again (device "
              f"events, runtime calls): {json.dumps(again)}", flush=True)
        return 0.0

    def canaried(name, f):
        def run(*args, **kwargs):
            out = f(*args, **kwargs)
            print(f"smoke canary after {name}: {canary(fn, 5)} of 5 padded traces without "
                  "device events", flush=True)
            return out
        return run

    for name in [n for n in vars(chip_smoke) if n.startswith("phase_")]:
        setattr(chip_smoke, name, canaried(name, getattr(chip_smoke, name)))
    chip_smoke.lap, chip_smoke._device_ms = lap_and_canary, diagnosed
    try:
        chip_smoke.main()
    except Stop:
        print(f"smoke: stopped after phase {until}")
    import gc
    import threading

    from mitsuba_customization_tpu_torch.render import frame_graph

    def in_thread():
        out = []
        t = threading.Thread(target=lambda: out.append(canary(fn, 20)))
        t.start()
        t.join()
        return out[0]

    def emptied():
        return sum(device_count(padded(lambda: (torch.cuda.empty_cache(), fn()), 0.05))[0] == 0
                   for _ in range(20))

    def legacy():
        n = 0
        for _ in range(20):
            with torch.autograd.profiler.profile(use_device="cuda") as prof:
                time.sleep(0.05)
                fn()
                torch.cuda.synchronize()
                time.sleep(0.05)
            n += not any(e.device_type == torch.autograd.DeviceType.CUDA
                         for e in prof.function_events)
        return n

    def child():
        code = ("import sys; sys.path.insert(0, %r); import profiler_window_probe as p; "
                "print(p.canary(p.small_kernel(), 20))" % os.path.join(ROOT, "scripts"))
        return int(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                  text=True).stdout.split()[-1])

    def cleared():
        frame_graph.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return canary(fn, 20)

    x = torch.rand(1 << 22, device="cuda")

    def by_timer():
        return sum(not chip_smoke._device_trace(5, multiply, x) for _ in range(20))

    def restarted():
        chip_smoke._stop_timer()
        return by_timer()

    def after_capture():
        from mitsuba_customization_tpu_torch.render import ad

        scene, _, params = chip_smoke.ad_setup(torch.device("cuda"), res=64)
        target = torch.zeros((64, 64, 3), device="cuda")
        for seed in (1, 2):
            ad.grad_render(scene, params, target, 4, seed)
        torch.cuda.synchronize()
        return by_timer()

    for label, run in (("as chip_smoke reads", lambda: canary(fn, 20)),
                       ("CUPTI flushed, forced", lambda: canary(fn, 20, flush=1)),
                       ("from a new thread", in_thread), ("the cache emptied first", emptied),
                       ("after the captured graphs are freed", cleared),
                       ("by the legacy profiler", legacy),
                       ("in the timer's process, started before phase 14", by_timer),
                       ("in the timer's process, started anew", restarted),
                       ("in that process, after this one captures an AD step", after_capture),
                       ("in the timer's process, started anew after that", restarted),
                       ("in a child process", child),
                       ("as chip_smoke reads, again", lambda: canary(fn, 20))):
        print(f"smoke variant {label}: {run()} of 20 padded traces without device events",
              flush=True)
    chip_smoke._stop_timer()


def multiply(x):
    """A small kernel for the timer's process (a module-level function)."""
    x.mul_(1.0000001)


class Shared:
    """A call's arguments, handed to chip_smoke's timer process as they are
    (mapped from this process through CUDA IPC, not copied)."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


def call_shared(fn, box):
    return fn(*box.args, **box.kwargs)


def ipc_mode():
    """K1-bwd at phase 12's shape and K3 on the matpreview camera
    wavefront: device ms traced here, in chip_smoke's timer process (its
    own copy of the arguments) and there on the arguments as mapped from
    this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 1 << 21
    table = 0.1 + torch.rand((90, 90, 180, 3), generator=gen, device=dev)
    wi, wo, wo_b = (chip_smoke._unit_hemi(gen, n, dev) for _ in range(3))
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))
    g = torch.randn((2 * n, 3), generator=gen, device=dev)
    lanes = (wi, wo, None, mask, wo_b, mask_b)
    value = k1.eval_trilinear(table, *lanes)
    buf = torch.zeros_like(table)
    scene = mt.load_dict(matpreview_dict(512, 8, 8), dev)
    ray = chip_smoke.camera_wavefront(scene, 8)
    calls = {"merl_eval_bwd": (k1.eval_trilinear_bwd, (table, g, *lanes),
                               dict(value=value, out=buf)),
             "cluster_closest_kernel": (cl.intersect, (scene.clusters, ray), {})}
    for name, (fn, args, kw) in calls.items():
        for _ in range(3):
            fn(*args, **kw)
            torch.cuda.synchronize()
            here = [(e.name(), e.duration_ns()) for e in chip_smoke._device_events(
                lambda: [fn(*args, **kw) for _ in range(5)])[0]]
            own = chip_smoke._device_trace(5, fn, *args, **kw)
            there = chip_smoke._device_trace(5, call_shared, fn, Shared(*args, **kw))
            print(f"ipc {name}: " + "; ".join(
                f"{where} {sum(ns for nm, ns in ev if name in nm) / 5e6:.4f} ms a call "
                f"({[round(ns / 1e6, 4) for nm, ns in ev if name in nm]})"
                for where, ev in (("here", here), ("in the timer's process", own),
                                  ("there on the mapped arguments", there))), flush=True)
    chip_smoke._stop_timer()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=6.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiler_window_probe.json"))
    ap.add_argument("--events", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ipc", action="store_true")
    ap.add_argument("--until", type=int, default=26)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_probe.py needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if a.events:
        events_mode()
        return
    if a.smoke:
        smoke_mode(a.until)
        return
    if a.ipc:
        ipc_mode()
        return
    x = torch.rand(1 << 22, device="cuda")
    big = torch.rand(1 << 26, device="cuda")
    host = torch.rand((1536, 1536))

    def fn():
        x.mul_(1.0000001)

    def load():
        for _ in range(100):
            big.mul_(0.9999999).add_(1e-7)
        torch.cuda.synchronize()
        for _ in range(10):
            host @ host

    fn()
    torch.cuda.synchronize()
    rows, t0, minute = [], time.perf_counter(), 0
    while time.perf_counter() - t0 < 60.0 * a.minutes:
        load()
        row = {"s": round(time.perf_counter() - t0, 3)}
        for mode, pad, mark in (("bare", 0.0, False), ("padded", a.pad_ms / 1e3, True),
                                ("marked", 0.0, True)):
            dev, rng = trace(fn, a.reps, pad, mark)
            row[mode] = len(dev)
            if rng is not None and dev:
                row[mode + "_lead_us"] = (min(s for _, s, _ in dev) - rng[0]) / 1e3
                row[mode + "_tail_us"] = (rng[1] - max(e for _, _, e in dev)) / 1e3
        rows.append(row)
        if row["s"] >= 60.0 * (minute + 1):
            minute += 1
            last = [r for r in rows if r["s"] >= 60.0 * (minute - 1)]
            print(f"minute {minute}: {len(last)} rounds; traces missing device events: "
                  + ", ".join(f"{m} {sum(r[m] < a.reps for r in last)}"
                              for m in ("bare", "padded", "marked"))
                  + "".join(f"; {m} {g} us " + json.dumps(
                      sorted(round(r[f"{m}_{g}_us"], 1) for r in last
                             if f"{m}_{g}_us" in r)[::max(len(last) // 8, 1)])
                      for m in ("marked", "padded") for g in ("lead", "tail")), flush=True)
    summary = {m: dict(traces=len(rows), short=sum(r[m] < a.reps for r in rows),
                       empty=sum(r[m] == 0 for r in rows),
                       first_short_s=next((r["s"] for r in rows if r[m] < a.reps), None))
               for m in ("bare", "padded", "marked")}
    print("summary " + json.dumps({"card": card, "reps": a.reps, "pad_ms": a.pad_ms,
                                   **summary}))
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": card, "rows": rows, "summary": summary}, f)


if __name__ == "__main__":
    main()
