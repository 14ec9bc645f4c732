"""The `frame` entry: captured frames (`render_jit`) in a closed loop with
one client, each image read back to the host before the next is asked
for, as a viewer or a batch render does.

Set-up builds the scene dict from the configuration, loads it, and makes
the frame's first call (plan, warm-up, capture) and one replay; a traced
run also records the kernels' calls on one eager `render` at the window's
first seed. The window then runs frames at seeds base + i for `seconds`.
Once it has closed, frames drawn from the seed are held against the plain
reference (harness/check_frame.py).
"""

from __future__ import annotations

import gc
import time

from portbench.harness import calls as calls_mod
from portbench.harness import check_frame, files, peaks, stats
from portbench.harness import trace as trace_mod

MASK32 = 0xFFFFFFFF


def scene_dict(config, traffic):
    """The configuration's scene at the traffic's film, samples and depth,
    with the configuration's compaction schedule for this traffic mix."""
    builder = files.load_module(files.PKG / "configs" / config["scene"])
    d = builder.build(res=traffic["resolution"], spp=traffic["spp"], depth=traffic["depth"],
                      **config.get("scene_args", {}))
    compact = config.get("compact", {}).get(traffic["name"])
    if compact is not None:
        d["integrator"]["compact"] = list(compact)
    return d


def prims_of(d):
    """Triangles of a scene dict (rectangles are two)."""
    n = 0
    for v in d.values():
        if isinstance(v, dict) and v.get("type") == "rectangle":
            n += 2
        elif isinstance(v, dict) and v.get("type") == "mesh":
            n += len(v["faces"])
    return n


def run(config, traffic, seed, seconds, trace, t_start, device, log):
    """One run of a frame cell: (result dict without `checks`, checks)."""
    import torch

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    spp = traffic["spp"]
    d = scene_dict(config, traffic)
    scene = mt.load_dict(d, device=device)
    first = int(seed) & MASK32
    warm = (first + (1 << 31)) & MASK32  # warm-up frames at seeds the window does not use
    for i in range(traffic["warmup_frames"]):
        render_jit(scene, spp, (warm + i) & MASK32).cpu()
    kernels = files.kernels()
    recorded = None
    if trace:
        with calls_mod.recording(kernels, {"prims": prims_of(d)}) as recorded:
            mt.render(scene, spp, first).cpu()
    sync()
    setup_s = time.perf_counter() - t_start

    images, lat = [], []
    res = traffic["resolution"]
    host = torch.empty((res, res, 3), pin_memory=on_card)

    def read_back(img):
        """The image on the host: one copy into a pinned buffer, then a
        numpy array of its own."""
        host.copy_(img)
        return host.numpy().copy()

    window = None
    t0 = time.perf_counter()
    if trace:
        def traced_frame(i):
            with torch.profiler.record_function("portbench.frame"):
                img = render_jit(scene, spp, (first + i) & MASK32)
            with torch.profiler.record_function("portbench.read_back"):
                images.append(read_back(img))

        reps = traffic["trace_frames"]
        peak = peaks.of(torch.cuda.get_device_name(0)) if on_card else None
        window = trace_mod.whole_trace(traced_frame, reps, recorded, kernels, peak, log)
        images.clear()
        t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        img = read_back(render_jit(scene, spp, (first + i) & MASK32))
        lat.append(time.perf_counter() - t)
        images.append(img)
        i += 1
    window_s = time.perf_counter() - t0
    if window is not None:
        window.call_wall_s = window_s / len(lat)
    # the most the process held on the card (graph pools included) until now
    mem_peak = torch.cuda.max_memory_reserved() if on_card else 0

    del scene, img
    frame_graph.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check_frame.check(d, images, first, seed, device, log, config["limits"][traffic["name"]],
                               traffic["check_frames"], traffic["check_pixels"],
                               config["reference"])
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(images),
        "failed": 0,
        "setup_s": setup_s,
        "memory_peak_bytes": int(mem_peak),
        "e2e": {"frame_ms": stats.per_item_ms(window_s, len(lat)),
                "frame_p95_ms": stats.percentile(lat, 95) * 1e3},
        "window": window,
    }
    return result, checks
