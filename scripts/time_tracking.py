#!/usr/bin/env python3
"""T1 / T2, T1-bwd, T2-bwd and S1 in turns against a parent tree's
kernels on the calls their frames and AD steps make, and the BSDF stage's
fused route against its plain route (one CUDA GPU).

    python3 scripts/time_tracking.py --parent build/parent [--rounds 4]
        [--kernels t1t2 t1bwd t2bwd s1 bsdf] [--out build/time_tracking.json]

The parent is a commit unpacked into the ignored build/ (`mkdir -p
build/parent && git archive HEAD | tar -x -C build/parent`); its kernels
are built by its own ops/build.py from its sources and called through its
C interface (with or without T2-bwd's list), as its wrappers call them.
Each section records the calls' arguments from one run of this tree,
holds this tree's outputs to the parent's on every call, then runs every
call in turn for --rounds rounds, the order of the variants reversed
every other round:

- t1t2: T1 / T2 on the 512x512, 8 spp, depth 8 volpath frame
  (scenes.volpath_dict, chip_smoke's phase 26), held bit for bit at the
  primal 257 steps; each call timed as the median of 5 CUDA-event runs
  of its wrapper (this tree's also at ad_mode's 48 steps, `this_ad`), and
  the profiler device time of the busiest T1 and T2 call.
- t1bwd: T1-bwd on the 6 calls of the 256x256, 4 spp, depth 6 volpath AD
  step (phase 27's eager step; their recorded cotangents) and on the
  busiest T1 call of the 512x512 frame (2,097,152 lanes, phase 26's
  seeded cotangents), and T2-bwd on the step's 5 calls beside them (a
  control), held within chip_smoke.TRACK_BWD_RTOL (relative L2) on every
  gradient. Printed per call: the profiler device time of the call's
  device operations split into the backward kernel, the list kernel (a
  parent whose backward lists the tracked lanes) and the rest (the
  wrapper's zeroing), and the tracked lanes' steps.
- t2bwd: the same with T2-bwd the subject: its 5 calls in the AD step and
  the frame's busiest T2 call (2,097,152 lanes, phase 26's seeded
  cotangent), T1-bwd's 6 calls in the step beside them (the control).
- s1: S1 on the 15 marches of the 512x512, 8 spp shapes + SDF frame
  (phase 24, a 128^3 grid) and the 22 of its 256x256, 4 spp, depth 6 AD
  step (phase 34's SDF step, eager), held bit for bit (t, hit, steps).
  Printed for the busiest march: the histogram of the active lanes'
  steps and the warp efficiency (lane steps over 32 times each 32-lane
  warp's most steps, warps in lane order as a grid of 128-thread blocks
  forms them).

- bsdf: the BSDF stage (models/bsdf.bounce_shade) on bounce 0's call of
  the 512x512, 8 spp, depth 8 matpreview frame (2,097,152 lanes, the
  10-table stack; its recorded arguments), the fused route (bsdf_shade_pre
  / post around K1 and K2) against the plain route (_bounce_shade_plain)
  on the same tensors, after holding the fused outputs to the plain ones
  (chip_smoke.check_bsdf_stage). Printed per route: the device ms
  of the call split into bsdf_shade_pre, bsdf_shade_post, K1, K2 and the
  rest, and its device operations; and the two kernels' logical bytes
  (chip_smoke.bsdf_bytes) and their share of the bound at 3.35 TB/s. Needs no
  --parent.

Times are profiler device time (torch.profiler) per call, the mean of 3
runs in a round; a variant's figure is the median over rounds of its sum
over the calls, and its ratio to the parent's. Needs a CUDA GPU; imports
nothing of JAX.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mitsuba_customization_tpu_torch.core.qmc import MASK32  # noqa: E402
from mitsuba_customization_tpu_torch.render import medium, sdf  # noqa: E402

# the frames and steps whose calls are timed: (res, spp, depth)
VOLPATH_FRAME, VOLPATH_STEP, SHAPES_FRAME = (512, 8, 8), (256, 4, 6), (512, 8, 8)
MATPREVIEW_FRAME = (512, 8, 8)
DEV = "cuda"


def parent_library(tree):
    """The parent tree's kernel library, built by its own ops/build.py."""
    path = os.path.join(tree, "mitsuba_customization_tpu_torch", "ops", "build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table_args(pb, table):
    p = pb.ptr
    grid = table.grid.contiguous()
    return [p(x.contiguous()) for x in (table.m_type, table.sigma_t, table.majorant,
                                        table.world_to_grid, table.grid_slot,
                                        table.grid_dims, grid)], grid


def parent_launch(pb, kind, table, mid, ray_o, ray_d, t_max, key, dim_base):
    """The parent's T1 / T2 through its C interface at 257 steps, as its
    medium._launch calls it: (t, w, scat, steps) or (w, steps)."""
    medium._check_cuda(table, mid, ray_o, ray_d, t_max, key, f"parent {kind} tracking")
    n, dev = ray_o.shape[0], ray_o.device
    p = pb.ptr
    args = [p(x.contiguous()) for x in (ray_o, ray_d, t_max, mid, key)]
    tabs, grid = _table_args(pb, table)
    w = torch.empty((n, 3), device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    common = (*args, int(dim_base) & MASK32, n, medium.MAX_TRACKING_STEPS + 1, *tabs,
              *grid.shape[1:])
    lib = pb.library()
    if kind == "delta":
        t = torch.empty(n, device=dev)
        scat = torch.empty(n, dtype=torch.bool, device=dev)
        pb.check(lib.mct_delta_track(*common, p(t), p(w), p(scat), p(steps),
                                     pb.stream_of(ray_o)), "parent T1")
        return t, w, scat, steps
    pb.check(lib.mct_ratio_track(*common, p(w), p(steps), pb.stream_of(ray_o)), "parent T2")
    return w, steps


def parent_track_bwd(pb, kind, table, mid, ray_o, ray_d, t_max, key, dim_base, g_w, g_t, *,
                     grid_out, need_rays, need_t_max):
    """The parent's T1-bwd / T2-bwd through its C interface, as its
    medium._launch_bwd calls it: sigma_t's gradient zeroed, the ray and
    t_max gradients left to the kernel, which writes every lane; except
    where the parent's mct_track_bwd takes a counter and a list (two more
    pointers): its T2-bwd runs over the listed lanes, adding into zeroed
    outputs behind a zeroed 2-int counter."""
    n, dev = ray_o.shape[0], ray_o.device
    p = pb.ptr
    k = table.sigma_t.shape[0]
    tabs, grid = _table_args(pb, table)
    listed = len(pb._SIGNATURES["mct_track_bwd"]) == 30
    zeroed = listed and kind == "ratio"
    out = torch.zeros if zeroed else torch.empty
    g_sigma = torch.zeros((k, 3), device=dev)
    g_o = out((n, 3), device=dev) if need_rays else None
    g_d = out((n, 3), device=dev) if need_rays else None
    g_tmax = out(n, device=dev) if need_t_max else None
    # the counter and the list: a listed parent's T2-bwd takes both, its T1-bwd nulls
    scratch = [torch.zeros(2, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev)] if zeroed else [None] * 2

    def opt(x):
        return p(x) if x is not None else None

    pb.check(pb.library().mct_track_bwd(
        int(kind == "delta"), *[p(x.contiguous()) for x in (ray_o, ray_d, t_max, mid, key)],
        int(dim_base) & MASK32, n, medium.AD_TRACKING_STEPS, k, *tabs, *grid.shape[1:],
        p(g_w.contiguous()), opt(None if g_t is None else g_t.contiguous()),
        *map(opt, scratch if listed else []),
        p(g_sigma), opt(grid_out), opt(g_o), opt(g_d), opt(g_tmax), pb.stream_of(ray_o)),
        "parent track bwd")
    return g_sigma, g_o, g_d, g_tmax


def parent_march(pb, g, o, d, t_start, t_end, d_norm, active):
    """The parent's S1 through its C interface: (t, hit, steps)."""
    n, dev = o.shape[0], o.device
    p = pb.ptr
    values = g.values.contiguous()
    t = torch.empty(n, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    args = [p(x.contiguous()) for x in (o, d, t_start, t_end, d_norm, active)]
    pb.check(pb.library().mct_sdf_march(*args, n, p(values), *values.shape, p(t), p(hit),
                                        p(steps), pb.stream_of(o)), "parent S1")
    return t, hit, steps


def device_split(fn, reps=3):
    """{device operation name: device ms a call} of fn(): `reps` runs in
    one trace (chip_smoke._device_events, chip_smoke._per_call_ms) after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    events = chip_smoke._device_events(lambda: [fn() for _ in range(reps)])[0]
    return chip_smoke._per_call_ms([(e.name(), e.duration_ns()) for e in events], reps)


def in_turns(variants, calls, rounds, split):
    """Each variant's calls in turns: {variant: [[per-call split a round]]},
    fns[variant](call) running one call; split(names) -> {part: ms}."""
    out = {v: [] for v in variants}
    for r in range(rounds):
        for v in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
            out[v].append([split(device_split(lambda c=c: variants[v](c))) for c in calls])
    return out


def summarise(label, times, parts, groups):
    """Print and return each variant's per-group sums (median over rounds)
    and their ratio to the parent's. groups: {group: [call indices]}."""
    res = {}
    for v, rounds in times.items():
        res[v] = {}
        for gname, idx in groups.items():
            for part in parts:
                per_round = [sum(r[i].get(part, 0.0) for i in idx) for r in rounds]
                res[v][f"{gname}.{part}"] = dict(median=statistics.median(per_round),
                                                 rounds=per_round)
            res[v][f"{gname}.calls"] = [statistics.median(r[i]["total"] for r in rounds)
                                        for i in idx]
    for v in times:
        line = []
        for gname in groups:
            for part in parts:
                med = res[v][f"{gname}.{part}"]["median"]
                ref = res["parent"][f"{gname}.{part}"]["median"]
                res[v][f"{gname}.{part}"]["ratio"] = med / ref if ref else None
                line.append(f"{gname} {part} {med:.4f} ms (x{med / ref:.3f})" if ref else
                            f"{gname} {part} {med:.4f} ms")
        print(f"{label} {v}: " + "; ".join(line))
    for v in times:
        for gname in groups:
            print(f"{label} {v} {gname} per call, device ms: " + ", ".join(
                f"{x:.4f}" for x in res[v][f"{gname}.calls"]))
    return res


def t1t2_section(a, pb):
    """T1 / T2 on the volpath frame's calls (CUDA-event sums, as before)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    res, spp, depth = VOLPATH_FRAME
    scene = mt.load_dict(volpath_dict(res, spp, depth, chip_smoke.VOLPATH_GRID,
                                      chip_smoke.VOLPATH_SEED), DEV)
    mt.render(scene, spp=spp, seed=1)
    rec = chip_smoke.record_calls(lambda: mt.render(scene, spp=spp, seed=1), {
        "delta": (medium, "delta_track", lambda args, kw: chip_smoke._keep_args(args)),
        "ratio": (medium, "ratio_track", lambda args, kw: chip_smoke._keep_args(args))})
    calls = [(kind, args) for kind in ("delta", "ratio") for args in rec[kind]]
    steps257 = medium.MAX_TRACKING_STEPS + 1
    fns = {"parent": lambda kind, args: parent_launch(pb, kind, *args),
           "this": lambda kind, args: medium._launch(kind, *args, steps257),
           "this_ad": lambda kind, args: medium._launch(kind, *args, medium.AD_TRACKING_STEPS)}
    for kind, args in calls:
        for x, y in zip(fns["this"](kind, args), fns["parent"](kind, args)):
            if x.is_floating_point():
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                raise AssertionError(f"T1 / T2: this tree differs from the parent on a {kind} "
                                     "call")
    tracked = [int((fns["this"](kind, args)[-1] > 0).sum()) for kind, args in calls]
    print(f"t1t2: {len(calls)} calls of {calls[0][1][2].shape[0]} lanes, tracked {tracked}: "
          "bit-equal to the parent's")
    sums = {v: {k: [] for k in ("delta", "ratio")} for v in fns}
    for r in range(a.rounds):
        for v in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            for k in ("delta", "ratio"):
                sums[v][k].append(sum(chip_smoke._time_ms(lambda: fns[v](kind, args))
                                      for kind, args in calls if kind == k))
    busiest = {k: calls[max((i for i, c in enumerate(calls) if c[0] == k),
                            key=lambda i: tracked[i])] for k in ("delta", "ratio")}
    device = {v: {name: sum(ms for op, ms in device_split(lambda: fns[v](*busiest[k]),
                                                          reps=5).items() if "medium_" in op)
                  for k, name in (("delta", "T1"), ("ratio", "T2"))} for v in fns}
    print("t1t2 busiest call's kernels, profiler device ms: " + json.dumps(device))
    med = {}
    for v in fns:
        med[v] = {name: statistics.median(sums[v][k])
                  for k, name in (("delta", "T1"), ("ratio", "T2"))}
        print(f"t1t2 {v}: " + "; ".join(
            f"{name} {med[v][name]:.4f} ms a frame (CUDA events; "
            f"x{med[v][name] / statistics.median(sums['parent'][k]):.3f})"
            for k, name in (("delta", "T1"), ("ratio", "T2"))))
    return {"calls": len(calls), "tracked": tracked, "event_ms": sums, "median_ms": med,
            "busiest_device_ms": device}


def _keep_bwd_call(args, kwargs):
    """A recorded track_bwd call: its arguments detached and copied (the
    table not copied), need_rays, need_t_max, and a grid-sized buffer of
    its own in grid_out's place (or None)."""
    kept = tuple(x.detach().clone() if torch.is_tensor(x) else x for x in args)
    buf = kwargs.get("grid_out")
    return (kept, bool(kwargs.get("need_rays")), bool(kwargs.get("need_t_max")),
            None if buf is None else torch.zeros_like(buf))


def _bwd_fns(pb):
    """{variant: fn(call) -> [sigma_t, grid, ray_o, ray_d, t_max] gradients}
    for a recorded T1-bwd call (args, need_rays, need_t_max, buffer); the
    grid's gradient is added into the call's buffer (zeroed with fresh=True,
    else left to accumulate, as timing does not read it)."""
    def run(fn):
        def call(c, fresh=False):
            args, rays, tmax, buf = c
            if buf is not None and fresh:
                buf.zero_()
            g = fn(*args, grid_out=buf, need_rays=rays, need_t_max=tmax)
            return [g[0], buf.clone() if buf is not None and fresh else buf, g[1], g[2], g[3]]
        return call
    return {"parent": run(lambda *a, **k: parent_track_bwd(pb, *a, **k)),
            "this": run(medium.track_bwd)}


def _bwd_split(names):
    parts = {"total": sum(names.values()), "kernel": 0.0, "list": 0.0, "rest": 0.0}
    for name, ms in names.items():
        part = ("kernel" if "track_bwd" in name else "list" if "track_list" in name
                else "rest")
        parts[part] += ms
    return parts


def _ad_step_bwd_calls():
    """The volpath AD step's recorded backward calls (phase 27's eager
    step, their recorded cotangents): {"delta": [T1-bwd calls], "ratio":
    [T2-bwd calls]}."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    keys = (chip_smoke.AD_KEYS[0],) + chip_smoke.MEDIUM_KEYS
    res, spp, depth = VOLPATH_STEP
    scene = mt.load_dict(volpath_dict(res, spp, depth, chip_smoke.VOLPATH_GRID,
                                      chip_smoke.VOLPATH_SEED), DEV)
    params = {k: traverse(scene)[k] for k in keys}
    target = torch.zeros((res, res, 3), device=DEV)
    ad._eager_loss_and_grad(scene, params, target, spp, 1)
    rec = chip_smoke.record_calls(
        lambda: ad._eager_loss_and_grad(scene, params, target, spp, 2),
        {"bwd": (medium, "track_bwd", _keep_bwd_call)})
    return {kind: [c for c in rec["bwd"] if c[0][0] == kind] for kind in ("delta", "ratio")}


def _frame_bwd_call(kind):
    """Phase 26's 2,097,152-lane call: the 512x512 volpath frame's T1 /
    T2 call of the most lane steps, as a backward call with its seeded
    cotangents (the weight's, and T1's t's)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    res, spp, depth = VOLPATH_FRAME
    big = mt.load_dict(volpath_dict(res, spp, depth, chip_smoke.VOLPATH_GRID,
                                    chip_smoke.VOLPATH_SEED), DEV)
    mt.render(big, spp=spp, seed=1)
    fn = medium.delta_track if kind == "delta" else medium.ratio_track
    name = "delta_track" if kind == "delta" else "ratio_track"
    rec = chip_smoke.record_calls(lambda: mt.render(big, spp=spp, seed=1), {
        "loop": (medium, name, lambda args, kw: chip_smoke._keep_args(args))})
    busiest = max(rec["loop"], key=lambda args: int(fn(*args)[-1].sum()))
    del rec, big
    n = busiest[2].shape[0]
    gen = torch.Generator(device=DEV).manual_seed(17)
    g_w = torch.rand((n, 3), generator=gen, device=DEV)
    g_t = torch.rand(n, generator=gen, device=DEV) if kind == "delta" else None
    return ((kind, *busiest, g_w, g_t), True, True, torch.zeros_like(busiest[0].grid))


def bwd_section(a, pb, subject):
    """T1-bwd (subject "delta") or T2-bwd ("ratio") on the volpath AD
    step's calls and on the 2M-lane call, the other kernel's AD step calls
    beside them (a control)."""
    label = "t1bwd" if subject == "delta" else "t2bwd"
    other = "ratio" if subject == "delta" else "delta"
    step = _ad_step_bwd_calls()
    calls = step[subject] + step[other]
    n_subject = len(step[subject])
    del step
    calls.append(_frame_bwd_call(subject))
    n = calls[-1][0][3].shape[0]
    fns = _bwd_fns(pb)
    names = ("sigma_t", "grid", "ray_o", "ray_d", "t_max")
    info = []
    for i, c in enumerate(calls):
        want = fns["parent"](c, fresh=True)
        for v in fns:
            if v == "parent":
                continue
            got = fns[v](c, fresh=True)
            err = {k: chip_smoke._rel_or_zero(x, y) for k, x, y in zip(names, got, want)
                   if x is not None}
            if max(err.values()) > chip_smoke.TRACK_BWD_RTOL or not all(
                    bool(torch.isfinite(x).all()) for x in got if x is not None):
                raise AssertionError(f"{label} {v} call {i}: relative L2 against the parent "
                                     f"{err}")
        steps = medium._launch(c[0][0], *c[0][1:8], medium.AD_TRACKING_STEPS)[-1]
        live = steps[steps > 0]
        info.append(dict(kind=c[0][0], lanes=int(steps.shape[0]), tracked=int(live.numel()),
                         steps=int(live.sum()),
                         mean_steps=float(live.float().mean()) if live.numel() else 0.0,
                         max_steps=int(live.max()) if live.numel() else 0,
                         hist=torch.bincount(live.long()).tolist() if live.numel() else [],
                         rel_l2_parent=err, need_rays=c[1], need_t_max=c[2]))
        print(f"{label} call {i}: {info[-1]}")
    kinds = {"delta": "T1-bwd", "ratio": "T2-bwd"}
    print(f"{label}: {n_subject} {kinds[subject]} and {len(calls) - 1 - n_subject} "
          f"{kinds[other]} calls in the AD step, and the {n}-lane {kinds[subject]} call; "
          f"within {chip_smoke.TRACK_BWD_RTOL} of the parent")
    times = in_turns(fns, calls, a.rounds, _bwd_split)
    control = "ad_step_t2" if subject == "delta" else "ad_step_t1"
    res = summarise(label, times, ("total", "kernel", "list", "rest"),
                    {"ad_step": list(range(n_subject)),
                     control: list(range(n_subject, len(calls) - 1)),
                     "big": [len(calls) - 1]})
    return {"calls": info, "device_ms": res}


def _keep_march(args, kwargs):
    return (args[0],) + tuple(x.detach().clone() for x in args[1:])


def s1_stats(steps):
    """The histogram of the active lanes' steps and the warp efficiency."""
    live = steps[steps > 0]
    n = steps.shape[0]
    pad = torch.zeros((-n) % 32, dtype=steps.dtype, device=steps.device)
    warps = torch.cat([steps, pad]).reshape(-1, 32)
    wmax = warps.max(1).values
    eff = float(steps.sum()) / max(32 * float(wmax.sum()), 1.0)
    return dict(lanes=n, active=int(live.numel()), steps=int(live.sum()),
                mean_steps=float(live.float().mean()) if live.numel() else 0.0,
                max_steps=int(live.max()) if live.numel() else 0,
                warps=int((wmax > 0).sum()), warp_efficiency=eff,
                hist=torch.bincount(live.long(), minlength=sdf.MAX_STEPS + 1).tolist())


def s1_section(a, pb):
    """S1 on the shapes + SDF frame's marches and its AD step's."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.scenes import (probe_compact_schedule, shape_files,
                                                        shapes_dict)

    paths = shape_files(chip_smoke.SHAPES_DIR, chip_smoke.SHAPES_SEED, chip_smoke.SHAPES_N_SUB)
    res, spp, depth = SHAPES_FRAME
    scene, _ = probe_compact_schedule(mt.load_dict(
        shapes_dict(paths, res, spp, depth, sdf_res=chip_smoke.SDF_RES), DEV), spp=4)
    mt.render(scene, spp=spp, seed=1)
    frame = chip_smoke.record_calls(lambda: mt.render(scene, spp=spp, seed=1),
                                    {"S1": (sdf, "march", _keep_march)})["S1"]
    cfg = scene.config
    ad_scene = dataclasses.replace(scene, config=dataclasses.replace(
        cfg, width=cfg.width // 2, height=cfg.height // 2, max_depth=6))
    key = chip_smoke.AD_KEYS[0]
    params = {key: mt.traverse(ad_scene)[key]}
    target = torch.zeros((cfg.height // 2, cfg.width // 2, 3), device=DEV)
    ad._eager_loss_and_grad(ad_scene, params, target, 4, 1)
    step = chip_smoke.record_calls(
        lambda: ad._eager_loss_and_grad(ad_scene, params, target, 4, 2),
        {"S1": (sdf, "march", _keep_march)})["S1"]
    calls = frame + step
    fns = {"parent": lambda c: parent_march(pb, *c), "this": lambda c: sdf.march(*c)}
    stats = []
    for i, c in enumerate(calls):
        want = fns["parent"](c)
        for v in fns:
            got = fns[v](c)
            if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                    and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
                raise AssertionError(f"S1 {v} call {i}: differs from the parent")
        stats.append(s1_stats(got[2]))
    busiest = max(range(len(calls)), key=lambda i: stats[i]["steps"])
    for i, st in enumerate(stats):
        print(f"s1 call {i} ({'frame' if i < len(frame) else 'AD step'}): " + json.dumps(
            {k: v for k, v in st.items() if k != "hist"}))
    hist = stats[busiest]["hist"]
    print(f"s1 busiest call {busiest}: steps histogram over its active lanes (steps: lanes) "
          + json.dumps({s: c for s, c in enumerate(hist) if c}))
    print(f"s1: {len(frame)} marches in the frame, {len(step)} in the AD step, of a "
          f"{tuple(scene.sdf.values.shape)} grid: bit-equal to the parent's")
    times = in_turns(fns, calls, a.rounds, lambda names: {
        "total": sum(names.values()),
        "kernel": sum(ms for nm, ms in names.items() if "sdf_march" in nm)})
    res = summarise("s1", times, ("total", "kernel"),
                    {"frame": list(range(len(frame))),
                     "ad_step": list(range(len(frame), len(calls)))})
    return {"frame_calls": len(frame), "ad_step_calls": len(step), "calls": stats,
            "busiest": busiest, "device_ms": res}


BSDF_PARTS = (("pre", "bsdf_shade_pre_kernel"), ("post", "bsdf_shade_post_kernel"),
              ("k1", "merl_eval_kernel"), ("k2", "cond_sample_kernel"))


def _bsdf_split(names):
    """{part: ms} of a BSDF-stage call: its two kernels, K1, K2, the rest."""
    out = {"total": sum(names.values()), "ops": len(names)}
    for part, key in BSDF_PARTS:
        out[part] = sum(ms for op, ms in names.items() if key in op)
    out["rest"] = out["total"] - sum(out[part] for part, _ in BSDF_PARTS)
    return out


def bsdf_section(a, pb):
    """The BSDF stage on bounce 0 of the matpreview frame: fused against
    plain on the recorded call's tensors, device time in turns."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.models import bsdf
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    res, spp, depth = MATPREVIEW_FRAME
    scene = mt.load_dict(matpreview_dict(res, spp, depth), DEV)
    rec = chip_smoke.record_calls(lambda: mt.render(scene, spp=spp, seed=1), {
        "shade": (bsdf, "bounce_shade", lambda args, kw: (args, kw))})
    args, kw = rec["shade"][0]
    lanes = args[2].shape[0]
    fns = {"plain": lambda c: bsdf._bounce_shade_plain(*args, **kw),
           "fused": lambda c: bsdf.bounce_shade(*args, **kw)}
    agree = chip_smoke.check_bsdf_stage(fns["fused"](0), fns["plain"](0))
    print(f"bsdf: bounce 0 of the {res}x{res}, {spp} spp frame, {lanes} lanes: the fused "
          "route against the plain route (lanes past rtol, relative L1 gap, lanes not "
          "equal): " + json.dumps(agree))
    work = chip_smoke.bsdf_bytes(args[0], args[1], kw.get("active"))
    print("bsdf logical work: " + json.dumps(work))
    times = in_turns(fns, [0], a.rounds, _bsdf_split)
    res_ = {}
    for v, rounds in times.items():
        res_[v] = {part: statistics.median(r[0][part] for r in rounds)
                   for part in ("total", "pre", "post", "k1", "k2", "rest", "ops")}
        print(f"bsdf {v}: " + "; ".join(f"{k} {x:.4f}" for k, x in res_[v].items())
              + " (device ms a call, ops: device operations)")
    print(f"bsdf fused / plain: x{res_['fused']['total'] / res_['plain']['total']:.4f}; "
          f"roofline share pre {work['pre_bound_ms'] / res_['fused']['pre']:.3f}, post "
          f"{work['post_bound_ms'] / res_['fused']['post']:.3f}")
    return {"lanes": lanes, "work": work, "rounds": times, "median": res_}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kernels", nargs="+", default=["t1t2", "t1bwd", "t2bwd", "s1"],
                    choices=["t1t2", "t1bwd", "t2bwd", "s1", "bsdf"])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "time_tracking.json"))
    a = ap.parse_args()
    if set(a.kernels) - {"bsdf"} and not a.parent:
        ap.error("--parent is needed for " + " ".join(sorted(set(a.kernels) - {"bsdf"})))
    if not torch.cuda.is_available():
        raise SystemExit("time_tracking.py needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    pb = parent_library(a.parent) if a.parent else None
    out = {"card": card, "rounds": a.rounds}
    sections = {"t1t2": t1t2_section, "t1bwd": lambda a, pb: bwd_section(a, pb, "delta"),
                "t2bwd": lambda a, pb: bwd_section(a, pb, "ratio"), "s1": s1_section,
                "bsdf": bsdf_section}
    for k in a.kernels:
        out[k] = sections[k](a, pb)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
