#!/usr/bin/env python3
"""T1 / T2 (csrc/medium_track.cu) in turns against a parent tree's kernels
on the calls of the volpath frame (one CUDA GPU).

    python3 scripts/time_tracking.py --parent build/parent [--rounds 4]
        [--res 512 --spp 8 --depth 8 --grid 256] [--out chiprun_out/time_tracking.json]

Loads chip_smoke's volpath scene (scenes.volpath_dict(res, spp, depth,
grid, chip_smoke.VOLPATH_SEED): phase 26's frame), renders it once and
records the arguments of every T1 / T2 call of one more render. The
variants: the parent's T1 / T2 (a parent commit unpacked into the ignored
build/: `mkdir -p build/parent && git archive HEAD | tar -x -C
build/parent`), built by its own ops/build.py from its sources and
called through its C interface, at 257 steps; this tree's at the primal
257 steps (`this`) and at ad_mode's 48 (`this_ad`). This tree's are first
held bit for bit to the parent's (257 steps) on every recorded call.
Then, for --rounds rounds, each variant runs every recorded call in turn
(the order reversed every other round), each call timed as the median of
5 CUDA-event runs of its wrapper; printed: each variant's sum over the
frame's calls per round, its median and its median over the parent's;
and the profiler device time of the kernels alone on the busiest T1 and
T2 call. Needs a CUDA GPU; imports nothing of JAX.
"""

import argparse
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
from mitsuba_customization_tpu_torch.render import medium  # noqa: E402


def parent_library(tree):
    """The parent tree's kernel library, built by its own ops/build.py."""
    path = os.path.join(tree, "mitsuba_customization_tpu_torch", "ops", "build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_launch(pb, kind, table, mid, ray_o, ray_d, t_max, key, dim_base):
    """The parent's T1 / T2 through its C interface, as its medium._launch
    calls it (the same checks and record as this tree's wrapper): (t, w,
    scat, steps) or (w, steps)."""
    medium._check_cuda(table, mid, ray_o, ray_d, t_max, key, f"parent {kind} tracking")
    n, dev = ray_o.shape[0], ray_o.device
    p = pb.ptr
    args = [p(x.contiguous()) for x in (ray_o, ray_d, t_max, mid, key)]
    grid = table.grid.contiguous()
    tabs = [p(x.contiguous()) for x in (table.m_type, table.sigma_t, table.majorant,
                                         table.world_to_grid, table.grid_slot,
                                         table.grid_dims, grid)]
    w = torch.empty((n, 3), device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    common = (*args, int(dim_base) & MASK32, n, *tabs, *grid.shape[1:])
    lib = pb.library()
    if kind == "delta":
        t = torch.empty(n, device=dev)
        scat = torch.empty(n, dtype=torch.bool, device=dev)
        pb.check(lib.mct_delta_track(*common, p(t), p(w), p(scat), p(steps),
                                     pb.stream_of(ray_o)), "parent T1")
        out = (t, w, scat, steps)
    else:
        pb.check(lib.mct_ratio_track(*common, p(w), p(steps), pb.stream_of(ray_o)), "parent T2")
        out = (w, steps)
    medium._record(kind, steps, 0)
    return out


def variant_fn(name, pb):
    """fn(kind, args) -> the call's outputs, for a variant `name`:
    "parent", "this" (257 steps) or "this_ad" (48 steps)."""
    if name == "parent":
        return lambda kind, args: parent_launch(pb, kind, *args)
    steps = medium.AD_TRACKING_STEPS if name == "this_ad" else medium.MAX_TRACKING_STEPS + 1
    return lambda kind, args: medium._launch(kind, *args, steps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--grid", type=int, default=chip_smoke.VOLPATH_GRID)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "time_tracking.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_tracking.py needs a CUDA GPU")
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    pb = parent_library(a.parent)
    scene = mt.load_dict(volpath_dict(a.res, a.spp, a.depth, a.grid, chip_smoke.VOLPATH_SEED),
                         "cuda")
    mt.render(scene, spp=a.spp, seed=1)
    rec = chip_smoke.record_calls(lambda: mt.render(scene, spp=a.spp, seed=1), {
        "delta": (medium, "delta_track", lambda args, kw: chip_smoke._keep_args(args)),
        "ratio": (medium, "ratio_track", lambda args, kw: chip_smoke._keep_args(args))})
    calls = [(kind, args) for kind in ("delta", "ratio") for args in rec[kind]]
    variants = ["parent", "this", "this_ad"]
    fns = {v: variant_fn(v, pb) for v in variants}
    for kind, args in calls:
        for x, y in zip(fns["this"](kind, args), fns["parent"](kind, args)):
            if x.is_floating_point():
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                raise AssertionError(f"this tree's kernel differs from the parent's on a {kind} "
                                     "call")
    tracked = [int((fns["this"](kind, args)[-1] > 0).sum()) for kind, args in calls]
    print(f"{len(calls)} calls ({len(rec['delta'])} T1, {len(rec['ratio'])} T2) of "
          f"{calls[0][1][2].shape[0]} lanes, tracked {tracked}: bit-equal to the parent's")
    sums = {v: {k: [] for k in ("delta", "ratio")} for v in variants}
    for r in range(a.rounds):
        order = variants if r % 2 == 0 else variants[::-1]
        for v in order:
            for k in ("delta", "ratio"):
                sums[v][k].append(sum(chip_smoke._time_ms(lambda: fns[v](kind, args))
                                      for kind, args in calls if kind == k))
    # the busiest T1 and T2 calls' kernels alone: profiler device time
    busiest = {k: calls[max((i for i, c in enumerate(calls) if c[0] == k),
                            key=lambda i: tracked[i])] for k in ("delta", "ratio")}
    device = {v: {name: chip_smoke._device_ms(lambda: fns[v](*busiest[k]), "medium_")
                  for k, name in (("delta", "T1"), ("ratio", "T2"))} for v in variants}
    out = {"card": card, "calls": len(calls), "tracked": tracked, "rounds": a.rounds,
           "ms": sums, "busiest_device_ms": device}
    print("the busiest call's kernels, profiler device ms: " + json.dumps(device))
    for v in variants:
        line = []
        for k, name in (("delta", "T1"), ("ratio", "T2")):
            med = statistics.median(sums[v][k])
            ref = statistics.median(sums["parent"][k])
            out.setdefault("median_ms", {}).setdefault(v, {})[name] = med
            line.append(f"{name} {med:.4f} ms a frame ({', '.join(f'{x:.4f}' for x in sums[v][k])}"
                        f"; x{med / ref:.3f})")
        print(f"{v}: " + "; ".join(line))
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
