#!/usr/bin/env python3
"""Whole source trees of the PyTorch port against each other, in turns:
the wall time of the flagship and matpreview frames and of the AD step,
and with --scene of the shapes and big shapes frames and the BVH kernels
(one CUDA GPU).

    python3 scripts/time_torch_trees.py TREE [TREE ...] [--rounds 5]
        [--scene shapes big_shapes]

A TREE is a checkout of the repository: "." for this one, or a parent
commit unpacked into the ignored build/ (`mkdir -p build/parent && git
archive HEAD | tar -x -C build/parent`). Each tree gets a worker process
that imports the package from that tree (its Python code and its kernels,
built by its own ops/build.py), loads both scenes (flagship_dict(512, 64,
4); matpreview_dict(512, 8, 8) with the schedule of probe_compact_schedule)
and the AD step's (that tree's chip_smoke.ad_setup: matpreview at 256x256,
4 spp, depth 6; one render/ad.grad_render against a zero image), and,
once every worker has loaded, runs each once as a warm-up and once
profiled, one worker after the other. --scene adds, from the tree's own
chip_smoke.py: `shapes`, phase 24's 532,532-prim scene (shape_files(n_sub=SHAPES_N_SUB),
512x512, 8 spp, depth 8, its probed schedule) on the cluster intersector
(K3 / K4, the loader's choice) and the same scene with its
config.intersector set to "bvh" (B1 / B2: frame `shapes_bvh`); and
`big_shapes`, phase 32's 1.52M-prim scene (BIG_N_SUB, on the BVH as the
loader puts it past the cap) and its kernels alone: B1 on the frame's
camera wavefront (`b1`) and B2 on NEE shadow rays from its hits (`b2`),
each the median of 5 CUDA-event runs of the tree's bvh.intersect /
bvh.occluded, and the sums of such medians over the B1 / B2 calls that
one frame of it makes (`b1_frame` / `b2_frame`, recorded once), after
each tree's kernels are held to its plain walks (B1 bit-equal in t,
prim, u, v, B2 equal) on those rays and on the first
chip_smoke.PLAIN_SLICE lanes of each recorded call. Then, for --rounds
rounds, each is run once by every worker in turn, the order reversed
every other round (A B B A ...), so that the host's drift falls on every
tree alike; the workers hold the card in turn, never at once. Printed: each warm-up image's sum and the AD
step's loss and table-gradient sum (the trees agree where their
arithmetic does), the kernel count and device time of one profiled run of
each, with the device time of the BVH and cluster kernels in it, the AD
step's device memory (allocated before it, peak by the end of its
forward, peak by the end of its backward: where the peak lies), each
tree's times and median per frame (kernels: ms), each median over the
first tree's, and the rounds in which each tree was the faster.
Needs a CUDA GPU; imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

FRAMES = ("flagship", "matpreview", "ad")
# --scene: the frames (and kernels, timed in ms) each adds
SCENE_RUNS = {"shapes": ("shapes", "shapes_bvh"),
              "big_shapes": ("big_shapes", "b1", "b2", "b1_frame", "b2_frame")}
KERNEL_RUNS = ("b1", "b2", "b1_frame", "b2_frame")


def _shapes_runs(name, runs, timers):
    """Add the frames of --scene `name` to runs, and its kernels to timers
    (name -> CUDA-event ms), from this tree's chip_smoke.py and package.
    The kernels are first held to the plain walks: B1 bit-equal in t,
    prim, u, v, B2 equal, on the camera and NEE rays and on the first
    chip_smoke.PLAIN_SLICE lanes of each recorded call."""
    import dataclasses

    import torch

    import chip_smoke as cs
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.render import bvh
    from mitsuba_customization_tpu_torch.render import geometry as geo
    from mitsuba_customization_tpu_torch.render.records import Ray
    from mitsuba_customization_tpu_torch.scenes import (
        probe_compact_schedule,
        shape_files,
        shapes_dict,
    )

    big = name == "big_shapes"
    paths = shape_files(cs.BIG_SHAPES_DIR if big else cs.SHAPES_DIR, cs.SHAPES_SEED,
                        cs.BIG_N_SUB if big else cs.SHAPES_N_SUB)
    scene = probe_compact_schedule(mt.load_dict(shapes_dict(paths, 512, 8, 8), "cuda"),
                                   spp=4)[0]
    runs[name] = lambda: mt.render(scene, spp=8, seed=0)
    if not big:
        on_bvh = dataclasses.replace(scene, config=dataclasses.replace(scene.config,
                                                                       intersector="bvh"))
        runs["shapes_bvh"] = lambda: mt.render(on_bvh, spp=8, seed=0)
        return
    tree, g, cyl = scene.bvh, scene.geometry, scene.has_cylinders
    g2 = g if scene.shadow_geometry is None else scene.shadow_geometry
    cam = cs.camera_wavefront(scene, 8)
    nee = cs.nee_shadow_rays(scene, geo.compute_interaction(
        g, cam, *bvh.intersect(tree, g, cam, cyl), cyl))

    def b1(r):
        return bvh.intersect(tree, g, r, cyl)

    def b2(r):
        return bvh.occluded(tree, g2, r, cyl)

    def keep_ray(args, kwargs):
        return Ray(*(x.clone() for x in cl._rays(args[0])))

    rec = cs.record_calls(lambda: mt.render(scene, spp=8, seed=1), {
        "B1": (scene, "ray_intersect", keep_ray), "B2": (scene, "ray_test", keep_ray)})

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    def b1_same(r):
        return all(torch.equal(bits(a), bits(b))
                   for a, b in zip(b1(r), bvh.intersect_plain(tree, g, r, cyl)))

    def b2_same(r):
        return torch.equal(b2(r), bvh.occluded_plain(tree, g2, r, cyl))

    if not (all(map(b1_same, [cam] + [cs._sub(r, cs.PLAIN_SLICE) for r in rec["B1"]]))
            and all(map(b2_same, [nee] + [cs._sub(r, cs.PLAIN_SLICE) for r in rec["B2"]]))):
        raise AssertionError("B1 / B2 differ from the plain walks")
    print(f"{os.getcwd()}: B1 / B2 equal to the plain walks on the camera and NEE rays and "
          f"on {len(rec['B1'])} / {len(rec['B2'])} recorded calls", file=sys.stderr, flush=True)
    runs["b1"], runs["b2"] = lambda: b1(cam), lambda: b2(nee)
    timers["b1"] = lambda: cs._time_ms(runs["b1"])
    timers["b2"] = lambda: cs._time_ms(runs["b2"])
    timers["b1_frame"] = lambda: sum(cs._time_ms(lambda r=r: b1(r)) for r in rec["B1"])
    timers["b2_frame"] = lambda: sum(cs._time_ms(lambda r=r: b2(r)) for r in rec["B2"])


def worker(scenes):
    """Serve render requests on stdin, one JSON line out per line in."""
    sys.path.insert(0, os.getcwd())
    import torch

    import mitsuba_customization_tpu_torch as mt
    from chip_smoke import ad_setup
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.scenes import (
        flagship_dict,
        matpreview_dict,
        probe_compact_schedule,
    )

    runs = {}
    for name, scene, spp in (
            ("flagship", mt.load_dict(flagship_dict(512, 64, 4), "cuda"), 64),
            ("matpreview", probe_compact_schedule(
                mt.load_dict(matpreview_dict(512, 8, 8), "cuda"), spp=4)[0], 8)):
        runs[name] = lambda scene=scene, spp=spp: mt.render(scene, spp=spp, seed=0)
    ad_scene, _, ad_params = ad_setup("cuda")
    target = torch.zeros((256, 256, 3), device="cuda")
    runs["ad"] = lambda: ad.grad_render(ad_scene, ad_params, target, spp=4, seed=0)
    timers = {}
    for name in scenes:
        _shapes_runs(name, runs, timers)
    print(json.dumps({"loaded": os.getcwd()}), flush=True)
    sys.stdin.readline()  # the card is this worker's: warm up and profile
    sums, work = {}, {}
    for name, run in runs.items():
        out = run()
        if name == "ad":
            sums["ad_loss"] = float(out[0])
            sums["ad_table_grad"] = float(out[1]["bsdf.tabulated.table"].double().sum())
        elif name == "b1":
            sums[name] = int((out[1] >= 0).sum())
        elif name == "b2":
            sums[name] = int(out.sum())
        else:
            sums[name] = float(out.double().sum())
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        work[name] = (len(kernels), sum(e.device_time for e in kernels) / 1e3, {
            k: sum(e.device_time for e in kernels if k + "_" in e.name) / 1e3
            for k in ("bvh", "cluster")})
    print(json.dumps({"ready": os.getcwd(), "sums": sums, "work": work,
                      "ad_memory_gb": ad_memory(ad_scene, ad_params, target)}), flush=True)
    for line in sys.stdin:
        name = line.strip()
        if name == "quit":
            break
        if name in timers:
            print(json.dumps({"secs": timers[name]() / 1e3}), flush=True)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        print(json.dumps({"secs": time.perf_counter() - t0}), flush=True)


def ad_memory(scene, params, target):
    """The AD step's device memory in GB, as grad_render runs it (its
    render, loss and torch.autograd.grad): allocated before it, the peak by
    the end of the forward, and the peak by the end of the backward."""
    import torch

    from mitsuba_customization_tpu_torch.render import ad

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = torch.mean((ad.render_ad(scene, leaves, spp=4, seed=0) - target) ** 2)
    torch.cuda.synchronize()
    forward = torch.cuda.max_memory_allocated()
    torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    torch.cuda.synchronize()
    return [x / 1e9 for x in (before, forward, torch.cuda.max_memory_allocated())]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--scene", nargs="*", default=[], choices=sorted(SCENE_RUNS))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.scene)
    if not args.trees:
        raise SystemExit("time_torch_trees: name at least one tree")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    procs = {}
    try:
        for tree in args.trees:
            procs[tree] = subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__), "--worker",
                 "--scene", *args.scene],
                cwd=os.path.abspath(tree), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True,
            )
        for p in procs.values():  # the loads overlap
            json.loads(p.stdout.readline())
        for tree, p in procs.items():  # the warm-ups and profiles do not
            p.stdin.write("warm\n")
            p.stdin.flush()
            ready = json.loads(p.stdout.readline())
            print(f"{tree}: warm-up image sums, AD loss and table-gradient sum "
                  f"{ready['sums']}; one profiled run (kernels, device ms): {ready['work']}; "
                  f"AD step memory GB (before, forward peak, step peak) "
                  f"{ready['ad_memory_gb']}")
        frames = FRAMES + tuple(f for s in args.scene for f in SCENE_RUNS[s])
        secs = {(t, f): [] for t in procs for f in frames}
        for r in range(args.rounds):
            order = list(procs) if r % 2 == 0 else list(procs)[::-1]
            for frame in frames:
                for tree in order:
                    p = procs[tree]
                    p.stdin.write(frame + "\n")
                    p.stdin.flush()
                    secs[tree, frame].append(json.loads(p.stdout.readline())["secs"])
        first = args.trees[0]
        for frame in frames:
            base = statistics.median(secs[first, frame])
            scale, unit = (1e3, "ms") if frame in KERNEL_RUNS else (1.0, "s")
            for tree in procs:
                xs = secs[tree, frame]
                med = statistics.median(xs)
                wins = sum(x < y for x, y in zip(xs, secs[first, frame]))
                print(f"{frame} {tree}: median {med * scale:.4f} {unit} ({med / base:.3f} of "
                      f"{first}; faster than it in {wins} of {len(xs)} rounds) of "
                      f"{', '.join(f'{x * scale:.4f}' for x in xs)}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.stdin.write("quit\n")
                    p.stdin.flush()
                    p.wait(timeout=30)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()


if __name__ == "__main__":
    main()
