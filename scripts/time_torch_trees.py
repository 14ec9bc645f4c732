#!/usr/bin/env python3
"""Whole source trees of the PyTorch port against each other, in turns:
the wall time of the flagship and matpreview frames and of the AD step
(one CUDA GPU).

    python3 scripts/time_torch_trees.py TREE [TREE ...] [--rounds 5]

A TREE is a checkout of the repository: "." for this one, or a parent
commit unpacked into the ignored build/ (`mkdir -p build/parent && git
archive HEAD | tar -x -C build/parent`). Each tree gets a worker process
that imports the package from that tree (its Python code and its kernels,
built by its own ops/build.py), loads both scenes (flagship_dict(512, 64,
4); matpreview_dict(512, 8, 8) with the schedule of probe_compact_schedule)
and the AD step's (that tree's chip_smoke.ad_setup: matpreview at 256x256,
4 spp, depth 6; one render/ad.grad_render against a zero image), and runs
each once as a warm-up. Then, for --rounds rounds, each is run once by
every worker in turn, the order reversed every other round (A B B A ...),
so that the host's drift falls on every tree alike; the workers hold the
card in turn, never at once. Printed: each warm-up image's sum and the AD
step's loss and table-gradient sum (the trees agree where their
arithmetic does), the kernel count and device time of one profiled run of
each, the AD step's device memory (allocated before it, peak by the end
of its forward, peak by the end of its backward: where the peak lies),
each tree's times and median per frame, each median over the first
tree's, and the rounds in which each tree was the faster.
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


def worker():
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
    sums, work = {}, {}
    for name, run in runs.items():
        out = run()
        if name == "ad":
            sums["ad_loss"] = float(out[0])
            sums["ad_table_grad"] = float(out[1]["bsdf.tabulated.table"].double().sum())
        else:
            sums[name] = float(out.double().sum())
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        work[name] = (len(kernels), sum(e.device_time for e in kernels) / 1e3)
    print(json.dumps({"ready": os.getcwd(), "sums": sums, "work": work,
                      "ad_memory_gb": ad_memory(ad_scene, ad_params, target)}), flush=True)
    for line in sys.stdin:
        name = line.strip()
        if name == "quit":
            break
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
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker()
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
                [sys.executable, "-u", os.path.abspath(__file__), "--worker"],
                cwd=os.path.abspath(tree), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True,
            )
        for tree, p in procs.items():  # one at a time: loads and builds overlap
            ready = json.loads(p.stdout.readline())
            print(f"{tree}: warm-up image sums, AD loss and table-gradient sum "
                  f"{ready['sums']}; one profiled run (kernels, device ms): {ready['work']}; "
                  f"AD step memory GB (before, forward peak, step peak) "
                  f"{ready['ad_memory_gb']}")
        secs = {(t, f): [] for t in procs for f in FRAMES}
        for r in range(args.rounds):
            order = list(procs) if r % 2 == 0 else list(procs)[::-1]
            for frame in FRAMES:
                for tree in order:
                    p = procs[tree]
                    p.stdin.write(frame + "\n")
                    p.stdin.flush()
                    secs[tree, frame].append(json.loads(p.stdout.readline())["secs"])
        first = args.trees[0]
        for frame in FRAMES:
            base = statistics.median(secs[first, frame])
            for tree in procs:
                xs = secs[tree, frame]
                med = statistics.median(xs)
                wins = sum(x < y for x, y in zip(xs, secs[first, frame]))
                print(f"{frame} {tree}: median {med:.4f} s ({med / base:.3f} of "
                      f"{first}; faster than it in {wins} of {len(xs)} rounds) of "
                      f"{', '.join(f'{x:.4f}' for x in xs)}")
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
