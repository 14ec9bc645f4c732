#!/usr/bin/env python3
"""Whole source trees of the PyTorch port against each other, in turns:
the wall time of the flagship and matpreview frames (one CUDA GPU).

    python3 scripts/time_torch_trees.py TREE [TREE ...] [--rounds 5]

A TREE is a checkout of the repository: "." for this one, or a parent
commit unpacked into the ignored build/ (`mkdir -p build/parent && git
archive HEAD | tar -x -C build/parent`). Each tree gets a worker process
that imports the package from that tree (its Python code and its kernels,
built by its own ops/build.py), loads both scenes (flagship_dict(512, 64,
4); matpreview_dict(512, 8, 8) with the schedule of probe_compact_schedule)
and renders each once as a warm-up. Then, for --rounds rounds, each frame
is rendered once by every worker in turn, the order reversed every other
round (A B B A ...), so that the host's drift falls on every tree alike;
the workers hold the card in turn, never at once. Printed: each warm-up
image's sum (the trees render the same image where they agree), the
kernel count and device time of one profiled render of each frame, each
tree's times and median per frame, each median over the first tree's,
and the rounds in which each tree was the faster.
Needs a CUDA GPU; imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

FRAMES = ("flagship", "matpreview")


def worker():
    """Serve render requests on stdin, one JSON line out per line in."""
    sys.path.insert(0, os.getcwd())
    import torch

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import (
        flagship_dict,
        matpreview_dict,
        probe_compact_schedule,
    )

    scenes = {
        "flagship": (mt.load_dict(flagship_dict(512, 64, 4), "cuda"), 64),
        "matpreview": (probe_compact_schedule(
            mt.load_dict(matpreview_dict(512, 8, 8), "cuda"), spp=4)[0], 8),
    }
    sums, work = {}, {}
    for name, (scene, spp) in scenes.items():
        sums[name] = float(mt.render(scene, spp=spp, seed=0).double().sum())
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mt.render(scene, spp=spp, seed=0)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        work[name] = (len(kernels), sum(e.device_time for e in kernels) / 1e3)
    print(json.dumps({"ready": os.getcwd(), "sums": sums, "work": work}), flush=True)
    for line in sys.stdin:
        name = line.strip()
        if name == "quit":
            break
        scene, spp = scenes[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mt.render(scene, spp=spp, seed=0)
        torch.cuda.synchronize()
        print(json.dumps({"secs": time.perf_counter() - t0}), flush=True)


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
            print(f"{tree}: warm-up image sums {ready['sums']}; one profiled render "
                  f"(kernels, device ms): {ready['work']}")
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
