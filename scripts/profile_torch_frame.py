#!/usr/bin/env python3
"""Where the time of one frame goes, for the PyTorch port on a GPU.

    python3 scripts/profile_torch_frame.py [--scene flagship|matpreview]
        [--res 512] [--spp N] [--depth N] [--reps 3] [--top 20]

--scene flagship (default: 64 spp, depth 4) or matpreview (default: 8 spp,
depth 8, with the compaction schedule of scenes.probe_compact_schedule at
4 spp). Prints the card's name and power limit; the frame's wall time and
rays/s with the profiler off (median of --reps renders after one warm-up);
then one render under torch.profiler: device time by kernel group and by
kernel name, the launches of K1-K4, the number of kernels launched, the
summed device time and its share of the profiled wall time (the device's
busy share; kernels run on one stream). Needs a CUDA GPU; imports nothing
of JAX.
"""

import argparse
import collections
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel-name substring -> group, first match wins
GROUPS = (
    ("merl_eval", "K1 merl_eval (CUDA)"),
    ("cond_sample", "K2 cond_sample (CUDA)"),
    ("cluster_closest", "K3 cluster_closest (CUDA)"),
    ("cluster_shadow", "K4 cluster_shadow (CUDA)"),
    ("sort", "torch sort"),
    ("index", "torch gather/scatter"),
    ("gather", "torch gather/scatter"),
    ("reduce", "torch reductions"),
    ("cat", "torch cat/copy"),
    ("copy", "torch cat/copy"),
    ("elementwise", "torch elementwise"),
)


def group_of(name):
    low = name.lower()
    return next((g for key, g in GROUPS if key in low), "other")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("flagship", "matpreview"),
                    default="flagship")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch import scenes

    if args.scene == "flagship":
        args.spp = args.spp or 64
        args.depth = args.depth or 4
        scene = mt.load_dict(
            scenes.flagship_dict(args.res, args.spp, args.depth), "cuda")
    else:
        args.spp = args.spp or 8
        args.depth = args.depth or 8
        scene = mt.load_dict(
            scenes.matpreview_dict(args.res, args.spp, args.depth), "cuda")
        scene, fracs = scenes.probe_compact_schedule(scene, spp=4)
        print(f"compaction schedule {fracs}")

    def frame():
        img, stats = mt.render(scene, spp=args.spp, seed=0, return_stats=True)
        torch.cuda.synchronize()
        return stats["rays_traced"]

    frame()  # warm-up: kernel build, allocator, lazy init
    secs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        rays = frame()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    print(f"{args.scene} frame {args.res}x{args.res} {args.spp}spp depth {args.depth}: "
          f"median {med:.4f} s of {args.reps} ({', '.join(f'{s:.4f}' for s in secs)}), "
          f"{rays:.0f} rays, {rays / med / 1e6:.2f} Mrays/s")

    k1.LAUNCHES = k2.LAUNCHES = 0
    cl.LAUNCHES["closest"] = cl.LAUNCHES["shadow"] = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        frame()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time for e in kernels)
    print(f"profiled frame: wall {wall:.4f} s, {len(kernels)} kernels, device "
          f"{dev_us / 1e6:.4f} s, busy share {dev_us / 1e6 / wall:.3f}; "
          f"launches K1 {k1.LAUNCHES} K2 {k2.LAUNCHES} "
          f"K3 {cl.LAUNCHES['closest']} K4 {cl.LAUNCHES['shadow']}")
    by_group = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        by_group[group_of(e.name)] += e.device_time
        by_name[e.name[:90]] += e.device_time
        count[e.name[:90]] += 1
    for g, us in by_group.most_common():
        print(f"  group {g:28s} {us / 1e3:10.2f} ms  {us / dev_us:6.1%}")
    for name, us in by_name.most_common(args.top):
        print(f"  {us / 1e3:10.2f} ms {count[name]:6d}x  {name}")


if __name__ == "__main__":
    main()
