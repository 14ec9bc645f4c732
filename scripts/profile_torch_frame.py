#!/usr/bin/env python3
"""Where the time of one frame goes, for the PyTorch port on a GPU.

    python3 scripts/profile_torch_frame.py
        [--scene flagship|matpreview|materials|blend|image|emitters|camera|
                 shapes|shapes_sdf|big_shapes|volpath|ptracer|bdpt]
        [--res N] [--spp N] [--depth N] [--reps 3] [--top 20]
        [--against TREE ...]
    python3 scripts/profile_torch_frame.py --ad [--scene image|volpath] [--res 256]
        [--spp 4] [--depth 6] [--reps 3] [--top 20]

--scene flagship (default: 512x512, 64 spp, depth 4) or matpreview
(default: 512x512, 8 spp, depth 8, with the compaction schedule of
scenes.probe_compact_schedule at 4 spp), or chip_smoke.py's materials
frame (matpreview_dict with n_materials=12 and chip_smoke.material_bands;
512x512, 8 spp, depth 8) or blend frame (its null, mask and blendbsdf
bands; 256x256, 4 spp, depth 6), both with the probed schedule, or its
image frame (chip_smoke.image_bands: textures, normal and bump maps read
from EXR and PFM files it writes under build/, an envmap and a spot;
512x512, 8 spp, depth 8, the probed schedule) or emitters frame
(chip_smoke.emitters_dict: point, spot, directional, directionalarea
and projector; 512x512, 16 spp, depth 4), or its camera frame
(scenes.camera_dict: thin lens, multijitter, gaussian filter; 512x512, 8
spp, depth 8) or shapes frame (scenes.shapes_dict on the meshes
scenes.shape_files writes under build/profile_shapes: about 532,500 prims
from PLY, OBJ and serialized files, a shapegroup, a cube, a disk,
cylinders and a sphere; 512x512, 8 spp, depth 8), or shapes_sdf (a 128^3
SDF sphere in place of the largest mesh), or big_shapes (chip_smoke's
phase-32 scene: the shapes frame with a 1,310,720-triangle PLY, about
1.52M prims, past clusters.MAX_PRIMS, traced on the skip-link BVH; its
files under build/chip_smoke_big_shapes), all with the probed schedule;
or the volpath frame (scenes.volpath_dict: the matpreview scene with a
homogeneous fog ball and a heterogeneous smoke cube of a 256^3 density
grid, the volumetric tracer, no compaction; 512x512, 8 spp, depth 8), or
the matpreview scene under ptracer (without its sky) or bdpt (512x512, 8
spp, depth 8). For the volpath frame the tracking loops are printed (each
loop's lanes, steps and host checks) with the device time between the
first and last kernels of each medium.sample_interaction and
medium.transmittance call; for ptracer and bdpt the splats'. For a splat filter the device time of the film's splats is printed (CUDA
events around each film.splat call), and for an SDF scene the marches,
their steps and their device time (events around each sdf.intersect).
Prints the card's name and power limit; the frame's wall time and
rays/s with the profiler off (median of --reps renders after one warm-up);
then one render under torch.profiler: device time by kernel group and by
kernel name, the launches of K1-K4, the number of kernels launched, the
summed device time and its share of the profiled wall time (the device's
busy share; kernels run on one stream). Needs a CUDA GPU; imports nothing
of JAX.

--ad profiles one AD step in place of a frame: grad_render's eager step,
render/ad._eager_loss_and_grad (MSE against a zero image; a captured
step's replay, chip_smoke.py phase 34, launches the same kernels) of the
matpreview scene at --res 256, --spp 4, --depth 6 with the probed compaction schedule, on the 10-table stack and
the floor's alpha (chip_smoke.ad_setup, phase 13); the launches of K1's
backward are printed too, and the operators on tensors of the table's
shape (recorded with their input shapes): each one's calls and the device
time of the kernels it launched (a nested operator, such as zero_ under
zeros, repeats its children's time), so the zeroing and summing of
table-sized gradients shows. With --scene image the AD step is
chip_smoke's phase 22 instead: the image frame at those sizes with its
probed schedule, on the table stack, the texture images and the envmap's
image; with --scene volpath chip_smoke's phase 27: the volpath scene on
the table stack and the medium keys (medium.sigma_t, albedo, phase_g,
density), the operators on tensors of the density grid's shape listed
too, with the grid-sized gradient buffers (medium.GRID_BUFFERS).

--against TREE [TREE ...] builds the kernels of other source trees too,
each with that tree's own ops/build.py, for example a parent commit's
unpacked into an ignored directory (`git archive HEAD | tar -x -C
build/parent`, then `--against build/parent`), and before the profile
compares them with this tree's, in turns (the others, this, this, the
others in reverse). K3 and K4 run through this tree's wrappers on each
tree's library (their C interfaces must match). K1 and K2 run through
each tree's own wrapper modules (its ops/merl_sorted.py and
ops/marginal_sorted.py, loaded from its path, with their `build` set to
that tree's builder), so their C interfaces may differ; their Python
signatures must be this tree's (a tree whose wrapper differs gets an
adapter in its own copy). Printed: each kernel on every call that one
render hands it (recorded as chip_smoke.record_wavefronts does; CUDA
events, median of 5 each, the mean of a tree's two turns; the events hold
the wrapper's own casts and output kernels too) and summed over the
frame; the device time of each K1-K4 launch inside one profiled render
(the kernel alone, mean of the two turns); and the frame's wall time
(median of --reps renders each). Every tree's outputs are checked against
this tree's on every call: K3 and K4 equal, K1 within chip_smoke's K1
tolerances, K2 with the sampled cell equal and the values within its K2
tolerances (lanes not bit-equal are counted). K3 and K4 are compared only
where the scene has clusters (matpreview).
"""

import argparse
import collections
import contextlib
import importlib.util
import os
import statistics
import subprocess
import sys
import time
import types
import typing

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel-name substring -> group, first match wins
GROUPS = (
    ("merl_eval_bwd", "K1-bwd merl_eval_bwd (CUDA)"),
    ("merl_eval", "K1 merl_eval (CUDA)"),
    ("cond_sample", "K2 cond_sample (CUDA)"),
    ("cluster_closest", "K3 cluster_closest (CUDA)"),
    ("cluster_shadow", "K4 cluster_shadow (CUDA)"),
    ("bvh_closest", "B1 bvh_closest (CUDA)"),
    ("bvh_any", "B2 bvh_any (CUDA)"),
    ("medium_delta_track", "T1 medium_delta_track (CUDA)"),
    ("medium_ratio_track", "T2 medium_ratio_track (CUDA)"),
    ("sdf_march", "S1 sdf_march (CUDA)"),
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


def _load(tree, name, i):
    """Module ops/<name>.py of another source tree, loaded from its path
    (its imports of the package resolve to this tree's)."""
    path = os.path.join(tree, "mitsuba_customization_tpu_torch", "ops", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_other_{name}_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Tree(typing.NamedTuple):
    """One source tree's kernels: its builder (an ops/build module) and its
    K1 and K2 wrapper modules."""

    builder: types.ModuleType
    k1: types.ModuleType
    k2: types.ModuleType


def _other_tree(tree, i):
    """Another source tree's kernels, with its library built."""
    builder = _load(tree, "build", i)
    builder.library()
    k1, k2 = _load(tree, "merl_sorted", i), _load(tree, "marginal_sorted", i)
    k1.build = k2.build = builder
    return Tree(builder, k1, k2)


@contextlib.contextmanager
def _kernels(tree):
    """Run the frame (and the K3 and K4 wrappers) on `tree`'s kernels
    inside the block."""
    from mitsuba_customization_tpu_torch.models import tabulated as tab
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    saved = cl.kbuild, tab.merl_sorted, tab.marginal_sorted
    cl.kbuild, tab.merl_sorted, tab.marginal_sorted = tree.builder, tree.k1, tree.k2
    try:
        yield
    finally:
        cl.kbuild, tab.merl_sorted, tab.marginal_sorted = saved


KERNEL_NAMES = (("K1", "merl_eval"), ("K2", "cond_sample"),
                ("K3", "cluster_closest"), ("K4", "cluster_shadow"))


def _launch_times(fn):
    """Device ms of each K1-K4 launch of fn(), in launch order, from one
    run under torch.profiler: {"K1": [...], ..., "K4": [...]}."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return {key: [e.device_time / 1e3 for e in kernels if name in e.name]
            for key, name in KERNEL_NAMES}


def _in_turns(names, turns, trees, fn):
    """{name: mean of fn()'s CUDA-event ms over that tree's two turns}."""
    from chip_smoke import _time_ms

    ms = {name: [] for name in names}
    for name in turns:
        with _kernels(trees[name]):
            ms[name].append(_time_ms(fn(trees[name])))
    return {name: statistics.mean(ms[name]) for name in names}


def _print_calls(key, rows, names):
    """rows: [(description, {name: ms}, agreement)] per call."""
    total = dict.fromkeys(names, 0.0)
    for b, (what, ms, agree) in enumerate(rows):
        for name in names:
            total[name] += ms[name]
        print(f"{key} call {b}: {what}; ms: "
              + ", ".join(f"{name} {ms[name]:.4f}" for name in names) + f" ({agree})")
    print(f"{key} summed over the frame's {len(rows)} calls, ms: "
          + ", ".join(f"{name} {total[name]:.4f}" for name in names))


def compare(scene, spp, reps, other_trees):
    """K1-K4 per recorded call and the frame, this tree's kernels against
    those of each of `other_trees`, in turns: every other, this, this,
    every other in reverse (each time the mean of the two)."""
    import mitsuba_customization_tpu_torch as mt
    from chip_smoke import (K1_ATOL, K1_RTOL, _check_close, check_k2,
                            record_wavefronts)
    from mitsuba_customization_tpu_torch.ops import build
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    trees = {os.path.relpath(t): _other_tree(t, i) for i, t in enumerate(other_trees)}
    trees["this"] = Tree(build, k1, k2)
    names = list(trees)
    turns = names + names[::-1]
    cs = scene.clusters
    rec = record_wavefronts(scene, spp, seed=1)
    for key, fn in (("K3", cl.intersect), ("K4", cl.occluded)):
        if cs is None:
            break
        rows = []
        for r in rec[key]:
            with _kernels(trees["this"]):
                want = fn(cs, r)
            for name in names:
                with _kernels(trees[name]):
                    got = fn(cs, r)
                same = all(torch.equal(x, y) for x, y in zip(got[:4], want[:4])) \
                    if key == "K3" else torch.equal(got, want)
                if not same:
                    raise AssertionError(f"{key}: {name} disagrees with this tree's kernel")
            ms = _in_turns(names, turns, trees, lambda t: lambda: fn(cs, r))
            rows.append((f"{r.o.shape[0]} lanes, {int((r.maxt > 0).sum())} live",
                         ms, "outputs equal"))
        _print_calls(key, rows, names)
    rows = []
    for args in rec["K1"]:
        want = k1.eval_trilinear(*args)
        for name in names:
            _check_close(f"K1 {name}", trees[name].k1.eval_trilinear(*args), want,
                         K1_RTOL, K1_ATOL)
        lanes = k1.concat_halves(*args[1:])
        live = lanes[0].shape[0] if lanes[3] is None else int(lanes[3].sum())
        ms = _in_turns(names, turns, trees, lambda t: lambda: t.k1.eval_trilinear(*args))
        rows.append((f"{lanes[0].shape[0]} lanes, {live} live", ms,
                     f"within rtol {K1_RTOL} atol {K1_ATOL}"))
    _print_calls("K1", rows, names)
    rows = []
    for args in rec["K2"]:
        want = k2.cond_sample_pdf(*args)
        off = {name: check_k2(trees[name].k2.cond_sample_pdf(*args), want,
                              args[0].shape[-1])[1]
               for name in names}
        ms = _in_turns(names, turns, trees, lambda t: lambda: t.k2.cond_sample_pdf(*args))
        rows.append((f"{args[-1].shape[0]} lanes, {int(args[-1].sum())} live", ms,
                     "cells equal; lanes not bit-equal to this tree's: "
                     + ", ".join(f"{name} {n}" for name, n in off.items())))
    _print_calls("K2", rows, names)
    del rec
    # the same launches inside the frame, kernel time only (the events
    # above also hold the wrappers' own kernels and launch gaps)
    in_frame = {name: [] for name in names}
    for name in turns:
        with _kernels(trees[name]):
            in_frame[name].append(_launch_times(lambda: mt.render(scene, spp=spp, seed=0)))
    for key, _ in KERNEL_NAMES:
        for name in names:
            per = [statistics.mean(x) for x in zip(*(run[key] for run in in_frame[name]))]
            if per:
                print(f"{key} in-frame kernel ms per launch (profiler, mean of "
                      f"{len(in_frame[name])}), {name}: {', '.join(f'{x:.4f}' for x in per)}; "
                      f"sum {sum(per):.4f}")
    for name in turns:
        with _kernels(trees[name]):
            secs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                mt.render(scene, spp=spp, seed=0)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        print(f"frame with the {name} kernels: median {statistics.median(secs):.4f} s "
              f"of {reps} ({', '.join(f'{x:.4f}' for x in secs)})")


@contextlib.contextmanager
def _timed_calls(mod, name, events):
    """Wrap mod.name for the block: each call is bracketed by CUDA events
    (start, end), appended to `events`."""
    orig = getattr(mod, name)

    def wrapper(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(mod, name, wrapper)
    try:
        yield
    finally:
        torch.cuda.synchronize()
        setattr(mod, name, orig)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("flagship", "matpreview", "materials", "blend",
                                        "image", "emitters", "camera", "shapes", "shapes_sdf",
                                        "big_shapes", "volpath", "ptracer", "bdpt"),
                    default="flagship")
    ap.add_argument("--ad", action="store_true")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--against", nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: CUDA is not available")
    if args.ad and args.against:
        raise SystemExit("profile_torch_frame: --against compares frames, not AD steps")
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

    if args.ad:
        from chip_smoke import IMAGE_AD_KEYS, IMAGE_DIR, ad_setup, image_bands, image_files
        from mitsuba_customization_tpu_torch.render import ad
        from mitsuba_customization_tpu_torch.render.params import traverse

        args.res, args.spp, args.depth = args.res or 256, args.spp or 4, args.depth or 6
        if args.scene == "volpath":
            from chip_smoke import AD_KEYS, MEDIUM_KEYS, VOLPATH_GRID, VOLPATH_SEED

            scene = mt.load_dict(scenes.volpath_dict(args.res, args.spp, args.depth,
                                                     VOLPATH_GRID, VOLPATH_SEED), "cuda")
            full = traverse(scene)
            params = {k: full[k] for k in (AD_KEYS[0],) + MEDIUM_KEYS}
            fracs = None
        elif args.scene == "image":
            scene = mt.load_dict(image_bands(scenes.matpreview_dict(
                args.res, args.spp, args.depth, n_materials=12), image_files(IMAGE_DIR)),
                "cuda")
            scene, fracs = scenes.probe_compact_schedule(scene, spp=4)
            full = traverse(scene)
            params = {k: full[k] for k in IMAGE_AD_KEYS}
        else:
            scene, fracs, params = ad_setup("cuda", args.res, args.spp, args.depth)
        target = torch.zeros((args.res, args.res, 3), device="cuda")
        print(f"compaction schedule {fracs}")
    elif args.scene == "flagship":
        args.res = args.res or 512
        args.spp = args.spp or 64
        args.depth = args.depth or 4
        scene = mt.load_dict(
            scenes.flagship_dict(args.res, args.spp, args.depth), "cuda")
    elif args.scene == "emitters":
        from chip_smoke import emitters_dict

        args.res, args.spp, args.depth = args.res or 512, args.spp or 16, args.depth or 4
        scene = mt.load_dict(emitters_dict(args.res, args.spp, args.depth), "cuda")
    elif args.scene in ("volpath", "ptracer", "bdpt"):
        from chip_smoke import VOLPATH_GRID, VOLPATH_SEED

        args.res, args.spp, args.depth = args.res or 512, args.spp or 8, args.depth or 8
        if args.scene == "volpath":
            d = scenes.volpath_dict(args.res, args.spp, args.depth, VOLPATH_GRID, VOLPATH_SEED)
        else:
            d = scenes.matpreview_dict(args.res, args.spp, args.depth)
            d["integrator"] = {"type": args.scene, "max_depth": args.depth}
            if args.scene == "ptracer":
                del d["sky"]
        scene = mt.load_dict(d, "cuda")
        print(f"{scene.geometry.p0.shape[0]} prims, {scene.media.n_media} media")
    elif args.scene in ("camera", "shapes", "shapes_sdf", "big_shapes"):
        args.res, args.spp, args.depth = args.res or 512, args.spp or 8, args.depth or 8
        if args.scene == "camera":
            d = scenes.camera_dict(args.res, args.spp, args.depth)
        elif args.scene == "big_shapes":
            from chip_smoke import BIG_N_SUB, BIG_SHAPES_DIR, SHAPES_SEED

            d = scenes.shapes_dict(scenes.shape_files(BIG_SHAPES_DIR, SHAPES_SEED, BIG_N_SUB),
                                   args.res, args.spp, args.depth)
        else:
            root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "build", "profile_shapes")
            d = scenes.shapes_dict(scenes.shape_files(root), args.res, args.spp, args.depth,
                                   sdf_res=128 if args.scene == "shapes_sdf" else None)
        scene = mt.load_dict(d, "cuda")
        scene, fracs = scenes.probe_compact_schedule(scene, spp=4)
        print(f"compaction schedule {fracs}; {scene.geometry.p0.shape[0]} prims")
    else:
        blend = args.scene == "blend"
        args.res = args.res or (256 if blend else 512)
        args.spp = args.spp or (4 if blend else 8)
        args.depth = args.depth or (6 if blend else 8)
        if args.scene == "matpreview":
            d = scenes.matpreview_dict(args.res, args.spp, args.depth)
        elif args.scene == "image":
            from chip_smoke import IMAGE_DIR, image_bands, image_files

            d = image_bands(scenes.matpreview_dict(
                args.res, args.spp, args.depth, n_materials=12), image_files(IMAGE_DIR))
        else:
            from chip_smoke import material_bands

            d = material_bands(scenes.matpreview_dict(
                args.res, args.spp, args.depth, n_materials=12), blend=blend)
        scene = mt.load_dict(d, "cuda")
        scene, fracs = scenes.probe_compact_schedule(scene, spp=4)
        print(f"compaction schedule {fracs}")

    def frame():
        if args.ad:
            ad._eager_loss_and_grad(scene, params, target, args.spp, 0)
            torch.cuda.synchronize()
            return 0.0
        img, stats = mt.render(scene, spp=args.spp, seed=0, return_stats=True)
        torch.cuda.synchronize()
        return stats["rays_traced"]

    frame()  # warm-up: kernel build, allocator, lazy init
    if args.against and scene.clusters is None:
        ap.error("--against compares K1-K4: the scene must have a cluster set")
    if args.against:
        compare(scene, args.spp, args.reps, args.against)
    secs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        rays = frame()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    what = (f"AD step ({args.scene if args.scene in ('image', 'volpath') else 'matpreview'})"
            if args.ad else f"{args.scene} frame")
    print(f"{what} {args.res}x{args.res} {args.spp}spp depth {args.depth}: "
          f"median {med:.4f} s of {args.reps} ({', '.join(f'{s:.4f}' for s in secs)})"
          + ("" if args.ad else f", {rays:.0f} rays, {rays / med / 1e6:.2f} Mrays/s"))

    from mitsuba_customization_tpu_torch.render import bvh, film, medium, sdf

    k1.LAUNCHES = k1.LAUNCHES_BWD = k2.LAUNCHES = 0
    cl.LAUNCHES["closest"] = cl.LAUNCHES["shadow"] = 0
    bvh.LAUNCHES["closest"] = bvh.LAUNCHES["any"] = 0
    sdf.LAUNCHES = 0
    sdf.MARCHES = []
    medium.LAUNCHES["delta"] = medium.LAUNCHES["ratio"] = 0
    medium.LOOPS = []
    medium.GRID_BUFFERS = 0
    spans = {"film.splat": [], "sdf.intersect": [], "medium.sample_interaction": [],
             "medium.transmittance": []}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with _timed_calls(film, "splat", spans["film.splat"]), \
            _timed_calls(sdf, "intersect", spans["sdf.intersect"]), \
            _timed_calls(medium, "sample_interaction", spans["medium.sample_interaction"]), \
            _timed_calls(medium, "transmittance", spans["medium.transmittance"]), \
            torch.profiler.profile(activities=acts, record_shapes=args.ad) as prof:
        t0 = time.perf_counter()
        frame()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time for e in kernels)
    print(f"profiled {'AD step' if args.ad else 'frame'}: wall {wall:.4f} s, "
          f"{len(kernels)} kernels, device "
          f"{dev_us / 1e6:.4f} s, busy share {dev_us / 1e6 / wall:.3f}; "
          f"launches K1 {k1.LAUNCHES} K2 {k2.LAUNCHES} "
          f"K3 {cl.LAUNCHES['closest']} K4 {cl.LAUNCHES['shadow']} "
          f"B1 {bvh.LAUNCHES['closest']} B2 {bvh.LAUNCHES['any']} "
          f"T1 {medium.LAUNCHES['delta']} T2 {medium.LAUNCHES['ratio']} S1 {sdf.LAUNCHES} "
          f"K1-bwd {k1.LAUNCHES_BWD}")
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
    for name, evs in spans.items():
        if evs:
            ms = sum(a.elapsed_time(b) for a, b in evs)
            extra = (f", {sum(int(st.max()) for st, _ in sdf.MARCHES)} lock-step steps, "
                     f"{sum(int(st.sum()) for st, _ in sdf.MARCHES)} lane steps, "
                     f"{sum(c for _, c in sdf.MARCHES)} host checks"
                     if name == "sdf.intersect" else "")
            print(f"  {name}: {len(evs)} calls{extra}, {ms:.2f} ms between their first and "
                  f"last kernels (CUDA events, profiler on)")
    if medium.LOOPS:
        steps = sum(int(x[2].max()) for x in medium.LOOPS)
        checks = sum(x[3] for x in medium.LOOPS)
        print(f"  tracking loops: {len(medium.LOOPS)}, {steps} steps of the slowest lanes, "
              f"{checks} host checks: " + "; ".join(
                  f"{kind} {int((n > 0).sum())} of {lanes} lanes, {int(n.max())} steps at most, "
                  f"{int(n.sum())} in all, {c} checks" for kind, lanes, n, c in medium.LOOPS))
    if args.ad:
        shapes = [list(params["bsdf.tabulated.table"].shape)]
        if "medium.density" in params:
            shapes.append([params["medium.density"].numel()])
            print(f"grid-sized gradient buffers: {medium.GRID_BUFFERS}")
        for shape in shapes:
            print(f"operators on {shape} tensors (calls, device ms of their kernels):")
            for e in prof.key_averages(group_by_input_shape=True):
                if any(list(s) == shape for s in e.input_shapes):
                    print(f"  {e.key:28s} {e.count:4d}x  {e.device_time_total / 1e3:8.3f} ms")


if __name__ == "__main__":
    main()
