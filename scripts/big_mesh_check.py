#!/usr/bin/env python3
"""B1 / B2 (the skip-link BVH kernels) against K3 / K4 (the cluster
kernels) on the big shapes scene, past clusters.MAX_PRIMS, on one GPU.

    python3 scripts/big_mesh_check.py [--n-sub 8 6 5] [--res 512] [--spp 8]
        [--reps 5] [--max-build-s 60] [--device cuda]

Loads chip_smoke.py's phase-32 scene (scenes.shapes_dict on
scenes.shape_files(n_sub=(8, 6, 5)) from chip_smoke.SHAPES_SEED, about
1.52M prims) on the card: the loader puts it on the BVH, as it must past
the cap. Then builds the cluster set for the same geometry with
ops/clusters.build (the loader's MAX_PRIMS is not consulted here; the
cluster kernels keep the root and supercluster boxes in shared memory,
32 B a supercluster, within the 227 KB a block may take) and prints its
host seconds; past --max-build-s it stops there. Otherwise, on the camera
wavefront (res x res x spp lanes) it times B1 and K3 in turns (B1, K3,
K3, B1, each the median of --reps CUDA-event runs after a warm-up), and
on NEE shadow rays from B1's hits B2 and K4 the same way, each beside its
bound (chip_smoke.bvh_bound from render/bvh.walk_work, chip_smoke.k3_bound
/ k4_bound from ops/clusters.min_work), and how far the two kernels'
hits agree. Prints the card's name and power limit and, last, one JSON
line of the numbers. Needs a CUDA GPU; imports nothing of JAX.
`--device cpu` rehearses the control flow on the CPU at a small --n-sub
(CUDA events and syncs stubbed by the caller; its times are the CPU's).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-sub", type=int, nargs=3, default=None)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-build-s", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("big_mesh_check: CUDA is not available")
    import chip_smoke as cs
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import build as kbuild
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.render import bvh
    from mitsuba_customization_tpu_torch.render import geometry as geo
    from mitsuba_customization_tpu_torch.scenes import shape_files, shapes_dict

    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        kbuild.library()
    print(f"card: {card}")
    n_sub = tuple(args.n_sub) if args.n_sub else cs.BIG_N_SUB
    paths = shape_files(cs.BIG_SHAPES_DIR, cs.SHAPES_SEED, n_sub)
    t0 = time.perf_counter()
    scene = mt.load_dict(shapes_dict(paths, args.res, args.spp, 8), dev)
    torch.cuda.synchronize()
    out = {"card": card, "prims": scene.geometry.p0.shape[0], "nodes": scene.bvh.n_nodes,
           "load_s": time.perf_counter() - t0, "intersector": scene.config.intersector}
    t0 = time.perf_counter()
    g_np = geo.Geometry(*(f.cpu().numpy() for f in scene.geometry))
    arrays = cl.build_arrays(g_np)
    out["cluster_build_s"] = time.perf_counter() - t0
    out["clusters"] = arrays[1].shape[0]
    out["superclusters"] = arrays[0].shape[0]
    out["sc_smem_kb"] = (8 + 8 * arrays[0].shape[0]) * 4 / 1024
    print(f"{out['prims']} prims, {out['nodes']} BVH nodes, loaded in {out['load_s']:.1f} s; "
          f"host cluster build {out['cluster_build_s']:.1f} s: {out['clusters']} clusters, "
          f"{out['superclusters']} superclusters ({out['sc_smem_kb']:.1f} KB of boxes in "
          "shared memory)")
    if out["cluster_build_s"] > args.max_build_s:
        print(f"the host cluster build took over {args.max_build_s} s: stopping here")
        print(json.dumps(out))
        return
    cset = cl.cluster_set(*arrays, dev)
    del arrays, g_np
    tree, g, cyl = scene.bvh, scene.geometry, scene.has_cylinders

    def turns(fa, fb):
        """(a ms, b ms): medians of --reps runs, timed in turns a, b, b, a."""
        a1 = cs._time_ms(fa, args.reps)
        b1 = cs._time_ms(fb, args.reps)
        b2 = cs._time_ms(fb, args.reps)
        a2 = cs._time_ms(fa, args.reps)
        return (a1 + a2) / 2, (b1 + b2) / 2

    ray = cs.camera_wavefront(scene, args.spp)
    t, prim, u, v = bvh.intersect(tree, g, ray, cyl)
    t3, prim3, _, _, _ = cl.intersect(cset, ray)
    torch.cuda.synchronize()
    hit = prim >= 0
    out["camera_lanes"] = ray.o.shape[0]
    out["camera_hit_agree"] = float((hit == (prim3 >= 0)).float().mean())
    out["camera_prim_agree"] = float((prim == prim3)[hit].float().mean())
    out["b1_ms"], out["k3_ms"] = turns(lambda: bvh.intersect(tree, g, ray, cyl),
                                       lambda: cl.intersect(cset, ray))
    _, work = bvh.walk_work(tree, g, ray, cyl)
    out["b1_bound_ms"], out["b1_bound_by"] = cs.bvh_bound(ray, work, cs.B1_OUT_BYTES)
    out["b1_visits_mean"] = float(work.visits.float().mean())
    out["b1_visits_max"] = int(work.visits.max())
    out["k3_bound_ms"], out["k3_bound_by"] = cs.k3_bound(cset, ray, t3, prim3)
    print(f"camera wavefront, {out['camera_lanes']} rays: B1 {out['b1_ms']:.3f} ms (bound "
          f"{out['b1_bound_ms']:.4f}, {out['b1_bound_by']}; node visits "
          f"{out['b1_visits_mean']:.1f} a lane, max {out['b1_visits_max']}), K3 "
          f"{out['k3_ms']:.3f} ms (bound {out['k3_bound_ms']:.4f}, {out['k3_bound_by']}); "
          f"hit/miss agree on {out['camera_hit_agree']:.6f}, prims on "
          f"{out['camera_prim_agree']:.6f} of B1's hits")

    shadow = cs.nee_shadow_rays(scene, geo.compute_interaction(g, ray, t, prim, u, v, cyl))
    occ = bvh.occluded(tree, g, shadow, cyl)
    occ4 = cl.occluded(cset, shadow)
    torch.cuda.synchronize()
    out["nee_occ_agree"] = float((occ == occ4).float().mean())
    out["b2_ms"], out["k4_ms"] = turns(lambda: bvh.occluded(tree, g, shadow, cyl),
                                       lambda: cl.occluded(cset, shadow))
    _, work = bvh.walk_work(tree, g, shadow, cyl, any_hit=True)
    out["b2_bound_ms"], out["b2_bound_by"] = cs.bvh_bound(shadow, work, cs.B2_OUT_BYTES)
    out["k4_bound_ms"], out["k4_bound_by"] = cs.k4_bound(cset, shadow, occ4)
    print(f"NEE shadow rays: B2 {out['b2_ms']:.3f} ms (bound {out['b2_bound_ms']:.4f}, "
          f"{out['b2_bound_by']}), K4 {out['k4_ms']:.3f} ms (bound {out['k4_bound_ms']:.4f}, "
          f"{out['k4_bound_by']}); occlusion agrees on {out['nee_occ_agree']:.6f}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
