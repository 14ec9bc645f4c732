#!/usr/bin/env python3
"""Row-sharded rendering over the cards of one host, held to one card.

    python3 -m torch.distributed.run --nproc-per-node 4 scripts/sharded_check.py \
        [--cli-xml scene.xml --cli-image frame.npy [-D key=value ...]] \
        [--device cpu] [--res 512] [--n-sub 5] [--rounds 5]

Every rank joins a process group from the launcher's environment
(parallel/mesh.initialize_distributed: NCCL with one card a rank, or gloo
with --device cpu) and loads the scenes on its own device. For the 1-D
mesh and, on 4 ranks, the 2x2 ("dcn", "ici") layout:

- render_sharded of the matpreview frame (scenes.matpreview_dict, box
  filter, res x res, 8 spp, depth 8, no compaction) against render on the
  rank's own device: equal bit for bit;
- render_sharded of the camera frame (scenes.camera_dict: a thin lens,
  multijitter, the gaussian filter, whose halo rows cross the ranks)
  against render: within SPLAT_RTOL (the splats add by atomics on the
  card);
- loss_and_grad_sharded of the matpreview AD setup (res / 2, 4 spp, depth
  6, the 10 tables and the floor's alpha, no compaction) against
  ad.grad_render: losses within LOSS_RTOL, gradient cosines >= GRAD_COS,
  one table-gradient buffer on each rank.

Timed (median of --rounds runs, each ended by a synchronise and a
barrier): the sharded frame and AD step, and the one-device render and
grad_render on rank 0 while the others wait. With --cli-image, the image
the command line wrote under --sharded must equal render(load_file(
--cli-xml, **defines)) on one device, bit for bit. Rank 0 prints one line a check and
a JSON line of the numbers; any failure exits non-zero. Imports nothing of
JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

SPLAT_RTOL, SPLAT_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-5
GRAD_COS = 0.9999
AD_KEYS = ("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u",
           "bsdf.roughconductor.alpha_v")


def _sync(every_rank):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if every_rank:
        dist.barrier()


def _median_s(fn, rounds, every_rank=True):
    """Median seconds of `rounds` runs of fn, each ended by a synchronise
    (and a barrier of every rank)."""
    times = []
    for _ in range(rounds):
        _sync(every_rank)
        t0 = time.perf_counter()
        fn()
        _sync(every_rank)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _alone_s(fn, rounds):
    """fn timed on rank 0 while the other ranks wait (None elsewhere)."""
    out = _median_s(fn, rounds, every_rank=False) if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--n-sub", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cli-xml")
    ap.add_argument("--cli-image")
    ap.add_argument("-D", "--define", action="append", default=[],
                    help="the -D key=value the command line was given")
    args = ap.parse_args()

    import numpy as np

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import merl_sorted
    from mitsuba_customization_tpu_torch.parallel import mesh as pm
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.scenes import camera_dict, matpreview_dict

    pm.initialize_distributed(device=args.device, timeout=600)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(f"cuda:{torch.cuda.current_device()}" if args.device == "cuda"
                       else args.device)
    lines, report, failed = [], {"world": world}, []
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip() if args.device == "cuda" else "cpu"
        print(f"cards: {card}; world {world} ({dist.get_backend()})", flush=True)

    res = args.res
    frames = {"matpreview": (mt.load_dict(matpreview_dict(res, 8, 8, n_sub=args.n_sub), dev), 8),
              "camera": (mt.load_dict(camera_dict(res, 8, 8, n_sub=args.n_sub), dev), 8)}
    meshes = {"1-D": pm.make_mesh()}
    if world == 4:
        meshes["2x2 (dcn, ici)"] = pm.make_mesh_2level(n_hosts=2)
    for name, (scene, spp) in frames.items():
        want = mt.render(scene, spp, 1)
        one_s = _alone_s(lambda: mt.render(scene, spp, 1), args.rounds)
        for layout, mesh in meshes.items():
            got = pm.render_sharded(scene, mesh, spp, 1)
            diff = (got - want).abs().max().item()
            ok = (torch.equal(got, want) if scene.config.rfilter == "box" else
                  bool(torch.allclose(got, want, rtol=SPLAT_RTOL, atol=SPLAT_ATOL)))
            secs = _median_s(lambda: pm.render_sharded(scene, mesh, spp, 1), args.rounds)
            oks = [None] * world
            dist.all_gather_object(oks, ok)
            report[f"{name} {layout}"] = dict(sharded_s=secs, one_device_s=one_s,
                                              max_abs_diff=diff, equal_on_every_rank=all(oks))
            lines.append(f"{name} {res}x{res} {spp}spp ({scene.config.rfilter}) on {layout}: "
                         f"sharded {secs:.4f} s, one device {one_s} s; every rank's image "
                         f"{'equal' if scene.config.rfilter == 'box' else 'close'}: "
                         f"{all(oks)} (rank 0's largest difference {diff:.3e})")
            if not all(oks):
                failed.append(f"{name} {layout}")
        del scene, want

    ad_res = res // 2
    ad_scene = mt.load_dict(matpreview_dict(ad_res, 4, 6, n_sub=args.n_sub), dev)
    full = mt.traverse(ad_scene)
    params = {k: full[k] for k in AD_KEYS}
    target = torch.zeros((ad_res, ad_res, 3), device=dev)
    loss1, grads1 = ad.grad_render(ad_scene, params, target, spp=4, seed=2)
    one_s = _alone_s(lambda: ad.grad_render(ad_scene, params, target, spp=4, seed=2),
                     args.rounds)
    for layout, mesh in meshes.items():
        merl_sorted.GRAD_BUFFERS = 0
        loss, grads = pm.loss_and_grad_sharded(ad_scene, params, target, mesh, 4, 2)
        buffers = merl_sorted.GRAD_BUFFERS
        lrel = abs(float(loss) - float(loss1)) / abs(float(loss1))
        cos = {k: float(torch.nn.functional.cosine_similarity(
            grads[k].flatten().double(), grads1[k].flatten().double(), dim=0)) for k in grads}
        secs = _median_s(lambda: pm.loss_and_grad_sharded(ad_scene, params, target, mesh, 4, 2),
                         args.rounds)
        ok = lrel <= LOSS_RTOL and min(cos.values()) >= GRAD_COS and buffers == 1
        oks = [None] * world
        dist.all_gather_object(oks, ok)
        report[f"ad {layout}"] = dict(sharded_s=secs, one_device_s=one_s, loss_rel=lrel,
                                      cos=cos, buffers=buffers, ok_on_every_rank=all(oks))
        lines.append(f"AD step {ad_res}x{ad_res} 4spp depth 6 on {layout}: sharded {secs:.4f} s, "
                     f"one device {one_s} s; loss rel diff {lrel:.2e} (limit {LOSS_RTOL}), "
                     f"cosines {cos} (limit {GRAD_COS}), buffers {buffers}; every rank ok: "
                     f"{all(oks)}")
        if not all(oks):
            failed.append(f"ad {layout}")

    if args.cli_image and rank == 0:
        from mitsuba_customization_tpu_torch.render import xml as xml_mod

        got = torch.as_tensor(np.load(args.cli_image))
        scene = xml_mod.load_file(args.cli_xml, device=dev,
                                  **dict(d.split("=", 1) for d in args.define))
        want = mt.render(scene, None, 1).cpu()
        ok = torch.equal(got, want)
        report["cli"] = dict(equal=ok, max_abs_diff=(got - want).abs().max().item())
        lines.append(f"the CLI's --sharded image ({args.cli_image}) against render(load_file): "
                     f"equal {ok}, largest difference {report['cli']['max_abs_diff']:.3e}")
        if not ok:
            failed.append("cli")
    dist.barrier()
    if rank == 0:
        print("\n".join(lines))
        print(json.dumps(report))
    dist.destroy_process_group()
    if failed:
        raise SystemExit(f"rank {rank}: failed {failed}")


if __name__ == "__main__":
    main()
