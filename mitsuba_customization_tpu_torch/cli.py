"""Command-line renderer: `python -m mitsuba_customization_tpu_torch.cli`.

PyTorch port of mitsuba_customization_tpu/cli.py (mitsuba3's `mitsuba`
executable): load a scene (Mitsuba XML, a JSON dict or a Python file),
render it on the card (or the device named by --device), write the image.

    mitsuba scene.xml -o out.exr -D spp=128
->  python -m mitsuba_customization_tpu_torch.cli scene.xml -o out.exr -D spp=128

-D key=value substitutes $vars in XML scenes and is passed to a Python
file's make_scene(**defines). The output is written by extension
(utils/io.write_image): .exr, .pfm and .npy float-exact, anything else an
8-bit sRGB PNG (which needs Pillow). The JAX CLI writes PNG bytes under
any extension but .npy (ROADMAP's reference faults).

--sharded renders the rows over the ranks of a process group
(parallel/mesh.render_sharded), joined from the environment that
`python -m torch.distributed.run --nproc-per-node N` sets; rank 0 writes
the image. Like the JAX CLI's, the sharded render takes the scene's own
integrator and depth.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_scene(path, defines, device):
    from mitsuba_customization_tpu_torch.render import xml as xml_mod
    from mitsuba_customization_tpu_torch.render.scene import load_dict

    if path.endswith(".xml"):
        return xml_mod.load_file(path, device=device, **defines)
    if path.endswith(".json"):
        with open(path) as f:
            return load_dict(json.load(f), device)
    if path.endswith(".py"):
        # a python file defining `scene_dict` (or `make_scene(**defines)`)
        ns: dict = {}
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), ns)
        if "make_scene" in ns:
            return load_dict(ns["make_scene"](**defines), device)
        return load_dict(ns["scene_dict"], device)
    raise ValueError(f"unsupported scene format: {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba_customization_tpu_torch",
        description="differentiable MERL path tracer on an NVIDIA GPU "
        "(PyTorch port of mitsuba_customization_tpu)",
    )
    ap.add_argument("scene", help="scene file (.xml, .json, .py)")
    ap.add_argument("-o", "--output", default="output.png",
                    help="output image (.exr, .pfm, .npy float-exact; else PNG)")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="scene variable override")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=None, help="max path depth")
    ap.add_argument("--integrator", default=None,
                    help="path | direct | depth | aov_normals | volpath | ...")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the rows over the ranks of torch.distributed.run")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    defines = {}
    for d in args.define:
        if "=" not in d:
            ap.error(f"-D expects key=value, got '{d}'")
        k, v = d.split("=", 1)
        defines[k] = v

    import torch

    from mitsuba_customization_tpu_torch.utils.io import write_image
    from mitsuba_customization_tpu_torch.utils.log import logger

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    rank, joined = 0, False
    if args.sharded:
        import torch.distributed as dist

        from mitsuba_customization_tpu_torch.parallel import mesh as mesh_mod

        joined = not dist.is_initialized()
        mesh_mod.initialize_distributed(device=args.device)
        joined = joined and dist.is_initialized()
        rank = dist.get_rank() if dist.is_initialized() else 0

    t0 = time.time()
    scene = _load_scene(args.scene, defines, args.device)
    sync()
    logger.info(
        "loaded scene: %d prims, %d materials, %d emitters (%.2fs)",
        scene.geometry.n_prims,
        scene.bsdfs.mat_type.shape[0],
        scene.emitters.n_emitters,
        time.time() - t0,
    )

    t0 = time.time()
    if args.sharded:
        img = mesh_mod.render_sharded(scene, mesh_mod.make_mesh(), args.spp, args.seed)
    else:
        from mitsuba_customization_tpu_torch.render.integrator import render

        img = render(scene, args.spp, args.seed, args.integrator, args.depth)
    sync()
    dt = time.time() - t0
    spp = args.spp or scene.config.spp
    n_rays = scene.config.width * scene.config.height * spp
    logger.info("rendered %dx%d @ %d spp in %.2fs (%.1f Mprimary rays/s)",
                scene.config.width, scene.config.height, spp, dt,
                n_rays / dt / 1e6)

    if rank == 0:
        write_image(args.output, img)
        logger.info("wrote %s", args.output)
    if joined:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
