"""The readings a frame cell's limits are set from (PERF.md), on the card,
in one process:

- the program's: for each of --seeds seeds s, the frames at s and s + 1
  from `render_jit`, checked as a run checks its window (the same frames
  and pixels drawn from s, the same numbers);
- the control's: for the first --control of those seeds, the plain
  reference computed in bfloat16, one precision below the configuration's
  float32, in the program's place at the same frames and pixels.

    python3 portbench/calibrate_frame.py --workload matpreview-frame --seeds 12 --control 3

Prints one JSON line a reading and a summary (the largest program reading
and the smallest control reading of each number) last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="matpreview-frame")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first", type=int, default=3_000_000_017)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit
    from portbench.harness import check_frame, files, frame

    work, _, config, traffic = files.cell(a.workload, files.manifest(ROOT))
    traffic = dict(traffic, name=work["traffic"])
    d = frame.scene_dict(config, traffic)
    scene = mt.load_dict(d, device="cuda")
    spp = traffic["spp"]
    n_check, n_pix = traffic["check_frames"], traffic["check_pixels"]
    seeds = [(a.first + 7919 * i) & 0xFFFFFFFF for i in range(a.seeds)]
    frames = {s: [render_jit(scene, spp, (s + k) & 0xFFFFFFFF).cpu().numpy()
                  for k in range(n_check)] for s in seeds}
    del scene
    frame_graph.clear()
    torch.cuda.empty_cache()
    ref = files.reference(config["reference"])
    limits = {"pixels_off": float("inf"), "rel_l1": float("inf")}
    got = {"program": [], "control": []}

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for i, s in enumerate(seeds):
        t0 = time.perf_counter()
        c = check_frame.check(d, frames[s], s, s, "cuda", log, limits, n_check, n_pix,
                              config["reference"])
        row = {"seed": s, "program": {k: v["value"] for k, v in c.items()},
               "reference_s": time.perf_counter() - t0}
        got["program"].append(row["program"])
        if i < a.control:
            fr, pix = check_frame.plan(n_check, frames[s][0].shape[0] * frames[s][0].shape[1],
                                       s, n_check, n_pix)
            lo = ref.scene_of(d, "cuda", torch.bfloat16)
            hi = ref.scene_of(d, "cuda", torch.float32)
            want, low = [], []
            for f, px in zip(fr, pix):
                pt = torch.as_tensor(px, device="cuda")
                seed_f = (s + int(f)) & 0xFFFFFFFF
                want.append(ref.render_pixels(hi, seed_f, pt).float().cpu().numpy())
                low.append(ref.render_pixels(lo, seed_f, pt).float().cpu().numpy())
            off, l1 = check_frame.numbers(np.concatenate(low), np.concatenate(want))
            row["control"] = {"pixels_off": off, "rel_l1": l1}
            got["control"].append(row["control"])
        print(json.dumps(row), flush=True)
    summary = {"card": torch.cuda.get_device_name(0),
               "lower": {k: max(r[k] for r in got["program"]) for k in limits},
               "upper": {k: min(r[k] for r in got["control"]) for k in limits}
               if got["control"] else None}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
