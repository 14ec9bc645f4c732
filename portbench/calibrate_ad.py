"""The readings an AD cell's limits are set from (PERF.md), on the card, in
one process, each at the cell's own size:

- the program's: for each of --seeds seeds, a fresh optimiser and target
  driven through the checked steps by the window's own call, held
  against the plain reference as a run holds them;
- the control's (first --control seeds): the reference computed in
  bfloat16, one precision below the configuration's float32, in the
  program's place;
- the faults' (first --control seeds), planted in the reference put in the
  program's place: half of the image's pixels left out of the loss (the
  mean taken over the rest), every gradient altered by 5 % where it is
  produced, and for a cell of several ranks the exchange left out (rank
  0's slab alone). (A step that returns its state unchanged reads 1 in
  step_gap by the measure's definition and needs no run.)

    python3 portbench/calibrate_ad.py --workload matpreview-ad --seeds 12 --control 3

Prints one JSON line a reading, and a summary last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fault_half_batch(reference):
    """The reference's loss and gradients over the first half of the
    image's pixels alone, the mean taken over them (a loss_and_grad)."""
    from portbench.harness import files

    return lambda *a: _part(files.reference(reference), 2, True, *a)


def fault_no_exchange(reference, ranks):
    """Rank 0's share alone, as it stands without the all-reduce: the loss
    and gradients of its slab (the first 1 / ranks of the rows) over the
    whole image's count (a loss_and_grad)."""
    from portbench.harness import files

    return lambda *a: _part(files.reference(reference), ranks, False, *a)


def _part(ref, parts, mean_over_part, d, params, target, seed, device, dtype):
    import torch

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    scene = ref.scene_of(d, device, dtype, leaves)
    n = scene.width * scene.height // parts
    count = n if mean_over_part else scene.width * scene.height
    per = max(1, (1 << 16) // scene.spp)
    tgt = target.to(device=device, dtype=dtype).reshape(-1, 3)
    total = 0.0
    for p0 in range(0, n, per):
        pix = torch.arange(p0, min(p0 + per, n), device=device)
        if hasattr(scene, "vol"):
            scene.vol.new_pass()
            img = ref.render_pixels(scene, seed, pix, True)
        else:
            img = ref.render_pixels(scene, seed, pix)
        part = ((img - tgt[pix]) ** 2).sum() / (count * 3)
        if part.requires_grad:  # rows of sky alone depend on no parameter
            part.backward()
        total += float(part.detach())
    return torch.tensor(total), {k: v.grad for k, v in leaves.items()}


def fault_altered(reference):
    """The reference's loss and gradients, every gradient 5 % off (a
    loss_and_grad)."""
    from portbench.harness import files

    def loss_of(d, params, target, seed, device, dtype):
        loss, grads = files.reference(reference).loss_and_grad(d, params, target, seed,
                                                                device, dtype)
        return loss, {k: g * 1.05 for k, g in grads.items()}

    return loss_of


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="matpreview-ad")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first", type=int, default=3_100_000_019)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reference-only", action="store_true",
                   help="the control's and the faults' readings alone (no program run): "
                        "what a cell of several cards needs from one")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from mitsuba_customization_tpu_torch.render import ad, frame_graph
    from portbench.harness import ad_step, check_ad, files

    dev = a.device
    work, _, config, traffic = files.cell(a.workload, files.manifest(ROOT))
    traffic = dict(traffic, name=work["traffic"])
    job = ad_step.Job(config, traffic, a.first, dev)
    if a.reference_only:
        job.scene = None
        frame_graph.clear()
    res = traffic["resolution"]
    lr = traffic["lr"]
    rows = []
    for i in range(a.seeds):
        base = (a.first + 7919 * i) & 0xFFFFFFFF
        job.target = torch.as_tensor(ad_step.target_image(base, res, res), device=dev)
        job.opt = ad.Optimizer(job.start, lr=lr, clip_nonneg=job.keys)
        job.base, job.it = base, 0
        t0 = time.perf_counter()
        n_checked = traffic["checked_steps"]
        program = None if a.reference_only else job.checked_steps(n_checked)
        seeds = [job.seed_of(k) for k in range(n_checked)]
        start = {k: v.detach().clone() for k, v in job.start.items()}
        t1 = time.perf_counter()
        ref = config["reference"]
        reference = check_ad.reference_steps(ref, job.d, start, job.target, seeds, lr, dev)
        row = {"seed": base, "program_s": t1 - t0, "reference_s": time.perf_counter() - t1,
               "reference_losses": reference[0], "reference_grad_norms": reference[1],
               "reference_change_norms": reference[2]}
        if program is not None:
            row.update({"losses": program[0], "grad_norms": program[1],
                        "change_norms": program[2],
                        "program": check_ad.numbers(program, reference)})
        if i < a.control:
            faults = [("control", torch.bfloat16, None),
                      ("half_batch", torch.float32, fault_half_batch(ref)),
                      ("altered", torch.float32, fault_altered(ref))]
            if traffic.get("ranks", 1) > 1:
                faults.append(("no_exchange", torch.float32,
                               fault_no_exchange(ref, traffic["ranks"])))
            for name, dtype, loss_of in faults:
                got = check_ad.reference_steps(ref, job.d, start, job.target, seeds, lr, dev,
                                               dtype, loss_of)
                row[name] = check_ad.numbers(got, reference)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = ("loss_gap", "grad_gap", "step_gap")
    summary = {"card": torch.cuda.get_device_name(0) if dev == "cuda" else dev}
    if not a.reference_only:
        summary["lower"] = {k: max(r["program"][k] for r in rows) for k in names}
    for what in ("control", "half_batch", "altered", "no_exchange"):
        got = [r[what] for r in rows if what in r]
        if got:
            summary[what] = {k: min(g[k] for g in got) for k in names}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
