"""The `ad_step_sharded` entry: ad_step's job with the image's rows split
over `ranks` processes, one card each (`parallel/mesh`): every rank renders
its slab and differentiates its share of the loss in one captured step
(`loss_and_grad_sharded_jit`), the loss and the gradients all-reduce over
the ranks, and every rank takes the same Adam step. Rank 0 runs in this
process, times the window and prints the result; the others are spawned
here and joined before the run ends.

The ranks step in lockstep: before each call rank 0 broadcasts what comes
next (a step, the eager step that records the kernels' calls, or the end),
so a traced or retried stretch on rank 0 costs the others the same calls.
That broadcast is one 8-byte collective a step, inside the window.
Once the window has closed the other ranks wait at a barrier while rank 0
holds the first checked steps against the plain reference (over the whole
image: the exchange between the cards is part of what it checks).
"""

from __future__ import annotations

import gc
import socket
import sys
import time

from portbench.harness import ad_step, calls as calls_mod, check_ad, files, frame, peaks, stats
from portbench.harness import trace as trace_mod

STOP, STEP, EAGER = 0, 1, 2


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Lockstep:
    """Rank 0's say over what every rank runs next."""

    def __init__(self, job, device):
        import torch
        import torch.distributed as dist

        self.job, self.dist = job, dist
        self.flag = torch.zeros(1, dtype=torch.int64, device=device)

    def say(self, what):
        self.flag.fill_(what)
        self.dist.broadcast(self.flag, 0)

    def hear(self):
        self.dist.broadcast(self.flag, 0)
        return int(self.flag.item())

    def step(self):
        self.say(STEP)
        return self.job.step()


def _setup(rank, world, init, config, traffic, seed, device):
    import torch

    from mitsuba_customization_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.initialize_distributed(init, world, rank, device=device, timeout=900)
    mesh = mesh_mod.make_mesh()
    job = ad_step.Job(config, traffic, seed, device)
    spp = traffic["spp"]
    job.grad = lambda scene, params, target, s: mesh_mod.loss_and_grad_sharded_jit(
        scene, params, target, mesh, spp, s)
    job.eager = lambda: mesh_mod.loss_and_grad_sharded(
        job.scene, job.opt.params, job.target, mesh, spp, job.seed_of(job.it))
    return job, Lockstep(job, "cuda" if device == "cuda" else "cpu"), torch


def _follower(rank, world, init, config, traffic, seed, device):
    """Ranks 1..: the same set-up and checked steps, then whatever rank 0
    says, then the barrier of rank 0's check."""
    import torch.distributed as dist

    job, lock, torch = _setup(rank, world, init, config, traffic, seed, device)
    job.checked_steps(traffic["checked_steps"])
    while (what := lock.hear()) != STOP:
        if what == STEP:
            job.step()
        else:
            job.eager()
    peak = torch.tensor([torch.cuda.max_memory_reserved() if device == "cuda" else 0],
                        device=lock.flag.device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    dist.barrier()
    dist.destroy_process_group()


def run(config, traffic, seed, seconds, trace, t_start, device, log):
    """One run of a sharded AD cell on rank 0: (result dict without
    `checks`, checks)."""
    import torch.multiprocessing as mp

    world = traffic["ranks"]
    init = f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_follower, args=(r, world, init, config, traffic, seed, device))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        return _leader(world, init, config, traffic, seed, seconds, trace, t_start, device, log)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
                log(f"rank {procs.index(p) + 1} did not end and was stopped")


def _leader(world, init, config, traffic, seed, seconds, trace, t_start, device, log):
    import torch.distributed as dist

    from mitsuba_customization_tpu_torch.render import frame_graph

    on_card = device == "cuda"
    job, lock, torch = _setup(0, world, init, config, traffic, seed, device)
    program = job.checked_steps(traffic["checked_steps"])
    kernels = files.kernels()
    recorded = None
    if trace:
        with calls_mod.recording(kernels, {"prims": frame.prims_of(job.d)}) as recorded:
            lock.say(EAGER)
            job.eager()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    lat, window = [], None
    if trace:
        reps = traffic["trace_steps"]
        peak = peaks.of(torch.cuda.get_device_name(0)) if on_card else None
        window = trace_mod.whole_trace(lambda i: lock.step(), reps, recorded, kernels, peak, log)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        lock.step()
        lat.append(time.perf_counter() - t)
    window_s = time.perf_counter() - t0
    if window is not None:
        window.call_wall_s = window_s / len(lat)
    lock.say(STOP)
    mem = torch.tensor([torch.cuda.max_memory_reserved() if on_card else 0],
                       device=lock.flag.device)
    dist.all_reduce(mem, op=dist.ReduceOp.MAX)
    d, target, keys = job.d, job.target.cpu(), job.keys
    start = {k: v.cpu() for k, v in job.start.items()}
    del job, lock.job
    frame_graph.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    try:
        checks = check_ad.check(d, start, target, seed, traffic, program, device, log,
                                config["limits"][traffic["name"]], config["reference"])
    finally:
        dist.barrier()
        dist.destroy_process_group()
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(lat) + len(program[0]) + (window.reps if window else 0),
        "failed": 0,
        "setup_s": setup_s,
        "memory_peak_bytes": int(mem.item()),
        "e2e": {"step_ms": stats.per_item_ms(window_s, len(lat)),
                "step_p95_ms": stats.percentile(lat, 95) * 1e3},
        "window": window,
    }
    print(f"[portbench] rank 0 of {world}: {len(lat)} steps in {window_s:.2f} s",
          file=sys.stderr, flush=True)
    return result, checks
