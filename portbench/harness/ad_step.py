"""The `ad_step` entry: inverse-rendering steps in a closed loop with one
client, as `ad.optimize` runs them: step i renders at seed base + i + 1
through `grad_render` (the captured loss and gradients), takes one Adam
step (`ad.Optimizer`, clamped non-negative) and reads the loss back to
the host before the next step starts.

Set-up builds the scene, a target image drawn from the seed, and one
optimiser over the configuration's parameters, and drives that same
optimiser through the traffic's first `checked_steps` steps by the
window's own call (the first plans, warms up and captures the step): their
losses, the first gradient as Adam holds it after one step, and each
parameter's change over those steps are kept for the check. The window
then goes on with the same optimiser. Once it has closed, the plain
reference follows the same steps from the same start
(harness/check_ad.py).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench.harness import calls as calls_mod
from portbench.harness import check_ad, files, frame, peaks, stats
from portbench.harness import trace as trace_mod

MASK32 = 0xFFFFFFFF


def target_image(seed, h, w, lo=0.02, hi=0.3, waves=5):
    """(h, w, 3) float32: a smooth image in [lo, hi] drawn from the seed,
    a sum of `waves` random plane waves a channel."""
    rng = np.random.default_rng([int(seed), 0x7A26E7])
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    out = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(waves):
            k = rng.normal(0, 6, 2)
            out[..., c] += np.sin(k[0] * yy + k[1] * xx + rng.uniform(0, 2 * np.pi))
    out = (out - out.min()) / max(out.max() - out.min(), 1e-12)
    return (lo + (hi - lo) * out).astype(np.float32)


class Job:
    """One inverse-rendering job: the scene, the target and one optimiser,
    stepped by `step()` (the window's call)."""

    def __init__(self, config, traffic, seed, device):
        import torch

        import mitsuba_customization_tpu_torch as mt
        from mitsuba_customization_tpu_torch.render import ad
        from mitsuba_customization_tpu_torch.render.params import traverse

        self.torch, self.ad = torch, ad
        self.d = frame.scene_dict(config, traffic)
        self.scene = mt.load_dict(self.d, device=device)
        self.keys = list(config["ad_keys"])
        full = traverse(self.scene)
        self.start = {k: full[k].detach().clone() for k in self.keys}
        res = traffic["resolution"]
        self.target = torch.as_tensor(target_image(seed, res, res), device=device)
        self.opt = ad.Optimizer(self.start, lr=traffic["lr"], clip_nonneg=self.keys)
        self.spp = traffic["spp"]
        self.base = int(seed) & MASK32
        self.it = 0
        # the loss and gradients of one step (the sharded entry sets its own)
        self.grad = lambda scene, params, target, s: ad.grad_render(
            scene, params, target, spp=self.spp, seed=s)

    def seed_of(self, it):
        return (self.base + it + 1) & MASK32

    def step(self):
        with self.torch.profiler.record_function("portbench.grad_render"):
            loss, grads = self.grad(self.scene, self.opt.params, self.target,
                                    self.seed_of(self.it))
        with self.torch.profiler.record_function("portbench.optimizer"):
            self.opt.step(grads)
        self.it += 1
        with self.torch.profiler.record_function("portbench.loss_read_back"):
            return float(loss)

    def first_gradient(self):
        """{key: the gradient as Adam holds it after its first step}:
        exp_avg / (1 - beta1); zeros where the optimiser holds none."""
        b1 = self.opt.opt.defaults["betas"][0]
        state = self.opt.opt.state
        return {k: state[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in state.get(p, {})
                else self.torch.zeros_like(p) for k, p in self.opt.params.items()}

    def norms(self, tensors):
        return {k: float(v.double().norm()) for k, v in tensors.items()}

    def checked_steps(self, n):
        """The first n steps: (losses, first gradient's norms, norms of each
        parameter's change)."""
        losses = [self.step()]
        g1 = self.norms(self.first_gradient())
        losses += [self.step() for _ in range(n - 1)]
        change = self.norms({k: self.opt.params[k].detach() - self.start[k]
                             for k in self.keys})
        return losses, g1, change


def run(config, traffic, seed, seconds, trace, t_start, device, log):
    """One run of an AD cell: (result dict without `checks`, checks)."""
    import torch

    from mitsuba_customization_tpu_torch.render import ad, frame_graph

    on_card = device == "cuda"
    job = Job(config, traffic, seed, device)
    program = job.checked_steps(traffic["checked_steps"])
    kernels = files.kernels()
    recorded = None
    if trace:
        with calls_mod.recording(kernels, {"prims": frame.prims_of(job.d)}) as recorded:
            ad._eager_loss_and_grad(job.scene, job.opt.params, job.target, job.spp,
                                    job.seed_of(job.it))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    lat = []
    window = None
    if trace:
        def traced_step(i):
            job.step()

        reps = traffic["trace_steps"]
        peak = peaks.of(torch.cuda.get_device_name(0)) if on_card else None
        window = trace_mod.whole_trace(traced_step, reps, recorded, kernels, peak, log)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        job.step()
        lat.append(time.perf_counter() - t)
    window_s = time.perf_counter() - t0
    if window is not None:
        window.call_wall_s = window_s / len(lat)
    mem_peak = torch.cuda.max_memory_reserved() if on_card else 0
    d, target, start, keys = job.d, job.target.cpu(), job.start, job.keys
    start = {k: v.cpu() for k, v in start.items()}
    del job
    frame_graph.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check_ad.check(d, start, target, seed, traffic, program, device, log,
                            config["limits"][traffic["name"]], config["reference"])
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(lat) + len(program[0]) + (window.reps if window else 0),
        "failed": 0,
        "setup_s": setup_s,
        "memory_peak_bytes": int(mem_peak),
        "e2e": {"step_ms": stats.per_item_ms(window_s, len(lat)),
                "step_p95_ms": stats.percentile(lat, 95) * 1e3},
        "window": window,
    }
    return result, checks
