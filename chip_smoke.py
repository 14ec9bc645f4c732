#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mitsuba_customization_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises (non-zero exit):
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the CUDA kernels from csrc/ (seconds printed);
  3. K1 (MERL trilinear eval) against its plain PyTorch version on the card
     at 4,194,304 lanes: flagship table, 3-material stack, lane mask;
  4. K2 (conditional-CDF inversion) against its plain version at 2,097,152
     lanes with the flagship's conditional CDFs, u at 0 and 1 - 1e-7 too;
  5. the flagship frame (512x512, 64 spp, depth 4) through load_dict ->
     render: one warm-up, one timed render; launch counters > 0, finite;
  6. the entry-size frame (64x64, 4 spp, depth 4) on the card and on the
     CPU (plain kernels): per-channel means within 2 %.
It then prints a JSON line describing each kernel and, last, the device
JSON line. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import time

import torch

K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_RTOL, K2_ATOL = 1e-6, 1e-7
FRAME_MEAN_RTOL = 0.02


def _time_ms(fn, reps=5):
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _unit_hemi(gen, n, dev):
    v = torch.randn((n, 3), generator=gen, device=dev)
    v[:, 2] = v[:, 2].abs() + 1e-3
    return v / v.norm(dim=-1, keepdim=True)


def _phi_table(shape, dev):
    """A table that varies along all three axes, smoothly. Its phi_d term
    scales with sin(theta_h) sin(theta_d), as for an isotropic BRDF: phi_d
    is undefined at those poles, where any two implementations may pick
    different angles."""
    n_th, n_td, n_pd, _ = shape
    th = ((torch.arange(n_th, device=dev) + 0.5) / n_th) ** 2 * (torch.pi / 2)
    td = (torch.arange(n_td, device=dev) + 0.5) / n_td * (torch.pi / 2)
    pd = (torch.arange(n_pd, device=dev) + 0.5) / n_pd * torch.pi
    rgb = torch.tensor([1.0, 0.7, 0.4], device=dev)
    return (0.3 + 0.2 * torch.cos(3 * th)[:, None, None, None]
            * torch.cos(2 * td)[None, :, None, None]
            + 0.25 * torch.sin(th)[:, None, None, None]
            * torch.sin(td)[None, :, None, None]
            * torch.cos(2 * pd)[None, None, :, None]) * rgb


def _check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} lanes outside rtol {rtol} atol {atol}; "
            f"max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def phase_k1(table, dev):
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    n = 1 << 22  # 2N lanes of the main path at 2,097,152 lanes per pass
    gen = torch.Generator(device=dev).manual_seed(1)
    wi, wo = _unit_hemi(gen, n, dev), _unit_hemi(gen, n, dev)
    # border lanes: wi == wo (theta_d = 0), normal incidence, grazing,
    # phi_d at the wrap (wo mirrored through the plane of incidence)
    wo[:4096] = wi[:4096]
    wi[4096:8192] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    wo[8192:12288, 2] = 1e-4
    wo[12288:16384] = wi[12288:16384] * torch.tensor([-1.0, -1.0, 1.0], device=dev)
    wo = wo / wo.norm(dim=-1, keepdim=True)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8

    stack = torch.stack([table, table.flip(0) * 0.7, _phi_table(table.shape, dev)])
    slot = torch.randint(0, 3, (n,), generator=gen, device=dev)
    slot[:16384] %= 2  # the pole lanes above stay on phi_d-free tables
    err = 0.0
    for tbl, sl in ((table, None), (stack, slot)):
        got = k1.eval_trilinear(tbl, wi, wo, sl, mask)
        want = k1.eval_trilinear_plain(tbl, wi, wo, sl, mask)
        torch.cuda.synchronize()
        err = max(err, _check_close("K1", got, want, K1_RTOL, K1_ATOL))
    ms = _time_ms(lambda: k1.eval_trilinear(table, wi, wo, None, mask))
    plain_ms = _time_ms(lambda: k1.eval_trilinear_plain(table, wi, wo, None, mask))
    print(f"K1 merl_eval: {n} lanes, max abs err {err:.3e} "
          f"(rtol {K1_RTOL}, atol {K1_ATOL}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k2(cdf_cond, dev):
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2

    n = 1 << 21  # one 2,097,152-lane pass of the main path
    n_sl, h, w = cdf_cond.shape
    gen = torch.Generator(device=dev).manual_seed(2)

    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    args = (ints(n_sl), torch.rand(n, generator=gen, device=dev),
            ints(h), ints(h), ints(w), ints(h), ints(w))
    args[1][: n // 8] = 0.0
    args[1][n // 8: n // 4] = 1.0 - 1e-7
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    got = k2.cond_sample_pdf(cdf_cond, *args, valid)
    want = k2.cond_sample_pdf_plain(cdf_cond, *args, valid)
    torch.cuda.synchronize()
    idx_got = torch.clamp((got[0] * w).floor(), max=w - 1)
    idx_want = torch.clamp((want[0] * w).floor(), max=w - 1)
    if not bool((idx_got == idx_want).all()):
        raise AssertionError("K2: sampled cell index differs from the plain version")
    err = max(_check_close(f"K2[{i}]", g, r, K2_RTOL, K2_ATOL)
              for i, (g, r) in enumerate(zip(got, want)))
    ms = _time_ms(lambda: k2.cond_sample_pdf(cdf_cond, *args, valid))
    plain_ms = _time_ms(lambda: k2.cond_sample_pdf_plain(cdf_cond, *args, valid))
    print(f"K2 cond_sample: {n} lanes, idx equal, max abs err {err:.3e} "
          f"(rtol {K2_RTOL}, atol {K2_ATOL}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
    from mitsuba_customization_tpu_torch.ops import build
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.scenes import flagship_dict

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    how = "cached" if build.build_seconds is None else "compiled with nvcc"
    print(f"build: {time.perf_counter() - t0:.1f} s ({how})")

    scene = mt.load_dict(flagship_dict(512, 64, 4), dev)
    tab = scene.bsdfs.stacks[bsdf_mod.TABULATED]
    k1_stats = phase_k1(tab.table[0].contiguous(), dev)
    k2_stats = phase_k2(tab.sampling.cdf_cond.reshape(-1, 32, 64).contiguous(), dev)

    mt.render(scene, spp=64, seed=0)  # warm-up
    torch.cuda.synchronize()
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp=64, seed=1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES}
    rays = stats["rays_traced"]
    print(f"frame 512x512 64spp depth 4: {secs:.3f} s, {rays:.0f} rays, "
          f"{rays / secs / 1e6:.2f} Mrays/s; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if img.shape != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("flagship frame is not a finite 512x512x3 image")

    small = flagship_dict(64, 4, 4)
    gpu = mt.render(mt.load_dict(small, dev), spp=4, seed=0).mean((0, 1)).cpu()
    cpu = mt.render(mt.load_dict(small, "cpu"), spp=4, seed=0).mean((0, 1))
    rel = ((gpu - cpu).abs() / cpu.abs()).max().item()
    print(f"entry frame 64x64 4spp: gpu means {gpu.tolist()}, cpu means "
          f"{cpu.tolist()}, max rel diff {rel:.2e} (limit {FRAME_MEAN_RTOL})")
    if not rel <= FRAME_MEAN_RTOL:
        raise AssertionError("GPU and CPU frame means disagree")

    kernels = [
        dict(name="merl_eval", route="cuda", source=k1.SOURCE,
             replaces="mitsuba_customization_tpu/ops/merl_sorted.py:182",
             launches=launches["K1"], **k1_stats),
        dict(name="cond_sample", route="cuda", source=k2.SOURCE,
             replaces="mitsuba_customization_tpu/ops/marginal_sorted.py:93",
             launches=launches["K2"], **k2_stats),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
