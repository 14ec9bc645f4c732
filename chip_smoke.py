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
     CPU (plain kernels): per-channel means within 2 %;
  7. K3 (cluster closest hit) against its plain version on the matpreview
     camera wavefront, 2,097,152 lanes (a 262,144-lane slice if the plain
     version takes over 30 s): hit/miss equal, t within rtol 1e-6, prims
     equal on >= 99.9 % of hits;
  8. K4 (cluster any hit) against its plain version on NEE shadow rays from
     those hits toward the area light, maxt = 0 on a quarter of the lanes:
     equal;
  9. the matpreview frame (512x512, 8 spp, depth 8, 20,484 prims, 10 MERL
     materials, area light) through load_dict -> probe_compact_schedule ->
     render: one warm-up, one timed render; K1-K4 launched, finite;
 10. the matpreview frame at 64x64, 4 spp, depth 4 with that schedule, on
     the card and on the CPU (plain kernels): per-channel means within 2 %.
Each phase's counts are set to 0 just before its render and read just
after. It then prints a JSON line describing each kernel and, last, the
device JSON line. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import time

import torch

K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_RTOL, K2_ATOL = 1e-6, 1e-7
# K3: both sides round every product and sum on its own, so t agrees to
# rounding; the prim may differ only on ties (shared mesh edges) and where
# the kernel's running-best pruning drops a box whose entry rounds above a
# hit inside it
K3_T_RTOL = 1e-6
K3_PRIM_AGREE = 0.999
PLAIN_SLICE_S = 30.0
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


def camera_wavefront(scene, spp, seed=0):
    """The camera rays of the first render pass of `scene` (all pixels x
    spp lanes, 16x16 pixel blocks, as integrator.render orders them)."""
    import numpy as np

    from mitsuba_customization_tpu_torch.render.sensors import sample_ray

    h, w = scene.config.height, scene.config.width
    order = np.arange(h * w).reshape(h // 16, 16, w // 16, 16)
    order = order.transpose(0, 2, 1, 3).reshape(-1)
    pixel = torch.as_tensor(order, device=scene.device).repeat_interleave(spp)
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    jitter = torch.rand((pixel.shape[0], 2), generator=gen, device=scene.device)
    film_xy = torch.stack([pixel % w, pixel // w], -1).to(torch.float32) + jitter
    film_uv = film_xy / torch.tensor([w, h], dtype=torch.float32, device=scene.device)
    return sample_ray(scene.sensor, film_uv, w / h)


def _plain_span(fn, n):
    """Lanes the plain version is compared and timed on: all n, or the
    first 262,144 if one plain call over all n would take over 30 s
    (extrapolated from a call on that slice)."""
    k = min(n, 1 << 18)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(k)
    torch.cuda.synchronize()
    est = (time.perf_counter() - t0) * n / k
    return (n if est <= PLAIN_SLICE_S else k), est


def phase_k3(scene, ray):
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.render.records import Ray

    cs = scene.clusters
    n_all = ray.o.shape[0]

    def sub(k):
        return Ray(ray.o[:k], ray.d[:k], ray.maxt[:k])

    n, plain_s = _plain_span(lambda k: cl.intersect_plain(cs, sub(k)), n_all)
    r = sub(n)
    t, prim, u, v, g = cl.intersect(cs, r)
    t_p, u_p, v_p, fld_p = cl.intersect_plain(cs, r)
    torch.cuda.synchronize()
    prim_p = fld_p[:, cl.F_PRIM].long()
    hit, hit_p = prim >= 0, prim_p >= 0
    hit_agree = float((hit == hit_p).float().mean())
    if hit_agree != 1.0:
        raise AssertionError(f"K3: hit/miss differs on {1 - hit_agree:.3e} of lanes")
    err = float(((t - t_p).abs() / t_p.abs())[hit].max()) if bool(hit.any()) else 0.0
    if not err <= K3_T_RTOL:
        raise AssertionError(f"K3: max rel t error {err:.3e} > {K3_T_RTOL}")
    prim_agree = float((prim == prim_p)[hit].float().mean())
    if not prim_agree >= K3_PRIM_AGREE:
        raise AssertionError(f"K3: prims agree on {prim_agree:.5f} of hits")
    same = hit & (prim == prim_p)
    g_p = cl._unpack(t_p, u_p, v_p, fld_p)[4]
    if not all(bool((a[same] == b[same]).all()) for a, b in zip(g, g_p)):
        raise AssertionError("K3: winner fields differ from the plain version's")
    uv_err = float(torch.maximum((u - u_p).abs(), (v - v_p).abs())[same].max())
    abs_err = float((t - t_p).abs()[hit].max())
    ms = _time_ms(lambda: cl.intersect(cs, r))
    plain_ms = _time_ms(lambda: cl.intersect_plain(cs, r))
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"K3 cluster_closest: {n} lanes ({which} of {n_all}), hits "
          f"{float(hit.float().mean()):.4f}, hit/miss agreement {hit_agree}, "
          f"max t err {abs_err:.3e} (rel {err:.3e}, limit {K3_T_RTOL}), prim "
          f"agreement {prim_agree:.6f}, max u/v err {uv_err:.3e}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms), (t, prim, u, v, g, r)


def phase_k4(scene, hits):
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.render import emitters as em
    from mitsuba_customization_tpu_torch.render import geometry as geo
    from mitsuba_customization_tpu_torch.render.records import Ray

    t, prim, u, v, g, r = hits
    si = geo.interaction_from_g(g, r, t, prim, u, v)
    n_all = t.shape[0]
    gen = torch.Generator(device=t.device).manual_seed(4)
    u3 = torch.rand((n_all, 3), generator=gen, device=t.device)
    ds = em.sample_direction(scene.emitters, scene.geometry, si.p, u3)
    shadow = geo.spawn_ray(si, ds.d)
    lane = torch.arange(n_all, device=t.device)
    maxt = torch.where(si.valid & (ds.pdf > 0.0) & (lane % 4 != 0),
                       ds.dist * (1.0 - 1e-3), 0.0)
    ray = Ray(shadow.o, shadow.d, maxt)

    def sub(k):
        return Ray(ray.o[:k], ray.d[:k], ray.maxt[:k])

    n, plain_s = _plain_span(lambda k: cl.occluded_plain(scene.clusters, sub(k)), n_all)
    rs = sub(n)
    occ = cl.occluded(scene.clusters, rs)
    occ_p = cl.occluded_plain(scene.clusters, rs)
    torch.cuda.synchronize()
    agree = float((occ == occ_p).float().mean())
    if agree != 1.0:
        raise AssertionError(f"K4: occlusion differs on {1 - agree:.3e} of lanes")
    if bool(occ[(lane[:n] % 4) == 0].any()):
        raise AssertionError("K4: a lane with maxt = 0 is occluded")
    ms = _time_ms(lambda: cl.occluded(scene.clusters, rs))
    plain_ms = _time_ms(lambda: cl.occluded_plain(scene.clusters, rs))
    live = float((rs.maxt > 0).float().mean())
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"K4 cluster_shadow: {n} lanes ({which} of {n_all}), live "
          f"{live:.4f}, occluded {float(occ.float().mean()):.4f}, agreement "
          f"{agree}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=0.0 if agree == 1.0 else 1.0, ms=ms, plain_ms=plain_ms)


def _launch_counts():
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    return {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES,
            "K3": cl.LAUNCHES["closest"], "K4": cl.LAUNCHES["shadow"]}


def _reset_counts():
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    cl.LAUNCHES["closest"] = 0
    cl.LAUNCHES["shadow"] = 0


def phase_matpreview(dev, res=512, spp=8, depth=8):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import (
        matpreview_dict,
        probe_compact_schedule,
    )

    t0 = time.perf_counter()
    scene = mt.load_dict(matpreview_dict(res, spp, depth), dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    scene, fracs = probe_compact_schedule(scene, spp=4)
    mt.render(scene, spp=spp, seed=0)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp=spp, seed=1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    rays = stats["rays_traced"]
    print(f"matpreview {res}x{res} {spp}spp depth {depth} ({scene.geometry.p0.shape[0]} "
          f"prims, {scene.clusters.cl_box.shape[0]} clusters, load "
          f"{load_s:.1f} s): {secs:.3f} s, {rays:.0f} rays, "
          f"{rays / secs / 1e6:.2f} Mrays/s; schedule "
          f"{[round(f, 4) for f in fracs]}; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the matpreview path: {launches}")
    if img.shape != (res, res, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"matpreview frame is not a finite {res}x{res}x3 image")
    return scene, fracs, launches


def phase_matpreview_cpu(dev, fracs):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(64, 4, 4, compact=fracs)
    gpu = mt.render(mt.load_dict(d, dev), spp=4, seed=0).mean((0, 1)).cpu()
    cpu = mt.render(mt.load_dict(d, "cpu"), spp=4, seed=0).mean((0, 1))
    rel = ((gpu - cpu).abs() / cpu.abs()).max().item()
    print(f"matpreview 64x64 4spp depth 4: gpu means {gpu.tolist()}, cpu means "
          f"{cpu.tolist()}, max rel diff {rel:.2e} (limit {FRAME_MEAN_RTOL})")
    if not rel <= FRAME_MEAN_RTOL:
        raise AssertionError("GPU and CPU matpreview means disagree")


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
    from mitsuba_customization_tpu_torch.ops import clusters as cl
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
    _reset_counts()
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp=64, seed=1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    rays = stats["rays_traced"]
    print(f"frame 512x512 64spp depth 4: {secs:.3f} s, {rays:.0f} rays, "
          f"{rays / secs / 1e6:.2f} Mrays/s; launches {launches}")
    if min(launches["K1"], launches["K2"]) <= 0:
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

    mp_scene, fracs, mp_launches = phase_matpreview(dev)
    k3_stats, hits = phase_k3(mp_scene, camera_wavefront(mp_scene, 8))
    k4_stats = phase_k4(mp_scene, hits)
    del hits
    phase_matpreview_cpu(dev, fracs)

    kernels = [
        dict(name="merl_eval", route="cuda", source=k1.SOURCE,
             replaces="mitsuba_customization_tpu/ops/merl_sorted.py:182",
             launches=mp_launches["K1"], **k1_stats),
        dict(name="cond_sample", route="cuda", source=k2.SOURCE,
             replaces="mitsuba_customization_tpu/ops/marginal_sorted.py:93",
             launches=mp_launches["K2"], **k2_stats),
        dict(name="cluster_closest", route="cuda", source=cl.SOURCES["closest"],
             replaces="mitsuba_customization_tpu/ops/clusters.py:441",
             launches=mp_launches["K3"], **k3_stats),
        dict(name="cluster_shadow", route="cuda", source=cl.SOURCES["shadow"],
             replaces="mitsuba_customization_tpu/ops/clusters.py:659",
             launches=mp_launches["K4"], **k4_stats),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
