#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mitsuba_customization_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises (non-zero exit):
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the CUDA kernels from csrc/ (seconds printed);
  3. K1 (MERL trilinear eval) against its plain PyTorch version on the card
     at 4,194,304 lanes, as two halves that share wi and the slot (the
     main path's call): flagship table, 3-material stack, lane masks;
  4. K2 (conditional-CDF inversion) against its plain version at 2,097,152
     lanes with the flagship's conditional CDFs, int64 indices, a strided
     u column (u at 0 and 1 - 1e-7 too) and a bool mask, as the main path
     hands them: the sampled cell equal on every lane, the values within
     tolerance, and the lanes not bit-equal counted;
  5. the flagship frame (512x512, 64 spp, depth 4) through load_dict ->
     render: one warm-up, one timed render; launch counters > 0, finite;
  6. the entry-size frame (64x64, 4 spp, depth 4) on the card and on the
     CPU (plain kernels): per-channel means within 2 %;
  7. K3 (cluster closest hit) against its plain version on the matpreview
     camera wavefront, 2,097,152 lanes (a 262,144-lane slice if the plain
     version takes over 30 s): hit/miss equal, prims equal on >= 99.9 % of
     hits, and t, u, v and fields bit-equal where they agree;
  8. K4 (cluster any hit) against its plain version on NEE shadow rays from
     those hits toward the area light, maxt = 0 on a quarter of the lanes:
     equal;
  9. the matpreview frame (512x512, 8 spp, depth 8, 20,484 prims, 10 MERL
     materials, area light) through load_dict -> probe_compact_schedule ->
     render: one warm-up, one timed render; K1-K4 launched, finite;
 10. per-bounce wavefronts: one more render of the matpreview frame with
     recording wrappers on that Scene's ray_intersect / ray_test and on the
     K1 / K2 module functions keeps the inputs of every K1-K4 call; each
     recorded call is checked against its plain version (K3: hit/miss, t,
     prim, u, v and fields; K4: occlusion on every lane; K1, K2 as in
     phases 3-4) and timed, one line per bounce (lanes, live lanes, kernel
     ms and bound ms of each kernel; K2's lanes not bit-equal);
 11. the matpreview frame at 64x64, 4 spp, depth 4 with that schedule, on
     the card and on the CPU (plain kernels): per-channel means within 2 %.
Each phase's counts are set to 0 just before its render and read just
after. It then prints a JSON line describing each kernel (launches per
matpreview frame; `ms`, `plain_ms`, `bound_ms` and `share` (bound over
time) of the phase 3, 4, 7 and 8 call; `frame_ms`, `frame_bound_ms` and
`frame_share` summed over the recorded calls of phase 10) and, last, the
device JSON line. A kernel's bound is
the larger of the bytes it must move (each input read once, each output
written once) at 3.35 TB/s and the operations it must do at 67 TFLOP/s
float32 (published H100 SXM peaks; the cluster kernels round every step
without FMA, so at most half of that rate is reachable for them). K1's
bytes count a call as the main path makes it: wi and the slot once for
both halves, wo only for live lanes, the masks and output of every lane,
and the table bins of the lanes that evaluate. K2's count the indices and
u of live lanes, the mask and outputs of every lane, and a CDF row a live
lane. For K3
and K4 both come from ops/clusters.min_work: the box and slot tests an
exact walk must do, and of the structure only the boxes and slabs some
lane must enter; dead lanes (maxt <= 0) count their maxt and output. No
single PyTorch call computes any of K1-K4, so `library_ms` is null.
Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import time

import torch

K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_RTOL, K2_ATOL = 1e-6, 1e-7
# K3: both sides round every product and sum on its own and send ties to
# the lowest (cluster, slot), so t, prim, u, v and fields agree exactly;
# the prim (and t, to rounding) may differ only where the kernel's
# running-best pruning drops a box whose entry rounds above a hit inside it
K3_T_RTOL = 1e-6
K3_PRIM_AGREE = 0.999
PLAIN_SLICE_S = 30.0
FRAME_MEAN_RTOL = 0.02

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per evaluated lane of K1 (half-vector map with acos/atan2,
# cell indices, 8-corner trilinear over 3 channels) and per live lane of
# K2 (inverting one 64-float row, three cell masses), counted generously:
# both kernels are bound by bytes. K3 and K4 count box and slot tests with
# ops/clusters.min_work.
K1_OPS = 170
K2_OPS = 220
K1_CELL_BYTES = 96   # 4 corner rows x 2 phi_d bins x 3 floats per lane
K2_ROW_BYTES = 256   # one 64-float CDF row per lane
K1_OUT_BYTES, K2_OUT_BYTES = 12, 16
# K3 / K4 bytes: a box row (8 floats); what a slot test reads of a slot
# row (type, p0, e1, e2: 10 floats) and the rest of a winner's 32-float
# row; per lane maxt, o and d (live lanes only), and the outputs (K3: t,
# u, v and the 32-float field row; K4: one byte)
BOX_BYTES = 32
SLOT_TEST_BYTES = 40
WINNER_REST_BYTES = 88
MAXT_BYTES, RAY_BYTES = 4, 24
K3_OUT_BYTES, K4_OUT_BYTES = 140, 1


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


def check_k2(got, want, w):
    """K2's gate: the sampled cell (x's column of W) equal on every lane,
    x and the three masses within K2_RTOL / K2_ATOL. Returns (max abs
    error, lanes on which any output is not bit-equal)."""
    idx_got = torch.clamp((got[0] * w).floor(), max=w - 1)
    idx_want = torch.clamp((want[0] * w).floor(), max=w - 1)
    if not torch.equal(idx_got, idx_want):
        raise AssertionError(f"K2: sampled cell differs on "
                             f"{int((idx_got != idx_want).sum())} lanes")
    err = max(_check_close(f"K2[{i}]", g, r, K2_RTOL, K2_ATOL)
              for i, (g, r) in enumerate(zip(got, want)))
    differ = torch.zeros_like(got[0], dtype=torch.bool)
    for g, r in zip(got, want):
        differ |= g.view(torch.int32) != r.view(torch.int32)
    return err, int(differ.sum())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bound(table, wi, wo, slot=None, mask=None, wo_b=None, mask_b=None):
    """K1's bound on one call, its arguments as eval_trilinear takes them:
    wi and the slot once for the lanes where either half is live, wo of
    the live lanes, the masks and the output of every lane, and the bins
    of the lanes that evaluate (live, both cosines > 0; at most the
    table), whose count also sets the operations."""
    halves = [(wo, mask)] + ([] if wo_b is None else [(wo_b, mask_b)])
    every = torch.ones(wi.shape[0], dtype=torch.bool, device=wi.device)
    live = [every if m is None else m for _, m in halves]
    either = int(torch.stack(live).any(0).sum())
    evaluated = sum(int((m & (wi[:, 2] > 0) & (o[:, 2] > 0)).sum())
                    for (o, _), m in zip(halves, live))
    nbytes = (min(_nbytes(table), evaluated * K1_CELL_BYTES)
              + either * (3 * wi.element_size() + (0 if slot is None else slot.element_size()))
              + sum(int(m.sum()) * 3 * o.element_size() for (o, _), m in zip(halves, live))
              + sum(_nbytes(m) for _, m in halves)
              + len(halves) * wi.shape[0] * K1_OUT_BYTES)
    return _bound(nbytes, evaluated * K1_OPS)


def k2_bound(cdf, *lanes):
    """K2's bound on one call, its arguments as cond_sample_pdf takes them:
    the indices and u of the live lanes, the mask and the four outputs of
    every lane, and a CDF row a live lane (at most the stack)."""
    valid = lanes[-1]
    live = int(valid.sum())
    nbytes = (min(_nbytes(cdf), live * K2_ROW_BYTES)
              + live * sum(a.element_size() for a in lanes[:-1])
              + valid.shape[0] * (valid.element_size() + K2_OUT_BYTES))
    return _bound(nbytes, live * K2_OPS)


def _cluster_work(cs, ray, out_bytes, **final):
    """(bytes, operations) that K3 or K4 must move and do on rays `ray`:
    per lane maxt and the outputs, o and d of live lanes; once per launch
    the root and supercluster boxes (if a lane is live), the cluster boxes
    of the superclusters and the cl_meta entry and filled slots of the
    clusters that ops/clusters.min_work says some lane must enter."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    w = cl.min_work(cs, ray, **final)
    n = ray.o.shape[0]
    live = int((torch.broadcast_to(ray.maxt, (n,)) > 0).sum())
    filled = (cs.slabs[:, :, cl.F_TYPE] >= 0).sum(1)
    nbytes = (n * (MAXT_BYTES + out_bytes) + live * RAY_BYTES
              + (live > 0) * (1 + cs.n_super) * BOX_BYTES
              + int(w.supers.sum()) * cl.GROUP * BOX_BYTES
              + int(w.clusters.sum()) * 4
              + int(filled[w.clusters].sum()) * SLOT_TEST_BYTES)
    ops = int(w.box.sum()) * cl.BOX_OPS + int(w.slot.sum()) * cl.SLOT_OPS
    return nbytes, ops


def k3_bound(cs, ray, t, prim):
    nbytes, ops = _cluster_work(cs, ray, K3_OUT_BYTES, t_hit=t)
    winners = torch.unique(prim[prim >= 0]).numel()
    return _bound(nbytes + winners * WINNER_REST_BYTES, ops)


def k4_bound(cs, ray, occ):
    return _bound(*_cluster_work(cs, ray, K4_OUT_BYTES, occluded=occ))


def phase_k1(table, dev):
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    n = 1 << 21  # one 2,097,152-lane pass; K1 evaluates two halves of it
    gen = torch.Generator(device=dev).manual_seed(1)
    wi, wo, wo_b = (_unit_hemi(gen, n, dev) for _ in range(3))
    # border lanes: wi == wo (theta_d = 0), normal incidence, grazing,
    # phi_d at the wrap (wo mirrored through the plane of incidence)
    wo[:4096] = wi[:4096]
    wi[4096:8192] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    wo[8192:12288, 2] = 1e-4
    wo[12288:16384] = wi[12288:16384] * torch.tensor([-1.0, -1.0, 1.0], device=dev)
    wo = wo / wo.norm(dim=-1, keepdim=True)
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))

    stack = torch.stack([table, table.flip(0) * 0.7, _phi_table(table.shape, dev)])
    slot = torch.randint(0, 3, (n,), generator=gen, device=dev)
    slot[:16384] %= 2  # the pole lanes above stay on phi_d-free tables
    err = 0.0
    for tbl, sl in ((table, None), (stack, slot)):
        for lanes in ((wi, wo, sl, mask), (wi, wo, sl, mask, wo_b, mask_b)):
            got = k1.eval_trilinear(tbl, *lanes)
            want = k1.eval_trilinear_plain(tbl, *k1.concat_halves(*lanes))
            torch.cuda.synchronize()
            err = max(err, _check_close("K1", got, want, K1_RTOL, K1_ATOL))
    lanes = (wi, wo, None, mask, wo_b, mask_b)
    joined = k1.concat_halves(*lanes)
    ms = _time_ms(lambda: k1.eval_trilinear(table, *lanes))
    plain_ms = _time_ms(lambda: k1.eval_trilinear_plain(table, *joined))
    bound_ms, bound_by = k1_bound(table, *lanes)
    print(f"K1 merl_eval: {2 * n} lanes (two halves), max abs err {err:.3e} "
          f"(rtol {K1_RTOL}, atol {K1_ATOL}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_k2(cdf_cond, dev):
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2

    n = 1 << 21  # one 2,097,152-lane pass of the main path
    n_sl, h, w = cdf_cond.shape
    gen = torch.Generator(device=dev).manual_seed(2)

    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    # u is the second column of the (N, 2) sample, as bounce_shade passes it
    u = torch.rand((n, 2), generator=gen, device=dev)[:, 1]
    u[: n // 8] = 0.0
    u[n // 8: n // 4] = 1.0 - 1e-7
    args = (ints(n_sl), u, ints(h), ints(h), ints(w), ints(h), ints(w))
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    got = k2.cond_sample_pdf(cdf_cond, *args, valid)
    want = k2.cond_sample_pdf_plain(cdf_cond, *args, valid)
    torch.cuda.synchronize()
    err, differ = check_k2(got, want, w)
    ms = _time_ms(lambda: k2.cond_sample_pdf(cdf_cond, *args, valid))
    plain_ms = _time_ms(lambda: k2.cond_sample_pdf_plain(cdf_cond, *args, valid))
    bound_ms, bound_by = k2_bound(cdf_cond, *args, valid)
    print(f"K2 cond_sample: {n} lanes, cells equal, {differ} lanes not bit-equal, "
          f"max abs err {err:.3e} (rtol {K2_RTOL}, atol {K2_ATOL}); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, lanes_not_bit_equal=differ)


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


def check_k3(cs, r):
    """K3 against its plain version on rays r: hit/miss equal, prims equal
    on >= K3_PRIM_AGREE of hits, t bit-equal where they agree (within
    K3_T_RTOL where not), u, v and fields equal where they agree. Returns
    (max abs t err, prim agreement, hit share, the kernel's outputs)."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    t, prim, u, v, g = cl.intersect(cs, r)
    t_p, u_p, v_p, fld_p = cl.intersect_plain(cs, r)
    torch.cuda.synchronize()
    prim_p = fld_p[:, cl.F_PRIM].long()
    hit, hit_p = prim >= 0, prim_p >= 0
    if not torch.equal(hit, hit_p):
        raise AssertionError(f"K3: hit/miss differs on {int((hit != hit_p).sum())} lanes")
    same = hit & (prim == prim_p)
    n_hit = int(hit.sum())
    prim_agree = int(same.sum()) / n_hit if n_hit else 1.0
    if not prim_agree >= K3_PRIM_AGREE:
        raise AssertionError(f"K3: prims agree on {prim_agree:.5f} of hits")
    if not torch.equal(t[same], t_p[same]):
        raise AssertionError("K3: t differs from the plain version's on a lane with the same prim")
    rel = ((t - t_p).abs() / t_p.abs())[hit & ~same]
    if rel.numel() and not float(rel.max()) <= K3_T_RTOL:
        raise AssertionError(f"K3: max rel t error {float(rel.max()):.3e} > {K3_T_RTOL}")
    g_p = cl._unpack(t_p, u_p, v_p, fld_p)[4]
    if not (torch.equal(u[same], u_p[same]) and torch.equal(v[same], v_p[same])
            and all(torch.equal(a[same], b[same]) for a, b in zip(g, g_p))):
        raise AssertionError("K3: u, v or winner fields differ from the plain version's")
    abs_err = float((t - t_p).abs()[hit].max()) if n_hit else 0.0
    return abs_err, prim_agree, n_hit / max(1, t.shape[0]), (t, prim, u, v, g)


def check_k4(cs, r):
    """K4 against its plain version on rays r: equal on every lane."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    occ = cl.occluded(cs, r)
    occ_p = cl.occluded_plain(cs, r)
    torch.cuda.synchronize()
    if not torch.equal(occ, occ_p):
        raise AssertionError(f"K4: occlusion differs on {int((occ != occ_p).sum())} lanes")
    return occ


def _sub(ray, k):
    from mitsuba_customization_tpu_torch.render.records import Ray

    return Ray(ray.o[:k], ray.d[:k], ray.maxt[:k])


def phase_k3(scene, ray):
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    cs = scene.clusters
    n_all = ray.o.shape[0]
    n, plain_s = _plain_span(lambda k: cl.intersect_plain(cs, _sub(ray, k)), n_all)
    r = _sub(ray, n)
    abs_err, prim_agree, hits, out = check_k3(cs, r)
    ms = _time_ms(lambda: cl.intersect(cs, r))
    plain_ms = _time_ms(lambda: cl.intersect_plain(cs, r))
    bound_ms, bound_by = k3_bound(cs, r, out[0], out[1])
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"K3 cluster_closest: {n} lanes ({which} of {n_all}), hits {hits:.4f}, "
          f"hit/miss equal, max t err {abs_err:.3e}, prim agreement "
          f"{prim_agree:.6f}, u/v/fields equal on agreeing prims; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    stats = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
    return stats, out + (r,)


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
    cs = scene.clusters
    n, plain_s = _plain_span(lambda k: cl.occluded_plain(cs, _sub(ray, k)), n_all)
    rs = _sub(ray, n)
    occ = check_k4(cs, rs)
    if bool(occ[(lane[:n] % 4) == 0].any()):
        raise AssertionError("K4: a lane with maxt = 0 is occluded")
    ms = _time_ms(lambda: cl.occluded(cs, rs))
    plain_ms = _time_ms(lambda: cl.occluded_plain(cs, rs))
    bound_ms, bound_by = k4_bound(cs, rs, occ)
    live = float((rs.maxt > 0).float().mean())
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"K4 cluster_shadow: {n} lanes ({which} of {n_all}), live "
          f"{live:.4f}, occluded {float(occ.float().mean()):.4f}, equal on every "
          f"lane; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def record_wavefronts(scene, spp, seed):
    """Render `scene` once and keep the inputs of every K1-K4 call, in call
    order: {"K3": [Ray], "K4": [Ray], "K1": [args], "K2": [args]}. The K3
    and K4 calls are recorded by wrappers set on this Scene object, the K1
    and K2 calls by wrapping their module functions for this render."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render.records import Ray

    rec = {"K1": [], "K2": [], "K3": [], "K4": []}
    ray_intersect, ray_test = scene.ray_intersect, scene.ray_test
    k1_fn, k2_fn = k1.eval_trilinear, k2.cond_sample_pdf

    def keep_ray(ray):
        return Ray(*(t.clone() for t in cl._rays(ray)))

    def keep_args(args, shared):  # the tables (first `shared`) are not copied
        return args[:shared] + tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args[shared:])

    def rec_intersect(ray):
        rec["K3"].append(keep_ray(ray))
        return ray_intersect(ray)

    def rec_test(ray):
        rec["K4"].append(keep_ray(ray))
        return ray_test(ray)

    def rec_k1(*args):
        rec["K1"].append(keep_args(args, 1))  # the table
        return k1_fn(*args)

    def rec_k2(*args):
        rec["K2"].append(keep_args(args, 1))  # the CDF stack
        return k2_fn(*args)

    scene.ray_intersect, scene.ray_test = rec_intersect, rec_test
    k1.eval_trilinear, k2.cond_sample_pdf = rec_k1, rec_k2
    try:
        mt.render(scene, spp=spp, seed=seed)
        torch.cuda.synchronize()
    finally:
        del scene.ray_intersect, scene.ray_test
        k1.eval_trilinear, k2.cond_sample_pdf = k1_fn, k2_fn
    return rec


def phase_bounces(scene, rec):
    """Check and time every recorded K1-K4 call of one matpreview render,
    one line per bounce; returns {kernel: (frame ms, frame bound ms)}."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    cs = scene.clusters
    total = {k: [0.0, 0.0] for k in ("K1", "K2", "K3", "K4")}
    for b in range(max(len(v) for v in rec.values())):
        parts = []
        if b < len(rec["K3"]):
            r = rec["K3"][b]
            out = check_k3(cs, r)[3]
            ms = _time_ms(lambda: cl.intersect(cs, r))
            bound, by = k3_bound(cs, r, out[0], out[1])
            parts.append(f"K3 {r.o.shape[0]} lanes, {int((r.maxt > 0).sum())} live, "
                         f"{ms:.4f} ms (bound {bound:.5f}, {by})")
            total["K3"][0] += ms
            total["K3"][1] += bound
        if b < len(rec["K4"]):
            r = rec["K4"][b]
            occ = check_k4(cs, r)
            ms = _time_ms(lambda: cl.occluded(cs, r))
            bound, by = k4_bound(cs, r, occ)
            parts.append(f"K4 {r.o.shape[0]} lanes, {int((r.maxt > 0).sum())} live, "
                         f"{int(occ.sum())} occluded, {ms:.4f} ms (bound {bound:.5f}, {by})")
            total["K4"][0] += ms
            total["K4"][1] += bound
        if b < len(rec["K1"]):
            args = rec["K1"][b]
            wi, _, _, mask = lanes = k1.concat_halves(*args[1:])
            got = k1.eval_trilinear(*args)
            want = k1.eval_trilinear_plain(args[0], *lanes)
            torch.cuda.synchronize()
            _check_close("K1", got, want, K1_RTOL, K1_ATOL)
            ms = _time_ms(lambda: k1.eval_trilinear(*args))
            bound = k1_bound(*args)[0]
            live = wi.shape[0] if mask is None else int(mask.sum())
            parts.append(f"K1 {wi.shape[0]} lanes, {live} live, {ms:.4f} ms "
                         f"(bound {bound:.4f})")
            del lanes, wi, mask
            total["K1"][0] += ms
            total["K1"][1] += bound
        if b < len(rec["K2"]):
            args = rec["K2"][b]
            got = k2.cond_sample_pdf(*args)
            want = k2.cond_sample_pdf_plain(*args)
            torch.cuda.synchronize()
            differ = check_k2(got, want, args[0].shape[-1])[1]
            ms = _time_ms(lambda: k2.cond_sample_pdf(*args))
            bound = k2_bound(*args)[0]
            parts.append(f"K2 {args[-1].shape[0]} lanes, {int(args[-1].sum())} live, "
                         f"{differ} not bit-equal, {ms:.4f} ms (bound {bound:.4f})")
            total["K2"][0] += ms
            total["K2"][1] += bound
        print(f"bounce {b}: " + "; ".join(parts))
    print("frame sums over the recorded calls: " + ", ".join(
        f"{k} {ms:.4f} ms (bound {bound:.4f})" for k, (ms, bound) in total.items()))
    return {k: tuple(v) for k, v in total.items()}


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
    rec = record_wavefronts(mp_scene, 8, seed=1)
    n_calls = {k: len(v) for k, v in rec.items()}
    if n_calls != mp_launches:
        raise AssertionError(f"recorded calls {n_calls} != launches {mp_launches}")
    frame = phase_bounces(mp_scene, rec)
    del rec
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
    for k, key in zip(kernels, ("K1", "K2", "K3", "K4")):
        k.update(share=k["bound_ms"] / k["ms"], frame_ms=frame[key][0],
                 frame_bound_ms=frame[key][1],
                 frame_share=frame[key][1] / frame[key][0], library_ms=None)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
