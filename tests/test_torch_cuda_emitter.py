"""The emitter stage's CUDA kernels (ops/emitter_shade: emitter_hit,
emitter_sample, emitter_nee) against the plain route, on a GPU.

Each test records the stage's calls of a render (render/emitters hit_term,
sample_nee, nee_term) and runs each on both routes: the kernels' outputs
against the plain route's same quantities (chip_smoke.emitter_terms and
check_emitter_stage: masks and zero patterns exact, floats within the BSDF
stage's tolerances), an independent sampler's draws in the kernel against
its next_1d's (check_emitter_draws, bit for bit), and each part's result
against its _*_plain function. Needs an NVIDIA Hopper GPU and nvcc; skips
without one. Imports no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_emitter.py
"""

import pytest
import torch

from chip_smoke import (
    BSDF_RTOL,
    EM_FUNCTIONS,
    _keep_emitter,
    check_emitter_draws,
    check_emitter_stage,
    emitter_terms,
    record_calls,
)
from emitter_scenes import emitters_dict
from mitsuba_customization_tpu_torch.ops import emitter_shade
from mitsuba_customization_tpu_torch.render import emitters as em
from mitsuba_customization_tpu_torch.utils import log

pytestmark = pytest.mark.cuda

LANES = 2_097_152  # bounce 0 of the 512x512, 8 spp frame


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _counts():
    return {k: v for k, v in log.Statistics.get().counters.items() if k.startswith("emitter.")}


def _routes_since(before):
    c = _counts()
    return {k for k in c if c[k] != before.get(k, 0)}


def _recorded(scene, spp, seed=1):
    import mitsuba_customization_tpu_torch as mt

    return record_calls(lambda: mt.render(scene, spp=spp, seed=seed),
                        {part: (em, fn, _keep_emitter) for part, fn in EM_FUNCTIONS.items()})


def _check_calls(rec, n_calls=None):
    """Every recorded call (the first n_calls of each part): one launch of
    its kernel, its outputs against the plain route's, the draws, and the
    part's result against its plain function's within BSDF_RTOL."""
    for part, calls in rec.items():
        assert calls, part
        fn = getattr(em, EM_FUNCTIONS[part])
        plain = getattr(em, f"_{EM_FUNCTIONS[part]}_plain")
        for args in calls[:n_calls]:
            before = dict(emitter_shade.LAUNCHES)
            got = emitter_terms(part, args, True)
            torch.cuda.synchronize()
            assert {k: emitter_shade.LAUNCHES[k] - before[k] for k in before} == {
                k: int(k == part) for k in before}
            check_emitter_stage(part, got, emitter_terms(part, args, False))
            if part == "sample":
                check_emitter_draws(args)
            results = [f(*(a.clone() if hasattr(a, "ARRAYS") else a for a in args))
                       for f in (fn, plain)]
            if part == "sample":  # (DirectionSample, wo_local, nee_ok)
                results = [(*r[0], *r[1:]) for r in results]
            else:  # L
                results = [(r,) for r in results]
            for g, w in zip(*results):
                if g.dtype == torch.bool:
                    assert torch.equal(g, w)
                    continue
                fin = torch.isfinite(w)
                assert torch.equal(torch.isfinite(g), fin) and torch.equal(g[~fin], w[~fin])
                close = (g - w).abs()[fin] <= BSDF_RTOL * w.abs()[fin] + 1e-6
                assert int((~close).sum()) <= 1e-4 * close.numel()


def test_fused_parts_match_plain_on_the_matpreview_frame(dev):
    """The 512x512, 8 spp, depth 8 matpreview frame's bounces 0 and 1
    (2,097,152 lanes each: no compaction schedule): every part on the fused
    route against the plain route."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    scene = mt.load_dict(matpreview_dict(512, 8, 8), dev)
    rec = _recorded(scene, 8)
    assert rec["hit"][0][2].p.shape[0] == LANES
    _check_calls(rec, n_calls=2)


@pytest.mark.parametrize("which", ["shapes", "area", "constant"])
def test_fused_parts_match_plain_on_other_tables(dev, which):
    """Emissive spheres, cylinders and a 320-triangle mesh (prim rows
    searched) beside the rectangle and the sky; area lights alone; the sky
    alone: every call of a 256x256, 4 spp, depth 5 frame."""
    import mitsuba_customization_tpu_torch as mt

    scene = mt.load_dict(emitters_dict(which, 256, 4, 5, n_sub=3), dev)
    _check_calls(_recorded(scene, 4, seed=3))


def _rel_l2(a, b):
    return float((a - b).double().norm() / b.double().norm())


def _ad_scene(name, dev):
    """64x64 AD steps as the benchmark's AD cells run them: matpreview (the
    tables and the floor's alpha) and volpath (the tables and the media,
    whose NEE points at medium interactions carry a graph: its sample part
    takes the plain route)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import (
        matpreview_dict,
        probe_compact_schedule,
        volpath_dict,
    )

    if name == "matpreview":
        scene, _ = probe_compact_schedule(mt.load_dict(matpreview_dict(64, 4, 6, n_sub=3), dev))
        keys = ("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u")
        routes = {"emitter.fused/hit", "emitter.fused/sample", "emitter.fused/nee"}
    else:
        scene = mt.load_dict(volpath_dict(64, 4, 4, grid_res=32, n_sub=3), dev)
        keys = ("bsdf.tabulated.table", "medium.sigma_t", "medium.albedo", "medium.phase_g",
                "medium.density")
        routes = {"emitter.fused/hit", "emitter.plain/sample", "emitter.fused/nee"}
    full = traverse(scene)
    return scene, {k: full[k] for k in keys}, routes


@pytest.mark.parametrize("scene_name", ["matpreview", "volpath"])
def test_grad_render_fused_matches_plain(dev, monkeypatch, scene_name):
    """grad_render's eager step at 64x64 (_ad_scene) with the emitter
    stage's routes as the program picks them, and with the three parts
    swapped for their plain functions: the loss within 1e-5 and every
    gradient within three times the spread of four plain steps at the same
    seed (1e-5 at least)."""
    from mitsuba_customization_tpu_torch.render import ad

    scene, params, want_routes = _ad_scene(scene_name, dev)
    target = torch.zeros((64, 64, 3), device=dev)
    before = _counts()
    fused = ad._eager_loss_and_grad(scene, params, target, 4, 3)
    assert _routes_since(before) == want_routes
    for fn in EM_FUNCTIONS.values():
        monkeypatch.setattr(em, fn, getattr(em, f"_{fn}_plain"))
    plain = [ad._eager_loss_and_grad(scene, params, target, 4, 3) for _ in range(4)]
    torch.cuda.synchronize()
    assert abs(float(fused[0]) - float(plain[0][0])) <= 1e-5 * abs(float(plain[0][0]))
    for k in params:
        want = plain[0][1][k]
        spread = max(_rel_l2(a[1][k], b[1][k]) for i, a in enumerate(plain)
                     for b in plain[:i])
        assert bool((want != 0).any()), k
        assert _rel_l2(fused[1][k], want) <= max(3 * spread, 1e-5), (k, spread)


def test_render_jit_routes_and_image(dev, monkeypatch):
    """The 128x128, 4 spp, depth 8 matpreview frame through render_jit (the
    captured frame): every call of the three parts (the warm-up's and the
    capture's) on the fused route, none plain; the image within 1e-5
    summed relative gap of the frame with the parts swapped for their
    plain functions."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph, integrator
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    scene = mt.load_dict(matpreview_dict(128, 4, 8, compact=(1.0, 0.8, 0.5)), dev)
    frame_graph.clear()
    before = _counts()
    fused = integrator.render_jit(scene, 4, 7).clone()
    c = _counts()
    got = {k: c[k] - before.get(k, 0) for k in _routes_since(before)}
    # two bodies run (warm-up, capture): 8 bounces, NEE at the first 7
    assert got == {"emitter.fused/hit": 16, "emitter.fused/sample": 14,
                   "emitter.fused/nee": 14}
    frame_graph.clear()
    for fn in EM_FUNCTIONS.values():
        monkeypatch.setattr(em, fn, getattr(em, f"_{fn}_plain"))
    plain = integrator.render_jit(scene, 4, 7).clone()
    frame_graph.clear()
    assert bool(torch.isfinite(fused).all())
    assert float((fused - plain).abs().sum() / plain.abs().sum()) <= 1e-5
