"""The BSDF stage's CUDA kernels (ops/bsdf_shade: bsdf_shade_pre and
bsdf_shade_post around K1 and K2) against the plain route, on a GPU.

Each test calls the plain route's functions directly on the same CUDA
tensors (models/bsdf._bounce_shade_plain; a render's bounce_shade swapped
for it), with no switch in the program, and holds the two with
chip_smoke.check_bsdf_stage (its tolerances and why). Needs an NVIDIA
Hopper GPU and nvcc; skips without one. Imports no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_bsdf.py
"""

import pytest
import torch

from bsdf_lanes import MATERIALS, lanes, mixed_table
from chip_smoke import check_bsdf_stage
from mitsuba_customization_tpu_torch.models import bsdf
from mitsuba_customization_tpu_torch.ops import bsdf_shade
from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

pytestmark = pytest.mark.cuda

LANES = 2_097_152  # bounce 0 of the 512x512, 8 spp frame


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _matpreview_table(dev):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    return mt.load_dict(matpreview_dict(64, 1, 8), dev).bsdfs


@pytest.mark.parametrize("table_name", ["matpreview", "mixed"])
@pytest.mark.parametrize("variant", ["masks", "no_sample1", "no_nee", "no_masks"])
def test_fused_bsdf_stage_matches_plain(dev, table_name, variant):
    """bounce_shade's fused route at bounce 0's width on the matpreview
    scene's table (ten MERL tables, the GGX floor, the light's diffuse)
    and on bsdf_lanes.mixed_table (Beckmann, plastic on the plain route,
    null lanes): dead lanes, unlit NEE lanes, wi below the horizon. One
    launch each of bsdf_shade_pre, K2, bsdf_shade_post and K1 a call."""
    table = _matpreview_table(dev) if table_name == "matpreview" else mixed_table(dev)
    d = lanes(dev, LANES, table.mat_type.shape[0], seed=11)
    s1 = None if variant == "no_sample1" else d["sample1"]
    kw = (dict(active=None, nee_mask=None) if variant == "no_masks"
          else dict(active=d["active"], nee_mask=d["nee_mask"]))
    args = (table, d["mat_id"], d["wi"], d["wo_nee"], d["sample2"], s1, None, False,
            variant != "no_nee")
    before = dict(bsdf_shade.LAUNCHES), k1.LAUNCHES, k2.LAUNCHES
    got = bsdf.bounce_shade(*args, **kw)
    torch.cuda.synchronize()
    assert (bsdf_shade.LAUNCHES["pre"] - before[0]["pre"],
            bsdf_shade.LAUNCHES["post"] - before[0]["post"],
            k1.LAUNCHES - before[1], k2.LAUNCHES - before[2]) == (1, 1, 1, 1)
    check_bsdf_stage(got, bsdf._bounce_shade_plain(*args, **kw))


def test_fused_bsdf_stage_without_tabulated_lanes(dev):
    """A table of analytic kernels only: bsdf_shade_pre alone, no K1 / K2."""
    table = mixed_table(dev)
    stacks = {k: v for k, v in table.stacks.items() if k != bsdf.TABULATED}
    keep = [i for i, (k, _) in enumerate(MATERIALS) if k != bsdf.TABULATED]
    table = table._replace(stacks=stacks, mat_type=table.mat_type[keep],
                           mat_slot=table.mat_slot[keep])
    d = lanes(dev, 1 << 20, len(keep), seed=5)
    args = (table, d["mat_id"], d["wi"], d["wo_nee"], d["sample2"], d["sample1"])
    kw = dict(active=d["active"], nee_mask=d["nee_mask"])
    before = dict(bsdf_shade.LAUNCHES), k1.LAUNCHES, k2.LAUNCHES
    got = bsdf.bounce_shade(*args, **kw)
    torch.cuda.synchronize()
    assert (bsdf_shade.LAUNCHES["pre"] - before[0]["pre"],
            bsdf_shade.LAUNCHES["post"] - before[0]["post"],
            k1.LAUNCHES - before[1], k2.LAUNCHES - before[2]) == (1, 0, 0, 0)
    check_bsdf_stage(got, bsdf._bounce_shade_plain(*args, **kw))


def _rel_l2(a, b):
    return float((a - b).double().norm() / b.double().norm())


def _ad_scene(name, dev):
    """64x64 AD steps as the benchmark's AD cells run them: matpreview (the
    table stack and the floor's alpha, which takes the attached route) and
    volpath (the tables and the media; its NEE directions from medium
    interactions carry a graph)."""
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
        routes = {"bsdf.fused/tabulated", "bsdf.attached/roughconductor", "bsdf.fused/diffuse"}
    else:
        scene = mt.load_dict(volpath_dict(64, 4, 4, grid_res=32, n_sub=3), dev)
        keys = ("bsdf.tabulated.table", "medium.sigma_t", "medium.albedo", "medium.phase_g",
                "medium.density")
        routes = {"bsdf.fused/tabulated", "bsdf.fused/roughconductor", "bsdf.fused/diffuse"}
    full = traverse(scene)
    return scene, {k: full[k] for k in keys}, routes


@pytest.mark.parametrize("scene_name", ["matpreview", "volpath"])
def test_grad_render_fused_matches_plain(dev, monkeypatch, scene_name):
    """grad_render's eager step at 64x64 (_ad_scene), on the fused route
    and with bounce_shade swapped for the plain route: the loss within
    1e-5 and every gradient within three times the spread of four
    plain-route steps at the same seed (K1-bwd's, T1-bwd's and
    index_add_'s atomic order; 1e-5 at least, the routes' rounding of the
    tabulated weight)."""
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.utils import log

    scene, params, want_routes = _ad_scene(scene_name, dev)
    target = torch.zeros((64, 64, 3), device=dev)
    stats = log.Statistics.get().counters
    before = dict(stats)
    fused = ad._eager_loss_and_grad(scene, params, target, 4, 3)
    routes = {k for k in stats if k.startswith("bsdf.") and stats[k] != before.get(k, 0)}
    assert routes == want_routes
    monkeypatch.setattr(bsdf, "bounce_shade", bsdf._bounce_shade_plain)
    plain = [ad._eager_loss_and_grad(scene, params, target, 4, 3) for _ in range(4)]
    torch.cuda.synchronize()
    assert abs(float(fused[0]) - float(plain[0][0])) <= 1e-5 * abs(float(plain[0][0]))
    for k in params:
        want = plain[0][1][k]
        spread = max(_rel_l2(a[1][k], b[1][k]) for i, a in enumerate(plain)
                     for b in plain[:i])
        assert bool((want != 0).any()), k
        assert _rel_l2(fused[1][k], want) <= max(3 * spread, 1e-5), (k, spread)


def test_fused_frame_matches_plain(dev, monkeypatch):
    """The 128x128, 4 spp, depth 8 matpreview frame through render_jit (the
    captured frame) on the fused route and with bounce_shade swapped for
    the plain route: images within 1e-5 summed relative gap. Every kernel
    of the scene takes the fused route (the warm-up's and the capture's
    calls count; a replay calls no Python)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph, integrator
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict
    from mitsuba_customization_tpu_torch.utils import log

    scene = mt.load_dict(matpreview_dict(128, 4, 8, compact=(1.0, 0.8, 0.5)), dev)
    frame_graph.clear()
    stats = log.Statistics.get().counters
    before = dict(stats)
    fused = integrator.render_jit(scene, 4, 7).clone()
    routes = {k for k in stats if k.startswith("bsdf.") and stats[k] != before.get(k, 0)}
    assert routes == {"bsdf.fused/tabulated", "bsdf.fused/roughconductor",
                      "bsdf.fused/diffuse"}
    frame_graph.clear()
    monkeypatch.setattr(bsdf, "bounce_shade", bsdf._bounce_shade_plain)
    plain = integrator.render_jit(scene, 4, 7).clone()
    frame_graph.clear()
    assert bool(torch.isfinite(fused).all())
    assert float((fused - plain).abs().sum() / plain.abs().sum()) <= 1e-5
