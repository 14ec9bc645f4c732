"""The port's entry points, the BSDF dispatch's eval / pdf / sample /
eval_pdf / bounce_shade (with `uv` in its place), and make_sensor,
sample_ray, make_sampler, the film's splat and develop and the mesh
readers take their positional arguments in the JAX package's order, so a call written for the reference
means the same to the port: each port signature's positional parameters
are a prefix, by name and order, of the reference's; a reference-style
positional call renders what its keywords say; what the port does not
have yet raises and names its ROADMAP item; load_dict's device defaults to
the card.
"""

import inspect

import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.models import bsdf as jbsdf
from mitsuba_customization_tpu.render import ad as jad
from mitsuba_customization_tpu.render import integrator as jint
from mitsuba_customization_tpu.models import phase as jphase
from mitsuba_customization_tpu.render import bdpt as jbdpt
from mitsuba_customization_tpu.render import emitters as jem
from mitsuba_customization_tpu.render import medium as jmedium
from mitsuba_customization_tpu.render import ptracer as jpt
from mitsuba_customization_tpu_torch.models import phase as tphase
from mitsuba_customization_tpu_torch.render import bdpt as tbdpt
from mitsuba_customization_tpu_torch.render import emitters as tem
from mitsuba_customization_tpu_torch.render import medium as tmedium
from mitsuba_customization_tpu_torch.render import ptracer as tpt
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.render import ad as tad
from mitsuba_customization_tpu_torch.render import integrator as tint
from mitsuba_customization_tpu.core import sampler as jsampler
from mitsuba_customization_tpu.render import film as jfilm
from mitsuba_customization_tpu.render import sensors as jsensors
from mitsuba_customization_tpu.utils import obj as jobj
from mitsuba_customization_tpu.utils import ply as jply
from mitsuba_customization_tpu.utils import serialized as jser
from mitsuba_customization_tpu_torch.core import sampler as tsampler
from mitsuba_customization_tpu_torch.render import film as tfilm
from mitsuba_customization_tpu_torch.render import sensors as tsensors
from mitsuba_customization_tpu_torch.utils import obj as tobj
from mitsuba_customization_tpu_torch.utils import ply as tply
from mitsuba_customization_tpu_torch.utils import serialized as tser
from mitsuba_customization_tpu import api as japi
from mitsuba_customization_tpu import cli as jcli
from mitsuba_customization_tpu.core import distr as jdistr
from mitsuba_customization_tpu.models import tabulated as jtab
from mitsuba_customization_tpu.models import texture as jtex
from mitsuba_customization_tpu.parallel import mesh as jmesh
from mitsuba_customization_tpu.render import scene as jscene
from mitsuba_customization_tpu.render import xml as jxml
from mitsuba_customization_tpu.utils import checkpoint as jckpt
from mitsuba_customization_tpu.utils import chi2 as jchi2
from mitsuba_customization_tpu_torch import api as tapi
from mitsuba_customization_tpu_torch import cli as tcli
from mitsuba_customization_tpu_torch.core import distr as tdistr
from mitsuba_customization_tpu_torch.models import tabulated as ttab
from mitsuba_customization_tpu_torch.models import texture as ttex
from mitsuba_customization_tpu_torch.parallel import mesh as tmesh
from mitsuba_customization_tpu_torch.render import scene as tscene
from mitsuba_customization_tpu_torch.render import xml as txml
from mitsuba_customization_tpu_torch.utils import checkpoint as tckpt
from mitsuba_customization_tpu_torch.utils import chi2 as tchi2
from mitsuba_customization_tpu_torch.scenes import flagship_dict
from test_torch_kernels import one_torch_thread  # noqa: F401

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in _POSITIONAL]


@pytest.mark.parametrize("port, ref", [
    (tint.render, jint.render),
    (tint.trace_volpath, jint.trace_volpath),
    (tphase.eval, jphase.eval),
    (tphase.sample, jphase.sample),
    (tmedium.sample_interaction, jmedium.sample_interaction),
    (tmedium.transmittance, jmedium.transmittance),
    (tmedium.sigma_t_at, jmedium.sigma_t_at),
    (tmedium.build_table, jmedium.build_table),
    (tmedium.recompute_majorant, jmedium.recompute_majorant),
    (tpt.connect_sensor, jpt.connect_sensor),
    (tpt.sample_emitter_ray, jpt.sample_emitter_ray),
    (tpt.trace_light_paths, jpt.trace_light_paths),
    (tpt.render_ptracer, jpt.render_ptracer),
    (tbdpt.trace_eye_bdpt, jbdpt.trace_eye_bdpt),
    (tbdpt.trace_light_bdpt, jbdpt.trace_light_bdpt),
    (tbdpt.render_bdpt, jbdpt.render_bdpt),
    (tem.pdf_hit_area, jem.pdf_hit_area),
    (tint.render_lanes, jint.render_lanes),
    (tad.render_ad, jad.render_ad),
    (tad.grad_render, jad.grad_render),
    (tad.optimize, jad.optimize),
    (tad.Optimizer.__init__, jad.Optimizer.__init__),
    (tbsdf.eval, jbsdf.eval),
    (tbsdf.pdf, jbsdf.pdf),
    (tbsdf.sample, jbsdf.sample),
    (tbsdf.eval_pdf, jbsdf.eval_pdf),
    (tbsdf.bounce_shade, jbsdf.bounce_shade),
    (tsensors.make_sensor, jsensors.make_sensor),
    (tsensors.sample_ray, jsensors.sample_ray),
    (tsampler.make_sampler, jsampler.make_sampler),
    (tfilm.splat, jfilm.splat),
    (tfilm.develop, jfilm.develop),
    (tobj.read_obj, jobj.read_obj),
    (tply.read_ply, jply.read_ply),
    (tser.read_serialized, jser.read_serialized),
    (ttex.build_stack, jtex.build_stack),
    (ttab.eval_f, jtab.eval_f),
    (tint.trace_paths, jint.trace_paths),
    (tdistr.DiscreteDistribution.sample_reuse, jdistr.DiscreteDistribution.sample_reuse),
    (tdistr.DiscreteDistribution.eval_pmf, jdistr.DiscreteDistribution.eval_pmf),
    (tapi.render, jint.render),
    (tapi.traverse, japi.traverse),
    (txml.load_file, jxml.load_file),
    (txml.parse_file, jxml.parse_file),
    (tcli.main, jcli.main),
    (tchi2.ChiSquareTest.__init__, jchi2.ChiSquareTest.__init__),
    (tchi2.PlanarDomain.__init__, jchi2.PlanarDomain.__init__),
    (tckpt.save_checkpoint, jckpt.save_checkpoint),
    (tckpt.load_checkpoint, jckpt.load_checkpoint),
    (tckpt.latest_step, jckpt.latest_step),
    (tmesh.make_mesh, jmesh.make_mesh),
    (tmesh.make_mesh_2level, jmesh.make_mesh_2level),
    (tmesh._check_divisible, jmesh._check_divisible),
    (tmesh.render_sharded, jmesh.render_sharded),
    (tmesh.loss_and_grad_sharded, jmesh.loss_and_grad_sharded),
    (tmesh.initialize_distributed, jmesh.initialize_distributed),
    (tint.render_jit, jint.render_jit),
    (tmesh.render_sharded_jit, jmesh.render_sharded_jit),
    (tad._loss_and_grad, jad._loss_and_grad),
    (tmesh.loss_and_grad_sharded_jit, jmesh.loss_and_grad_sharded_jit),
], ids=["render", "trace_volpath", "phase.eval", "phase.sample",
        "sample_interaction", "transmittance", "sigma_t_at", "build_table",
        "recompute_majorant", "connect_sensor", "sample_emitter_ray", "trace_light_paths",
        "render_ptracer", "trace_eye_bdpt", "trace_light_bdpt", "render_bdpt",
        "pdf_hit_area", "render_lanes", "render_ad", "grad_render", "optimize", "Optimizer",
        "bsdf.eval", "bsdf.pdf", "bsdf.sample", "bsdf.eval_pdf", "bsdf.bounce_shade",
        "make_sensor", "sample_ray", "make_sampler", "film.splat", "film.develop",
        "read_obj", "read_ply", "read_serialized", "texture.build_stack", "tabulated.eval_f",
        "trace_paths", "sample_reuse", "eval_pmf", "api.render", "api.traverse",
        "xml.load_file", "xml.parse_file", "cli.main", "ChiSquareTest", "PlanarDomain",
        "save_checkpoint", "load_checkpoint", "latest_step", "make_mesh", "make_mesh_2level",
        "_check_divisible", "render_sharded", "loss_and_grad_sharded",
        "initialize_distributed", "render_jit", "render_sharded_jit", "_loss_and_grad",
        "loss_and_grad_sharded_jit"])
def test_positional_parameters_are_a_prefix_of_the_references(port, ref):
    ours, theirs = _positional(port), _positional(ref)
    assert ours == theirs[:len(ours)], (ours, theirs)
    # and each keyword the port shares with the reference has its default
    ref_params = inspect.signature(ref).parameters
    for name, p in inspect.signature(port).parameters.items():
        if name in ref_params and p.default is not inspect.Parameter.empty \
                and ref_params[name].default is not inspect.Parameter.empty:
            assert p.default == ref_params[name].default, name


def test_reference_style_positional_call():
    """render(scene, 4, 0, None, 3) is spp 4, seed 0, the scene's own
    integrator and depth 3, as in the reference: the image (no stats
    tuple) of render(scene, spp=4, seed=0, max_depth=3), bit for bit, and
    not the scene's depth-5 image; return_stats in seventh place."""
    scene = mt.load_dict(flagship_dict(16, 4, 5), "cpu")
    got = tint.render(scene, 4, 0, None, 3)
    assert torch.is_tensor(got) and got.shape == (16, 16, 3)
    assert torch.equal(got, tint.render(scene, spp=4, seed=0, max_depth=3))
    assert not torch.equal(got, tint.render(scene, spp=4, seed=0))
    img, stats = tint.render(scene, 4, 0, "path", 3, False, True)
    assert torch.equal(img, got) and stats["rays_traced"] > 0
    L, film_xy, st = tint.render_lanes(scene, 4, 0, {"type": "path"}, 3)
    assert L.shape == (16 * 16 * 4, 3) and film_xy.shape == (16 * 16 * 4, 2)


def test_unported_integrators_and_optimizers_raise():
    """The integrators of item 14b (refused by the earlier port) render
    from a reference-style positional call: render(scene, 1, 0,
    "ptracer") is render_ptracer's frame, {"type": "volpath"} the
    volumetric tracer's (on a scene without media, the path tracer's
    lanes), and render_lanes traces them as the JAX package does. Since
    item 16 the optimizer in third place is a torch.optim class or a
    factory; anything else (an optax-style name) raises TypeError."""
    from mitsuba_customization_tpu_torch.render.ptracer import render_ptracer

    scene = mt.load_dict(flagship_dict(8, 1, 2), "cpu")
    assert torch.equal(tint.render(scene, 1, 0, "ptracer"), render_ptracer(scene, 1, 0))
    vol = tint.render(scene, 1, 0, {"type": "volpath"})
    assert vol.shape == (8, 8, 3) and bool(torch.isfinite(vol).all())
    for integrator in ("ptracer", {"type": "volpath"}):
        L, film_xy, _ = tint.render_lanes(scene, 1, 0, integrator)
        assert L.shape == (64, 3) and film_xy.shape == (64, 2)
    with pytest.raises(TypeError, match="optimizer"):
        tad.Optimizer({"x": torch.zeros(1)}, 0.01, "sgd")
    assert isinstance(tad.Optimizer({"x": torch.zeros(1)}, 0.01, torch.optim.SGD).opt,
                      torch.optim.SGD)
    opt = tad.Optimizer({"x": torch.ones(1)}, 0.5, None, ["x"])
    assert opt.clip_nonneg == {"x"}


def test_load_dict_defaults_to_the_card():
    """load_dict(d), written as for the reference, runs on the card: the
    device defaults to "cuda", and without a card the call raises rather
    than building the scene on the CPU."""
    assert inspect.signature(mt.load_dict).parameters["device"].default == "cuda"
    d = flagship_dict(8, 1, 2)
    if torch.cuda.is_available():
        assert mt.load_dict(d).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            mt.load_dict(d)


def test_scene_config_fields_are_the_references():
    """SceneConfig has the JAX package's fields in its order (use_bvh
    included), so a positional construction means the same; use_bvh=True
    (the skip-link BVH, render/bvh.py) constructs."""
    import dataclasses

    ours = [f.name for f in dataclasses.fields(tscene.SceneConfig)]
    assert ours == [f.name for f in dataclasses.fields(jscene.SceneConfig)]
    cfg = tscene.SceneConfig(8, 4, 2, 3, 5, "direct", "independent", "gaussian", False,
                             "cluster", True, 2.0, False)
    assert (cfg.integrator, cfg.rfilter, cfg.intersector, cfg.hide_emitters,
            cfg.sensor_scale, cfg.nee) == ("direct", "gaussian", "cluster", True, 2.0, False)
    cfg = tscene.SceneConfig(use_bvh=True, intersector="bvh")
    assert cfg.use_bvh and cfg.intersector == "bvh"


def test_reference_style_calls_of_the_repaired_entry_points():
    """build_stack(rows, attr), eval_f(..., mask, coherent), trace_paths(...,
    ad_mode, coherent0, compact_caps), sample_reuse / eval_pmf(slice_=)
    and render_lanes(..., ad_mode, lane_offset, n_lanes) as the reference
    calls them: coherent and coherent0 change nothing, and a lane range is
    those lanes of the whole frame."""
    import numpy as np

    from mitsuba_customization_tpu_torch.core.sampler import make_sampler
    from mitsuba_customization_tpu_torch.render.sensors import sample_ray

    rows = [{"type": ttex.CHECKERBOARD, "value0": (1, 0, 0), "value1": (0, 1, 0)}]
    attr = np.ones((1, 9), np.float32)
    st = ttex.build_stack(rows, attr, device="cpu")
    assert torch.equal(st.attr, torch.as_tensor(attr))

    scene = mt.load_dict(flagship_dict(8, 2, 3), "cpu")
    tab = scene.bsdfs.stacks[tbsdf.TABULATED]
    wi = torch.nn.functional.normalize(torch.rand(16, 3) + 0.1, dim=-1)
    wo = torch.nn.functional.normalize(torch.rand(16, 3) + 0.1, dim=-1)
    slot = torch.zeros(16, dtype=torch.int64)
    assert torch.equal(ttab.eval_f(tab, wi, wo, slot, None, True),
                       ttab.eval_f(tab, wi, wo, slot))

    n = 8 * 8 * 2
    lanes = torch.arange(n)
    smp = make_sampler("independent", 0, lanes // 2, lanes % 2, 2)
    film = torch.rand(n, 2)
    ray = sample_ray(scene.sensor, film, None, 1.0)
    a = tint.trace_paths(scene, ray, smp, 3, 5, False, False, True, None)[0]
    b = tint.trace_paths(scene, ray, smp, 3, 5, False)[0]
    assert torch.equal(a, b)

    em = scene.emitters
    u = torch.rand(32)
    assert torch.equal(em.select.sample_reuse(u, slice_=None)[0], em.select.sample_reuse(u)[0])

    full = tint.render_lanes(scene, 2, 0, None, None, False)[0]
    part = tint.render_lanes(scene, 2, 0, None, None, False, 40, 24, None, None, True)[0]
    assert torch.equal(part, full[40:64])
