"""The emitter stage's routes (render/emitters.route): the rule, its
counters, the inputs each part's test reads, and the CPU route, which is
the code the bounce bodies ran before the stage had routes, bit for bit
(the JAX parity tests hold that code to the JAX package). The CUDA kernels
of the fused route are held to the plain route on the card
(tests/test_torch_cuda_emitter.py)."""

import importlib
import pkgutil
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from emitter_scenes import VARIANTS, emitters_dict
from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.ops import build, emitter_shade
from mitsuba_customization_tpu_torch.render import emitters as em
from mitsuba_customization_tpu_torch.render.records import DirectionSample
from mitsuba_customization_tpu_torch.utils import log
from test_torch_bsdf_route import _c_fields
from test_torch_kernels import one_torch_thread  # noqa: F401

A, C, ENV, PT, SPOT, DIR = em.AREA, em.CONSTANT, em.ENVMAP, em.POINT, em.SPOT, em.DIRECTIONAL
F, PL = em.FUSED, em.PLAIN
FUNCTIONS = {"hit": "hit_term", "sample": "sample_nee", "nee": "nee_term"}


@pytest.mark.parametrize("args, want", [
    # (present, device, grad mode, an input requires grad) -> route
    ((frozenset({A, C}), "cuda", False, False), F),
    ((frozenset({A}), "cuda", False, False), F),
    ((frozenset({C}), "cuda", False, False), F),
    ((frozenset(), "cuda", False, False), F),
    ((frozenset({A, C}), "cpu", False, False), PL),
    ((frozenset({A, C}), "cpu", True, True), PL),
    ((frozenset({A, C, ENV}), "cuda", False, False), PL),
    ((frozenset({A, PT}), "cuda", False, False), PL),
    ((frozenset({SPOT}), "cuda", False, False), PL),
    ((frozenset({C, DIR}), "cuda", False, False), PL),
    ((frozenset({A, C}), "cuda", True, False), F),
    ((frozenset({A, C}), "cuda", True, True), PL),
    ((frozenset({A, C}), "cuda", False, True), F),
])
def test_route_rule(args, want):
    assert em.route(*args) == want


# the bounce bodies' emitter code before the stage had routes, as the
# parts' functions take it (hit: integrator._bounce's and _vol_bounce's
# emitter hits; sample: their NEE sample; nee: their NEE term, with a the
# product before the radiance)

def _old_mis(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    w = m.safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(pdf_a > 0.0, w, 0.0)


def _old_hit(table, geom, si, ray, L, thr, prev_pdf, prev_delta, mask):
    hit_rad = em.eval_hit(table, si)
    hit_pdf = em.pdf_hit_direction(table, geom, si, ray.o)
    bg_rad = em.eval_background(table, ray.d)
    bg_pdf = em.pdf_miss_direction(table, ray.d)
    rad = torch.where(si.valid[..., None], hit_rad, bg_rad)
    em_pdf = torch.where(si.valid, hit_pdf, bg_pdf)
    w_mis = torch.where(prev_delta, 1.0, _old_mis(prev_pdf, em_pdf)).detach()
    return L + torch.where(mask[..., None], thr * rad * w_mis[..., None], 0.0)


def _old_sample(table, geom, si, p_ref, smp_nee, mask, depth_ok, refl_only):
    u3 = torch.stack([smp_nee.next_1d(), smp_nee.next_1d(), smp_nee.next_1d()], -1)
    ds = em.sample_direction(table, geom, p_ref, u3)
    wo_local = si.to_local(ds.d)
    nee_ok = mask & (ds.pdf > 0.0) & depth_ok
    if refl_only:
        nee_ok = nee_ok & (m.cos_theta(wo_local) > 0.0)
    return ds, wo_local, nee_ok


def _old_nee(table, ds, pdf_nee, vis, L, a):
    w_nee = torch.where(ds.delta, 1.0, _old_mis(ds.pdf, pdf_nee))
    contrib = a * ds.radiance * m.safe_div(w_nee, ds.pdf).detach()[..., None]
    return L + torch.where(vis[..., None], contrib, 0.0)


OLD = {"hit_term": _old_hit, "sample_nee": _old_sample, "nee_term": _old_nee}


def _counts():
    return {k: v for k, v in log.Statistics.get().counters.items() if k.startswith("emitter.")}


def _diff(before, after):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _scene(which):
    """A 16x16 scene: an emitters_dict variant, or the volpath scene
    ("volpath_env": its sky an envmap, the plain route's, whose radiance
    reads the ray direction)."""
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    if which.startswith("volpath"):
        d = volpath_dict(16, 2, 4, grid_res=8, n_sub=2)
        if which == "volpath_env":
            rng = np.random.default_rng(4)
            d["sky"] = {"type": "envmap",
                        "bitmap": (0.05 + 0.3 * rng.random((8, 16, 3))).astype(np.float32)}
        return mt.load_dict(d, "cpu")
    return mt.load_dict(emitters_dict(which, 16, 2, 4), "cpu")


def _flat(out):
    if isinstance(out, tuple):  # sample: (DirectionSample, wo_local, nee_ok)
        return (*out[0], *out[1:])
    return (out,)


@pytest.mark.parametrize("which", VARIANTS + ("volpath",))
def test_cpu_stage_is_the_old_code(monkeypatch, which):
    """A CPU render takes the plain route in every part and gives the old
    code's image bit for bit; so does each recorded call of the three
    parts, output for output."""
    scene = _scene(which)
    calls = []
    for fn in FUNCTIONS.values():
        orig = getattr(em, fn)

        def recorder(*args, _orig=orig, _fn=fn):
            fresh = [a.clone() if hasattr(a, "ARRAYS") else a for a in args]
            out = _orig(*args)
            calls.append((_fn, fresh, out))
            return out

        monkeypatch.setattr(em, fn, recorder)
    before = _counts()
    routed = mt.render(scene, spp=2, seed=5)
    assert set(_diff(before, _counts())) == {f"emitter.plain/{p}" for p in FUNCTIONS}
    assert {fn for fn, _, _ in calls} == set(FUNCTIONS.values())
    for fn, args, out in calls:
        args = [a.clone() if hasattr(a, "ARRAYS") else a for a in args]
        for g, w in zip(_flat(out), _flat(OLD[fn](*args))):
            assert g.dtype == w.dtype and torch.equal(g, w), fn
    for fn, old in OLD.items():
        monkeypatch.setattr(em, fn, old)
    assert torch.equal(routed, mt.render(scene, spp=2, seed=5))


@pytest.mark.parametrize("which", ["matpreview", "volpath", "volpath_env"])
def test_cpu_gradients_are_the_old_code(monkeypatch, which):
    """An eager AD step on the CPU: the loss and every gradient equal to the
    old code's bit for bit (the parts detach what the old code detached,
    and no more)."""
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse

    scene = _scene(which)
    keys = (("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u") if which == "matpreview"
            else ("bsdf.tabulated.table", "medium.sigma_t", "medium.phase_g"))
    full = traverse(scene)
    params = {k: full[k] for k in keys}
    target = torch.zeros((16, 16, 3))
    got = ad._eager_loss_and_grad(scene, params, target, 2, 3)
    for fn, old in OLD.items():
        monkeypatch.setattr(em, fn, old)
    want = ad._eager_loss_and_grad(scene, params, target, 2, 3)
    assert torch.equal(got[0], want[0])
    for k in keys:
        assert torch.equal(got[1][k], want[1][k]), k
        assert bool((want[1][k] != 0).any()), k


def test_one_plain_count_a_part_on_a_cpu_bounce():
    """Depth 4: four bounces, each one emitter.plain/hit; NEE at the first
    three, each one emitter.plain/sample and one emitter.plain/nee."""
    scene = _scene("matpreview")
    before = _counts()
    mt.render(scene, spp=1, seed=2)
    assert _diff(before, _counts()) == {"emitter.plain/hit": 4, "emitter.plain/sample": 3,
                                        "emitter.plain/nee": 3}


def _first_calls(scene):
    """The arguments of each part's first call in a CPU render of scene."""
    rec = {}
    saved = {fn: getattr(em, fn) for fn in FUNCTIONS.values()}

    def keeper(fn):
        def keep(*a):
            rec.setdefault(fn, a)
            return saved[fn](*a)
        return keep

    try:
        for fn in saved:
            setattr(em, fn, keeper(fn))
        mt.render(scene, spp=1, seed=1)
    finally:
        for fn, f in saved.items():
            setattr(em, fn, f)
    return rec


def _fake_kernels(monkeypatch):
    """Route as if the lanes were on the card, with stand-ins for the
    kernels (zeros of their outputs' shapes)."""
    route = em.route
    monkeypatch.setattr(em, "route", lambda present, _dev, *a: route(present, "cuda", *a))

    def sample(table, geom, frame, p_ref, mask, *a, **kw):
        n = p_ref.shape[0]
        z1, z3 = torch.zeros(n), torch.zeros(n, 3)
        off = torch.zeros(n, dtype=torch.bool)
        return DirectionSample(z3, z1, z1, z3, off, z1), z3, off

    monkeypatch.setattr(emitter_shade, "hit", lambda table, geom, si, *a: torch.zeros_like(si.p))
    monkeypatch.setattr(emitter_shade, "sample", sample)
    monkeypatch.setattr(emitter_shade, "nee", lambda radiance, *a: torch.zeros_like(radiance))


@pytest.mark.parametrize("case, want", [
    # what requires grad (under grad mode unless "no grad") -> routes of hit, sample, nee
    ("nothing", (F, F, F)),
    ("ray origin and prev_pdf", (F, F, F)),
    ("hit record", (F, F, F)),
    ("NEE point", (F, PL, F)),
    ("NEE pdfs", (F, F, F)),
    ("emitter radiance", (PL, PL, PL)),
    ("emitter radiance, no grad", (F, F, F)),
])
def test_route_tests_the_inputs_whose_gradient_counts(monkeypatch, case, want):
    """Each part tests the inputs whose gradient the plain route passes on:
    the hit record, the ray and prev_pdf (which feed the detached MIS weight
    and the front test) and the NEE term's pdfs are detached first; a NEE point with a graph (volpath's medium point) and the
    emitter radiance send the parts that read them to the plain route.
    Counted once a call as emitter.<route>/<part>."""
    rec = _first_calls(_scene("matpreview"))
    _fake_kernels(monkeypatch)
    table = rec["hit_term"][0]
    if case.startswith("emitter radiance"):
        table = table._replace(radiance=table.radiance.clone().requires_grad_(True))
    hit, sample, nee = (list(rec[fn]) for fn in FUNCTIONS.values())
    hit[0] = sample[0] = nee[0] = table
    if case == "ray origin and prev_pdf":
        hit[3] = hit[3]._replace(o=hit[3].o.clone().requires_grad_(True))
        hit[6] = hit[6].clone().requires_grad_(True)
    if case == "hit record":
        si = hit[2]
        hit[2] = si._replace(p=si.p.clone().requires_grad_(True),
                             wi=si.wi.clone().requires_grad_(True))
    if case == "NEE point":
        sample[3] = sample[3].clone().requires_grad_(True)
    if case == "NEE pdfs":
        nee[1] = nee[1]._replace(pdf=nee[1].pdf.clone().requires_grad_(True))
        nee[2] = nee[2].clone().requires_grad_(True)
    if case == "emitter radiance":
        nee[1] = nee[1]._replace(radiance=nee[1].radiance.clone().requires_grad_(True))
    before = _counts()
    with torch.set_grad_enabled(not case.endswith("no grad")):
        em.hit_term(*hit)
        em.sample_nee(*sample)
        em.nee_term(*nee)
    assert _diff(before, _counts()) == {f"emitter.{r}/{p}": 1 for p, r in zip(FUNCTIONS, want)}


@pytest.mark.parametrize("struct, cls", [("Table", emitter_shade._Table),
                                         ("HitArgs", emitter_shade._HitArgs),
                                         ("SampleArgs", emitter_shade._SampleArgs),
                                         ("NeeArgs", emitter_shade._NeeArgs)])
def test_ctypes_args_match_the_c_structs(struct, cls):
    """The wrappers' ctypes structures lay out the kernels' argument
    structs field for field (names, pointers, integer widths)."""
    kinds = {emitter_shade._P: "p", emitter_shade._I64: "int64_t",
             emitter_shade._I32: "int32_t", emitter_shade._Table: "Table"}
    src = (build.CSRC / "emitter_shade.cu").read_text()
    assert _c_fields(src, struct) == [(n, kinds[t]) for n, t in cls._fields_]


def test_kernel_names_avoid_the_benchmark_trace_names():
    """The benchmark finds a hand-written kernel in a trace by a part of
    its name (portbench/kernels/*.py TRACE_NAME): no emitter-stage kernel
    may hold one."""
    src = (build.CSRC / "emitter_shade.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))? (\w+)\(", src)
    assert sorted(names) == ["emitter_hit_kernel", "emitter_nee_kernel",
                             "emitter_sample_kernel"]
    pkg = Path(__file__).resolve().parents[1] / "portbench" / "kernels"
    traced = [importlib.import_module(f"portbench.kernels.{mod.name}").TRACE_NAME
              for mod in pkgutil.iter_modules([str(pkg)])]
    assert traced and not [(n, t) for n in names for t in traced if t in n]


def test_emitter_shade_is_built_without_contraction():
    assert "emitter_shade.cu" in build.SOURCES
    assert build.SOURCE_FLAGS["emitter_shade.cu"] == ("-fmad=false",)
    assert {"mct_emitter_hit", "mct_emitter_sample", "mct_emitter_nee"} <= set(build._SIGNATURES)


@pytest.mark.parametrize("part", list(FUNCTIONS))
def test_fused_wrappers_take_cuda_lanes_only(part):
    a = _first_calls(_scene("matpreview"))[FUNCTIONS[part]]
    with pytest.raises(ValueError):
        if part == "hit":
            emitter_shade.hit(a[0], a[1], a[2], a[3].o, a[6], a[7], a[8])
        elif part == "sample":
            emitter_shade.sample(a[0], a[1], a[2].frame, a[3], a[5], a[6], a[7],
                                 lane_key=a[4]._lane_key, dim=a[4].base_dim)
        else:
            ds = a[1]
            emitter_shade.nee(ds.radiance, ds.pdf, ds.delta, a[2], a[3])
