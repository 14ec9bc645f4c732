"""The BSDF stage's routes (models/bsdf.route): the rule, its counters, and
the CPU route, which is the plain route (the per-kernel code) bit for bit;
the JAX parity tests hold that route to the JAX package. The CUDA
kernels of the fused route are held to the plain route on the card
(tests/test_torch_cuda_bsdf.py)."""

import importlib
import pkgutil
import re
from pathlib import Path

import pytest
import torch

from bsdf_lanes import MATERIALS, lanes, mixed_table
from mitsuba_customization_tpu_torch.models import bsdf
from mitsuba_customization_tpu_torch.ops import build, bsdf_shade
from mitsuba_customization_tpu_torch.utils import log
from test_torch_kernels import one_torch_thread  # noqa: F401

D, G, B, T, P = (bsdf.DIFFUSE, bsdf.ROUGHCONDUCTOR, bsdf.ROUGHCONDUCTOR_BECKMANN,
                 bsdf.TABULATED, bsdf.PLASTIC)
PRESENT = [D, G, T, B, P]
F, A, PL = bsdf.FUSED, bsdf.ATTACHED, bsdf.PLAIN


@pytest.mark.parametrize("args, want", [
    # (device, blends, grad mode, stacks requiring grad, need_attached)
    #   -> routes of D, G, T, B, P
    (("cpu", False, False, set(), False), (PL, PL, PL, PL, PL)),
    (("cpu", False, True, {G}, True), (PL, PL, PL, PL, PL)),
    (("cuda", False, False, set(), False), (F, F, F, F, PL)),
    (("cuda", True, False, set(), False), (PL, PL, PL, PL, PL)),
    (("cuda", True, True, {G}, True), (PL, PL, PL, PL, PL)),
    (("cuda", False, True, set(), True), (F, F, F, F, PL)),
    (("cuda", False, True, {G}, True), (F, A, F, F, PL)),
    (("cuda", False, True, {G, D, B}, True), (A, A, F, A, PL)),
    (("cuda", False, True, {G}, False), (F, PL, F, F, PL)),
    (("cuda", False, False, {G}, True), (F, F, F, F, PL)),
    (("cuda", False, True, {T}, True), (F, F, F, F, PL)),
    (("cuda", False, True, {P}, True), (F, F, F, F, PL)),
])
def test_route_rule(args, want):
    dev, blends, grad, requires, attached = args
    got = bsdf.route(PRESENT, dev, blends, grad, frozenset(requires), attached)
    assert got == dict(zip(PRESENT, want))


def _counts():
    return {k: v for k, v in log.Statistics.get().counters.items() if k.startswith("bsdf.")}


def _diff(before, after):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


@pytest.mark.parametrize("variant", ["all", "no_sample1", "no_nee", "no_masks", "attached"])
def test_cpu_bounce_shade_is_the_per_kernel_code(variant):
    """A CPU call routes every present kernel to the plain route (one count
    each) and returns _bounce_shade_plain's outputs bit for bit."""
    table = mixed_table("cpu", seed=1)
    d = lanes("cpu", 6000, len(MATERIALS), seed=2)
    s1 = None if variant == "no_sample1" else d["sample1"]
    active, nee_mask = ((None, None) if variant == "no_masks"
                        else (d["active"], d["nee_mask"]))
    args = (table, d["mat_id"], d["wi"], d["wo_nee"], d["sample2"], s1,
            variant == "attached", variant != "no_nee", active, nee_mask)
    before = _counts()
    got = bsdf.bounce_shade(*args[:6], None, *args[6:8], active=active, nee_mask=nee_mask)
    assert _diff(before, _counts()) == {
        f"bsdf.plain/{bsdf.KERNEL_NAMES[k]}": 1 for k in table.present_kernels}
    want = bsdf._bounce_shade_plain(*args[:6], None, *args[6:8], active=active,
                                    nee_mask=nee_mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_route_counters_on_the_cpu():
    """A CPU call counts each present kernel once on the plain route."""
    table = mixed_table("cpu")
    d = lanes("cpu", 64, len(MATERIALS))
    before = _counts()
    for _ in range(2):
        bsdf.bounce_shade(table, d["mat_id"], d["wi"], d["wo_nee"], d["sample2"],
                          d["sample1"], active=d["active"], nee_mask=d["nee_mask"])
    assert _diff(before, _counts()) == {
        f"bsdf.plain/{bsdf.KERNEL_NAMES[k]}": 2 for k in table.present_kernels}


@pytest.mark.parametrize("grad, need_attached, want", [
    (False, False, {D: F, G: F, B: F, T: F, P: PL}),
    (True, True, {D: F, G: A, B: F, T: F, P: PL}),
    (True, False, {D: F, G: PL, B: F, T: F, P: PL}),
])
def test_route_counters_of_a_cuda_call(monkeypatch, grad, need_attached, want):
    """_routes on lanes routed as CUDA lanes (the device type handed to
    route() replaced), with the GGX alpha requiring grad: one count a
    kernel a call, named bsdf.<route>/<kernel>."""
    route = bsdf.route
    monkeypatch.setattr(bsdf, "route", lambda present, _dev, *a: route(present, "cuda", *a))
    table = mixed_table("cpu")
    ggx = table.stacks[G]
    stacks = dict(table.stacks)
    stacks[G] = ggx._replace(alpha_u=ggx.alpha_u.clone().requires_grad_(True))
    table = table._replace(stacks=stacks)
    d = lanes("cpu", 64, len(MATERIALS))
    before = _counts()
    with torch.set_grad_enabled(grad):
        got = bsdf._routes(table, d["wi"], need_attached)
    assert got == want
    assert _diff(before, _counts()) == {
        f"bsdf.{r}/{bsdf.KERNEL_NAMES[k]}": 1 for k, r in want.items()}


def test_kernel_names_avoid_the_benchmark_trace_names():
    """The benchmark finds a hand-written kernel in a trace by a part of
    its name (portbench/kernels/*.py TRACE_NAME): no BSDF-stage kernel may
    hold one."""
    src = (build.CSRC / "bsdf_shade.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))? (\w+)\(", src)
    assert sorted(names) == ["bsdf_shade_post_kernel", "bsdf_shade_pre_kernel"]
    pkg = Path(__file__).resolve().parents[1] / "portbench" / "kernels"
    traced = [importlib.import_module(f"portbench.kernels.{mod.name}").TRACE_NAME
              for mod in pkgutil.iter_modules([str(pkg)])]
    assert traced and not [(n, t) for n in names for t in traced if t in n]


def _c_fields(src, struct):
    """(name, kind) of each field of a C struct in csrc/bsdf_shade.cu:
    kind "p" for a pointer, else its type name."""
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    out = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        typ, names = re.match(r"((?:const )?\w+\*?) (.*)", decl).groups()
        for name in names.split(","):
            name = name.strip()
            kind = "p" if (typ.endswith("*") or name.startswith("*")) else typ
            out.append((name.lstrip("*"), kind))
    return out


@pytest.mark.parametrize("struct, cls", [("Rough", bsdf_shade._Rough),
                                         ("PreArgs", bsdf_shade._PreArgs),
                                         ("PostArgs", bsdf_shade._PostArgs)])
def test_ctypes_args_match_the_c_structs(struct, cls):
    """The wrappers' ctypes structures lay out the kernels' argument
    structs field for field (names, pointers, integer widths)."""
    kinds = {bsdf_shade._P: "p", bsdf_shade._I64: "int64_t", bsdf_shade._I32: "int32_t",
             bsdf_shade._Rough: "Rough"}
    src = (build.CSRC / "bsdf_shade.cu").read_text()
    assert _c_fields(src, struct) == [(n, kinds[t]) for n, t in cls._fields_]


def test_bsdf_shade_is_built_without_contraction():
    assert "bsdf_shade.cu" in build.SOURCES
    assert build.SOURCE_FLAGS["bsdf_shade.cu"] == ("-fmad=false",)
    assert {"mct_bsdf_shade_pre", "mct_bsdf_shade_post"} <= set(build._SIGNATURES)


def test_fused_wrappers_take_cuda_lanes_only():
    table = mixed_table("cpu")
    d = lanes("cpu", 16, len(MATERIALS))
    with pytest.raises(ValueError):
        bsdf_shade.shade_pre(table.mat_type, table.mat_slot, d["mat_id"], d["wi"],
                             d["wo_nee"], d["sample2"], d["sample1"], d["active"],
                             d["nee_mask"], True, bsdf_shade.Fused())
