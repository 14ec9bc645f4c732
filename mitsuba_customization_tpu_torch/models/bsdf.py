"""Static BSDF dispatch table: per-lane material ids, masked run-all
dispatch over the kernels present in the scene, and two-child blends.

PyTorch port of mitsuba_customization_tpu/models/bsdf.py (`BSDFTable`,
`_dispatch`, the mixture `eval` / `pdf` / `sample` / `eval_pdf` and
`bounce_shade`). Kernel ids are the JAX package's, so tables carry over as
they are. The entry points take the JAX package's positional arguments
(`uv` in its place); `active` and `nee_mask` are keyword-only.

Kernels with big stacked parameters (the MERL tables, the texture stack)
take the whole stack, each lane's slot and the lane mask; a kernel whose
module sets NEEDS_UV (textured diffuse) also gets the texture coordinates
`uv`, through every route: the run-all dispatch, the fused bounce, and
the blend fallback. A normal map perturbs the shading frame before any of
them (models/normalmap.apply_normal_maps); `normal_tex` / `nm_slot` bind it.

A scene with a blend (blendbsdf or mask) resolves every lane through the
public eval / pdf / sample, as the JAX package does; the tabulated kernel
then runs K1 with one half per call. The port passes each call the lanes
that need it (live lanes; NEE lanes that are unoccluded; for a blend's
second child and the balance weight, blend lanes only), which leaves the
values of those lanes as the JAX package computes them.

A path-tracer bounce's BSDF work is bounce_shade, whose lanes take one of
three routes by kernel (route(), from what the call can observe; counted
in log.Statistics as bsdf.<route>/<kernel>):
- fused: CUDA lanes of the diffuse, rough-conductor (GGX, Beckmann) and
  tabulated kernels, in a scene without blends. Two hand-written kernels
  (ops/bsdf_shade, csrc/bsdf_shade.cu) around K2 and K1: bsdf_shade_pre
  computes every output of the analytic lanes and the tabulated lanes'
  work before K2, bsdf_shade_post their work between K2 and K1; the one
  attached step is K1's f times a per-lane scale.
- attached: under grad mode, the lanes of an analytic kernel whose
  parameters require grad, with need_attached: the fused route's
  direction and pdfs, f_nee and the weight from the kernel's plain eval.
- plain: every other lane, every CPU call and every scene with blends:
  _bounce_shade_plain, the masked run-all dispatch (for the tabulated
  kernel its own bounce_shade: one K2 pass, one K1 pass over both
  halves), the reference the fused route is held to.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models import (
    conductor,
    dielectric,
    diffuse,
    microfacet,
    passthrough,
    plastic,
    principled,
    roughconductor,
    roughdielectric,
    roughplastic,
    tabulated,
    textured_diffuse,
    thindielectric,
)
from mitsuba_customization_tpu_torch.ops import bsdf_shade
from mitsuba_customization_tpu_torch.utils import log

DIFFUSE = 0
CONDUCTOR = 1
ROUGHCONDUCTOR = 2
DIELECTRIC = 3
TABULATED = 4  # MERL and measured_custom (one kernel)
NULL = 5  # no parameters; the path tracer ends a path on it
ROUGHCONDUCTOR_BECKMANN = 6
PLASTIC = 7
ROUGHPLASTIC = 8
TEXTURED_DIFFUSE = 9
ROUGHDIELECTRIC = 10
THINDIELECTRIC = 11
PASSTHROUGH = 12  # the transparent child of `mask`
BLEND = 13  # two-child mixture, resolved before dispatch
PRINCIPLED = 14

KERNEL_NAMES = {
    DIFFUSE: "diffuse",
    CONDUCTOR: "conductor",
    ROUGHCONDUCTOR: "roughconductor",
    DIELECTRIC: "dielectric",
    TABULATED: "tabulated",
    NULL: "null",
    ROUGHCONDUCTOR_BECKMANN: "roughconductor_beckmann",
    PLASTIC: "plastic",
    ROUGHPLASTIC: "roughplastic",
    TEXTURED_DIFFUSE: "textured_diffuse",
    ROUGHDIELECTRIC: "roughdielectric",
    THINDIELECTRIC: "thindielectric",
    PASSTHROUGH: "passthrough",
    BLEND: "blend",
    PRINCIPLED: "principled",
}


class _BeckmannKernel:
    """roughconductor with the Beckmann NDF (a static kernel variant)."""

    @staticmethod
    def eval(params, wi, wo):
        return roughconductor.eval(params, wi, wo, dist_type=microfacet.BECKMANN)

    @staticmethod
    def pdf(params, wi, wo):
        return roughconductor.pdf(params, wi, wo, dist_type=microfacet.BECKMANN)

    @staticmethod
    def sample(params, wi, sample2, sample1=None):
        return roughconductor.sample(params, wi, sample2, sample1,
                                     dist_type=microfacet.BECKMANN)


_MODULES = {
    DIFFUSE: diffuse,
    CONDUCTOR: conductor,
    ROUGHCONDUCTOR: roughconductor,
    DIELECTRIC: dielectric,
    TABULATED: tabulated,
    ROUGHCONDUCTOR_BECKMANN: _BeckmannKernel,
    PLASTIC: plastic,
    ROUGHPLASTIC: roughplastic,
    ROUGHDIELECTRIC: roughdielectric,
    THINDIELECTRIC: thindielectric,
    PASSTHROUGH: passthrough,
    PRINCIPLED: principled,
    TEXTURED_DIFFUSE: textured_diffuse,
}
# Kernels with big stacked parameters (the MERL tables, the texture stack):
# the slot and the lane mask go into the kernel instead of a per-lane
# parameter gather.
_NEEDS_SLOT = frozenset([TABULATED, TEXTURED_DIFFUSE])

# Kernels whose sample() is a Dirac delta (NEE skips them; no MIS weight).
DELTA_KERNELS = frozenset([CONDUCTOR, DIELECTRIC, NULL, THINDIELECTRIC, PASSTHROUGH])
# Kernels that can transmit. With none present the path tracer skips NEE
# samples below the shading horizon (f = 0 for every reflective kernel).
TRANSMISSIVE_KERNELS = frozenset(
    [DIELECTRIC, NULL, ROUGHDIELECTRIC, THINDIELECTRIC, PASSTHROUGH])


class BSDFTable(NamedTuple):
    """All materials of a scene, compiled for masked static dispatch.

    mat_type (M,) kernel ids; mat_slot (M,) index into that kernel's
    stack; stacks: kernel id -> stacked parameter NamedTuple. A blend
    material (kernel BLEND) has two child material ids and the weight of
    the second (blend_a, blend_b, blend_w, (M,) each; identity and 0 for
    other materials); they are None in a scene without blends. Children
    are not blends themselves.
    """

    mat_type: torch.Tensor
    mat_slot: torch.Tensor
    stacks: Dict[int, Any]
    blend_a: Any = None
    blend_b: Any = None
    blend_w: Any = None
    normal_tex: Any = None  # TextureStack of normal maps (models/normalmap)
    nm_slot: Any = None  # (M,) int64 binding into normal_tex (-1 = none)

    @property
    def present_kernels(self):
        return sorted(self.stacks.keys())

    def is_delta(self, mat_id):
        """Per lane: does the material sample a delta lobe? A blend does
        where both children do."""
        def kernel_delta(types):
            out = torch.zeros(types.shape, dtype=torch.bool, device=types.device)
            for k in DELTA_KERNELS:
                out = out | (types == k)
            return out

        t = self.mat_type[mat_id]
        out = kernel_delta(t)
        if self.blend_a is not None:
            da = kernel_delta(self.mat_type[self.blend_a[mat_id]])
            db = kernel_delta(self.mat_type[self.blend_b[mat_id]])
            out = torch.where(t == BLEND, da & db, out)
        return out

    def resolve_children(self, mat_id):
        """(child_a, child_b, w, is_blend): the identity for non-blends."""
        is_b = self.mat_type[mat_id] == BLEND
        a = torch.where(is_b, self.blend_a[mat_id], mat_id)
        b = torch.where(is_b, self.blend_b[mat_id], mat_id)
        w = torch.where(is_b, self.blend_w[mat_id], 0.0)
        return a, b, w, is_b


def _gather_params(stack, slot):
    """Per-lane parameters from a stacked NamedTuple. index_select, not
    f[slot]: its backward is an index_add_, where the backward of advanced
    indexing sorts the indices first, which took 9 ms a call on the card
    when every lane reads one material's alpha (PERF.md §5, AD step)."""
    return type(stack)(*(f.index_select(0, slot) for f in stack))


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim())),
                       new, old)


def _zeros(fn_name, wi):
    """The result of a dispatch with no kernel to run (a scene of only
    null materials)."""
    shape, dev = wi.shape[:-1], wi.device
    if fn_name == "eval":
        return torch.zeros(shape + (3,), device=dev)
    if fn_name == "pdf":
        return torch.zeros(shape, device=dev)
    return (torch.zeros_like(wi), torch.zeros(shape, device=dev),
            torch.zeros(shape + (3,), device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev))


def _kernel_fn(table: BSDFTable, kid, slot_safe, mask, uv):
    """fn_name -> a call of kernel `kid`'s function on the lanes' (slot,
    mask, uv) binding: the whole stack for NEEDS_SLOT kernels (with uv
    where the module sets NEEDS_UV), else per-lane gathered parameters."""
    mod = _MODULES[kid]
    if kid in _NEEDS_SLOT:
        kw = dict(slot=slot_safe, mask=mask)
        if getattr(mod, "NEEDS_UV", False):
            kw["uv"] = uv
        return lambda fn_name, *a: getattr(mod, fn_name)(table.stacks[kid], *a, **kw)
    params = _gather_params(table.stacks[kid], slot_safe)
    return lambda fn_name, *a: getattr(mod, fn_name)(params, *a)


def _dispatch(table: BSDFTable, mat_id, fn_name, wi, *args, uv=None, active=None):
    """Masked run-all dispatch of eval / pdf / sample over the present
    kernels; `active` (None = all lanes) restricts every kernel's lanes.
    Lanes of no kernel (null, or outside `active`) come back 0."""
    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    out = None
    for kid in table.present_kernels:
        mask = t == kid
        if active is not None:
            mask = mask & active
        slot_safe = torch.where(mask, slot, 0)
        res = _kernel_fn(table, kid, slot_safe, mask, uv)(fn_name, wi, *args)
        single = isinstance(res, torch.Tensor)
        res = (res,) if single else res
        if out is None:
            out = tuple(torch.zeros_like(r) for r in res)
        out = tuple(_where(mask, r, o) for o, r in zip(out, res))
    if out is None:
        return _zeros(fn_name, wi)
    return out[0] if single else out


def eval(table: BSDFTable, mat_id, wi, wo, uv=None, *, active=None):
    """f(wi, wo) * cos(theta_o) for each lane's material; a blend's is
    (1 - w) f_a + w f_b."""
    if table.blend_a is None:
        return _dispatch(table, mat_id, "eval", wi, wo, uv=uv, active=active)
    a, b, w, is_b = table.resolve_children(mat_id)
    f_a = _dispatch(table, a, "eval", wi, wo, uv=uv, active=active)
    f_b = _dispatch(table, b, "eval", wi, wo, uv=uv, active=_and(active, is_b))
    return (1.0 - w)[..., None] * f_a + w[..., None] * f_b


def pdf(table: BSDFTable, mat_id, wi, wo, uv=None, *, active=None):
    if table.blend_a is None:
        return _dispatch(table, mat_id, "pdf", wi, wo, uv=uv, active=active)
    a, b, w, is_b = table.resolve_children(mat_id)
    p_a = _dispatch(table, a, "pdf", wi, wo, uv=uv, active=active)
    p_b = _dispatch(table, b, "pdf", wi, wo, uv=uv, active=_and(active, is_b))
    return (1.0 - w) * p_a + w * p_b


def _and(active, mask):
    return mask if active is None else active & mask


def sample(table: BSDFTable, mat_id, wi, sample2, sample1=None, uv=None, *,
           active=None):
    """Per-lane BSDF sampling -> (wo, pdf, weight, sampled_delta);
    sampled_delta is per sample (plastic picks its lobe lane by lane).

    A blend picks a child with the probability of its weight and hands it
    sample1 rescaled; a smooth sample then takes the balance heuristic's
    weight f_mix / p_mix and pdf p_mix, a delta sample keeps the child's
    weight, its pdf times the selection probability.
    """
    if table.blend_a is None:
        return _dispatch(table, mat_id, "sample", wi, sample2, sample1, uv=uv,
                         active=active)
    a, b, w, is_blend = table.resolve_children(mat_id)
    if sample1 is None:
        sample1 = sample2[..., 0]
    pick_b = is_blend & (sample1 < w)
    child = torch.where(pick_b, b, a)
    u1 = torch.where(
        pick_b, sample1 / torch.clamp(w, min=1e-8),
        torch.where(is_blend, (sample1 - w) / torch.clamp(1.0 - w, min=1e-8), sample1),
    )
    u1 = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    wo, p_c, w_c, delta_c = _dispatch(table, child, "sample", wi, sample2, u1, uv=uv,
                                      active=active)
    # the balance weight, read on blend lanes only
    on_blend = _and(active, is_blend)
    f_mix = eval(table, mat_id, wi, wo, uv, active=on_blend)
    p_mix = pdf(table, mat_id, wi, wo, uv, active=on_blend)
    w_bal = m.safe_div(f_mix, p_mix[..., None])
    sel = torch.where(pick_b, w, torch.where(is_blend, 1.0 - w, 1.0))
    use_bal = is_blend & ~delta_c
    weight = torch.where(use_bal[..., None], w_bal, w_c)
    p_out = torch.where(use_bal, p_mix, torch.where(is_blend, p_c * sel, p_c))
    ok = p_out > 0.0
    return (wo, torch.where(ok, p_out, 0.0), torch.where(ok[..., None], weight, 0.0),
            delta_c)


def eval_pdf(table: BSDFTable, mat_id, wi, wo, uv=None, *, active=None):
    """eval and pdf toward wo (the NEE pair)."""
    return (eval(table, mat_id, wi, wo, uv, active=active),
            pdf(table, mat_id, wi, wo, uv, active=active))


# Kernels whose lanes the BSDF stage's CUDA kernels compute (ops/bsdf_shade).
FUSED_KERNELS = frozenset([DIFFUSE, ROUGHCONDUCTOR, ROUGHCONDUCTOR_BECKMANN, TABULATED])
# bounce_shade's routes for a kernel's lanes (route)
FUSED, ATTACHED, PLAIN = "fused", "attached", "plain"


def route(present, device_type, blends, grad_enabled, requires_grad, need_attached):
    """bounce_shade's route for each present kernel's lanes, from what the
    call can observe: kernel id -> FUSED, ATTACHED or PLAIN.

    present: the table's kernel ids; device_type: the lanes' ("cuda" or
    not); blends: the table has blends; grad_enabled: torch's grad mode;
    requires_grad: the kernels whose parameter stack has a field that
    requires grad; need_attached: the caller's (the detached estimator,
    ad_mode).

    FUSED (the CUDA kernels compute the lanes' six outputs): a kernel of
    FUSED_KERNELS on CUDA lanes, in a scene without blends. The tabulated
    kernel's gradient passes through K1 alone, so it fuses whatever
    requires grad. An analytic kernel whose stack requires grad under grad
    mode is ATTACHED with need_attached (wo, pdf_s, pdf_nee and is_delta
    fused; f_nee and the weight from its plain eval calls, whose gradient
    the attached estimator needs), else PLAIN. Everything else is PLAIN,
    today's per-kernel code, which every CPU call runs.

    The fused kernels hand no gradient to the lane inputs (wi, wo_nee, the
    samples), as K1 hands none to its directions. The integrators
    differentiate the BSDF in its parameters only: their hits are
    detached, and the one lane input that can carry a graph, volpath's
    NEE direction from a medium interaction, reaches no surface lane's
    BSDF (a surface lane's NEE starts at its detached hit).
    """
    if blends or device_type != "cuda":
        return {kid: PLAIN for kid in present}
    out = {}
    for kid in present:
        if kid not in FUSED_KERNELS:
            out[kid] = PLAIN
        elif kid != TABULATED and grad_enabled and kid in requires_grad:
            out[kid] = ATTACHED if need_attached else PLAIN
        else:
            out[kid] = FUSED
    return out


def _routes(table, wi, need_attached):
    """route() for one bounce_shade call, counted in log.Statistics as
    bsdf.<route>/<kernel name> (host counts)."""
    grad = torch.is_grad_enabled()
    requires = frozenset(
        kid for kid in table.stacks
        if grad and kid in FUSED_KERNELS - {TABULATED}
        and any(f.requires_grad for f in table.stacks[kid]))
    routes = route(table.present_kernels, wi.device.type, table.blend_a is not None, grad,
                   requires, need_attached)
    stats = log.Statistics.get()
    for kid, r in routes.items():
        stats.add(f"bsdf.{r}/{KERNEL_NAMES[kid]}")
    return routes


def bounce_shade(table: BSDFTable, mat_id, wi, wo_nee, sample2, sample1=None, uv=None,
                 need_attached=False, has_nee=True, *, active=None, nee_mask=None):
    """All BSDF work of one path-tracer bounce: eval and pdf toward wo_nee,
    sample at (sample2, sample1). Returns (f_nee, pdf_nee, wo, pdf_s,
    weight, is_delta). need_attached (ad_mode): the weight of a non-delta
    lobe is the detached estimator's, eval at the sampled wo held fixed
    over the detached pdf (the same value; its gradient in the parameters
    is the right one); the caller then holds wo and the pdfs detached.
    nee_mask: lanes whose NEE sample is live and unoccluded; the tabulated
    NEE eval skips the others (their f_nee / pdf_nee come back 0). Null
    lanes come back 0 (pdf 0: the path ends). uv: the lanes' texture
    coordinates (integrator.texcoords), read by NEEDS_UV kernels.

    Each present kernel's lanes take the route that route() picks:
    - fused (CUDA lanes of the diffuse, rough-conductor and tabulated
      kernels): _bounce_shade_fused, one launch of bsdf_shade_pre for all
      of them, and for tabulated lanes K2, bsdf_shade_post, one K1 pass
      over the halves wo_nee and wo_sampled and two multiplies.
    - attached (under AD, an analytic kernel whose parameters require
      grad): the fused route's wo and pdfs, f_nee and the weight from the
      kernel's plain eval calls (_attach).
    - plain: _bounce_shade_plain, the masked dispatch over the kernel's
      lanes (the tabulated kernel's fused bounce_shade: one K2 pass + one
      K1 pass over both halves). Every CPU call takes it, and every call
      on a scene with blends takes the public sample / eval_pdf / eval
      instead (the JAX package's fallback): every lane, blended or not.
    """
    routes = _routes(table, wi, need_attached)
    if table.blend_a is not None:
        return _bounce_shade_blend(table, mat_id, wi, wo_nee, sample2, sample1, uv,
                                   need_attached, has_nee, active, nee_mask)
    fused = [kid for kid, r in routes.items() if r != PLAIN]
    out = None
    if fused:
        out = _bounce_shade_fused(table, fused, mat_id, wi, wo_nee, sample2, sample1,
                                  has_nee, active, nee_mask)
    plain = [kid for kid, r in routes.items() if r == PLAIN]
    if plain or out is None:
        out = _bounce_shade_plain(table, mat_id, wi, wo_nee, sample2, sample1, uv,
                                  need_attached, has_nee, active=active, nee_mask=nee_mask,
                                  kernels=plain, out=out)
    attached = [kid for kid, r in routes.items() if r == ATTACHED]
    if attached:
        out = _attach(table, attached, mat_id, wi, wo_nee, uv, has_nee, active, out)
    return out


def _bounce_shade_fused(table, kernels, mat_id, wi, wo_nee, sample2, sample1, has_nee,
                        active, nee_mask):
    """bounce_shade's six outputs, on CUDA lanes, for the lanes of
    `kernels` (of FUSED_KERNELS; others come back 0): bsdf_shade_pre,
    then for the tabulated lanes K2, bsdf_shade_post, K1 and f = f2 *
    scale (tabulated.bounce_shade_fused), the one step that carries the
    table's gradient."""
    def entry(kid):
        return (kid, table.stacks[kid]) if kid in kernels else None

    tab = table.stacks[TABULATED] if TABULATED in kernels else None
    pre = bsdf_shade.shade_pre(
        table.mat_type, table.mat_slot, mat_id, wi, wo_nee, sample2, sample1, active,
        nee_mask, has_nee,
        bsdf_shade.Fused(entry(DIFFUSE), entry(ROUGHCONDUCTOR),
                         entry(ROUGHCONDUCTOR_BECKMANN),
                         None if tab is None else (TABULATED, tab.sampling)))
    f_nee, weight = pre.f_nee, pre.weight
    if tab is not None:
        f_nee, weight = tabulated.bounce_shade_fused(tab, pre, wi, wo_nee, sample2, sample1)
    return f_nee, pre.pdf_nee, pre.wo, pre.pdf_s, weight, pre.is_delta


def _attach(table, kernels, mat_id, wi, wo_nee, uv, has_nee, active, out):
    """The attached estimator's f_nee and weight on the lanes of `kernels`
    (analytic kernels whose parameters require grad): their plain eval
    calls toward wo_nee and at the fused route's wo, over its pdf_s (both
    detached). The fused kernels sample no delta lobe."""
    f_nee, pdf_nee, wo, pdf_s, weight, is_delta = out
    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    for kid in kernels:
        mask = t == kid
        if active is not None:
            mask = mask & active
        call = _kernel_fn(table, kid, torch.where(mask, slot, 0), mask, uv)
        if has_nee:
            f_nee = _where(mask, call("eval", wi, wo_nee), f_nee)
        weight = _where(mask, m.safe_div(call("eval", wi, wo), pdf_s[..., None]), weight)
    return f_nee, pdf_nee, wo, pdf_s, weight, is_delta


def _bounce_shade_plain(table: BSDFTable, mat_id, wi, wo_nee, sample2, sample1=None,
                        uv=None, need_attached=False, has_nee=True, *, active=None,
                        nee_mask=None, kernels=None, out=None):
    """bounce_shade's plain route, the masked dispatch: each kernel of
    `kernels` (None: every present kernel) runs on its lanes and is merged
    into `out` (None: zeros), the tabulated kernel through its fused
    bounce_shade (one K2 pass + one K1 pass over the halves wo_nee and
    wo_sampled), the others through sample, eval and pdf. The reference
    of the fused route; see bounce_shade for the arguments."""
    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    shape = wi.shape[:-1]
    for kid in table.present_kernels if kernels is None else kernels:
        mod = _MODULES[kid]
        mask = t == kid
        if active is not None:
            mask = mask & active
        slot_safe = torch.where(mask, slot, 0)
        if kid == TABULATED:
            m_nee = mask if has_nee else torch.zeros_like(mask)
            if has_nee and nee_mask is not None:
                m_nee = m_nee & nee_mask
            res = mod.bounce_shade(
                table.stacks[kid], wi, wo_nee, sample2, sample1,
                slot=slot_safe, mask=mask, mask_nee=m_nee,
            )
            # the tabulated weight is the detached estimator's already:
            # K1's eval at wo over a pdf from the detached CDFs
        else:
            call = _kernel_fn(table, kid, slot_safe, mask, uv)
            wo, p_s, weight, is_delta = call("sample", wi, sample2, sample1)
            if has_nee:
                f_nee = call("eval", wi, wo_nee)
                p_nee = call("pdf", wi, wo_nee)
            else:
                f_nee = torch.zeros(shape + (3,), device=wi.device)
                p_nee = torch.zeros(shape, device=wi.device)
            if need_attached:
                # the sampled wo depends on the parameters (GGX alpha): the
                # detached estimator evaluates at wo held fixed
                w_att = m.safe_div(call("eval", wi, wo.detach()),
                                   p_s.detach()[..., None])
                weight = torch.where(is_delta[..., None], weight, w_att)
            res = (f_nee, p_nee, wo, p_s, weight, is_delta)
        if out is None:
            out = tuple(torch.zeros_like(r) for r in res)
        out = tuple(_where(mask, r, o) for o, r in zip(out, res))
    if out is None:  # a scene of only null materials
        f0, p0 = _zeros("eval", wi), _zeros("pdf", wi)
        return (f0, p0) + _zeros("sample", wi)
    return out


def _bounce_shade_blend(table, mat_id, wi, wo_nee, sample2, sample1, uv,
                        need_attached, has_nee, active, nee_mask):
    """bounce_shade of a scene with blends: sample, eval_pdf toward wo_nee
    (unoccluded NEE lanes only when nee_mask is given) and, with
    need_attached, the attached eval at the detached wo, whose ratio to the
    detached pdf is the non-delta weight."""
    wo, p_s, weight, is_delta = sample(table, mat_id, wi, sample2, sample1, uv,
                                       active=active)
    if has_nee:
        f_nee, p_nee = eval_pdf(table, mat_id, wi, wo_nee, uv,
                                active=_and(active, nee_mask) if nee_mask is not None
                                else active)
    else:
        f_nee, p_nee = torch.zeros_like(weight), torch.zeros_like(p_s)
    if need_attached:
        f_att = eval(table, mat_id, wi, wo.detach(), uv, active=active)
        weight = torch.where(is_delta[..., None], weight,
                             m.safe_div(f_att, p_s.detach()[..., None]))
    return f_nee, p_nee, wo, p_s, weight, is_delta
