"""Static BSDF dispatch table: per-lane material ids, masked run-all
dispatch over the kernels present in the scene.

PyTorch port of mitsuba_customization_tpu/models/bsdf.py (`BSDFTable`,
`_dispatch`, `bounce_shade`) for the DIFFUSE, ROUGHCONDUCTOR and TABULATED
kernels. Kernel ids are the JAX package's, so tables carry over as they
are. Blend materials and normal maps are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.models import diffuse, roughconductor, tabulated

DIFFUSE = 0
ROUGHCONDUCTOR = 2
TABULATED = 4

_MODULES = {
    DIFFUSE: diffuse,
    ROUGHCONDUCTOR: roughconductor,
    TABULATED: tabulated,
}
# Kernels with big stacked parameters (the MERL tables): the slot goes into
# the kernel instead of a per-lane parameter gather.
_NEEDS_SLOT = frozenset([TABULATED])


class BSDFTable(NamedTuple):
    """All materials of a scene, compiled for masked static dispatch.

    mat_type (M,) kernel ids; mat_slot (M,) index into that kernel's
    stack; stacks: kernel id -> stacked parameter NamedTuple.
    """

    mat_type: torch.Tensor
    mat_slot: torch.Tensor
    stacks: Dict[int, Any]

    @property
    def present_kernels(self):
        return sorted(self.stacks.keys())


def _gather_params(stack, slot):
    """Per-lane parameters from a stacked NamedTuple. index_select, not
    f[slot]: its backward is an index_add_, where the backward of advanced
    indexing sorts the indices first, which took 9 ms a call on the card
    when every lane reads one material's alpha (PERF.md §5, AD step)."""
    return type(stack)(*(f.index_select(0, slot) for f in stack))


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim())),
                       new, old)


def _dispatch(table: BSDFTable, mat_id, fn_name, wi, *args):
    """Masked run-all dispatch of eval / pdf / sample."""
    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    out = None
    for kid in table.present_kernels:
        if kid in _NEEDS_SLOT:
            raise NotImplementedError(
                "tabulated eval/pdf/sample outside bounce_shade is not ported"
            )
        mod = _MODULES[kid]
        mask = t == kid
        slot_safe = torch.where(mask, slot, 0)
        res = getattr(mod, fn_name)(
            _gather_params(table.stacks[kid], slot_safe), wi, *args
        )
        single = isinstance(res, torch.Tensor)
        res = (res,) if single else res
        if out is None:
            out = tuple(torch.zeros_like(r) for r in res)
        out = tuple(_where(mask, r, o) for o, r in zip(out, res))
    return out[0] if single else out


def eval(table: BSDFTable, mat_id, wi, wo):
    """f(wi, wo) * cos(theta_o) for each lane's material."""
    return _dispatch(table, mat_id, "eval", wi, wo)


def pdf(table: BSDFTable, mat_id, wi, wo):
    return _dispatch(table, mat_id, "pdf", wi, wo)


def sample(table: BSDFTable, mat_id, wi, sample2, sample1=None):
    """Per-lane BSDF sampling -> (wo, pdf, weight, sampled_delta)."""
    return _dispatch(table, mat_id, "sample", wi, sample2, sample1)


def bounce_shade(table: BSDFTable, mat_id, wi, wo_nee, sample2, sample1=None,
                 need_attached=False, has_nee=True, active=None, nee_mask=None):
    """All BSDF work of one path-tracer bounce in one dispatch pass.

    Fuses {eval and pdf toward wo_nee, sample at (sample2, sample1)}; the
    tabulated kernel runs its fused bounce_shade (one K2 pass + one K1
    pass over both directions). Returns (f_nee, pdf_nee, wo, pdf_s,
    weight, is_delta). need_attached (ad_mode): the weight of a non-delta
    lobe is the detached estimator's, eval at the sampled wo held fixed
    over the detached pdf (the same value; its gradient in the parameters
    is the right one). nee_mask: lanes whose NEE sample is live and
    unoccluded; the tabulated NEE eval skips the others (their f_nee /
    pdf_nee come back 0).
    """
    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    shape = wi.shape[:-1]
    out = None
    for kid in table.present_kernels:
        mod = _MODULES[kid]
        mask = t == kid
        if active is not None:
            mask = mask & active
        slot_safe = torch.where(mask, slot, 0)
        if kid in _NEEDS_SLOT:
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
            params = _gather_params(table.stacks[kid], slot_safe)
            wo, p_s, weight, is_delta = mod.sample(params, wi, sample2, sample1)
            if has_nee:
                f_nee = mod.eval(params, wi, wo_nee)
                p_nee = mod.pdf(params, wi, wo_nee)
            else:
                f_nee = torch.zeros(shape + (3,), device=wi.device)
                p_nee = torch.zeros(shape, device=wi.device)
            if need_attached:
                # the sampled wo depends on the parameters (GGX alpha): the
                # detached estimator evaluates at wo held fixed
                w_att = m.safe_div(mod.eval(params, wi, wo.detach()),
                                   p_s.detach()[..., None])
                weight = torch.where(is_delta[..., None], weight, w_att)
            res = (f_nee, p_nee, wo, p_s, weight, is_delta)
        if out is None:
            out = tuple(torch.zeros_like(r) for r in res)
        out = tuple(_where(mask, r, o) for o, r in zip(out, res))
    return out
