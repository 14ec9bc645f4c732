"""K1: trilinear MERL/tabulated-BRDF evaluation, one CUDA thread per lane.

Replaces the TPU kernel mitsuba_customization_tpu/ops/merl_sorted.py
`_segment_kernel` (launched by `_eval_sorted_impl`, reached through
`eval_sorted` / `eval_trilinear` from `tabulated.eval_f`). The TPU version
sorts lanes by table cell, walks the sorted wavefront segment by segment
over DMA'd slabs and unsorts, with 16-bit fixed-point fractions; those are
TPU workarounds for slow per-lane gathers and are not carried over.

What bounds it on the H100: scattered reads of 4 corner rows x 2 phi_d
bins x 3 floats per lane from the table. The design keeps the table in its
natural (n_mat, n_th, n_td, n_pd, 3) float32 layout, where one MERL
material (17.5 MB) fits in the 50 MB L2, so those reads hit L2; the kernel
computes the angles, grid coordinates and clamping in registers, needs no
sort, and uses full float32 fractions. Whether sorting lanes by cell pays
on this card is left to measurement.

`eval_trilinear` picks by device: a CPU tensor goes to the plain PyTorch
version `eval_trilinear_plain`, a CUDA tensor to the kernel (or it raises).
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core.rusinkiewicz import (
    dirs_to_half_diff_fast,
)
from mitsuba_customization_tpu_torch.ops import build

SOURCE = "mitsuba_customization_tpu_torch/csrc/merl_eval.cu"

# Kernel launches in this process (the wrapper adds one per launch).
LAUNCHES = 0

HALF_PI = torch.pi / 2.0


def grid_coords(n_th, n_td, n_pd, theta_h, theta_d, phi_d):
    """Continuous cell-centred grid coordinates (u_th, u_td, u_pd): theta_h
    sqrt-warped, phi_d folded mod pi (reciprocity)."""
    u_th = torch.sqrt(torch.clamp(theta_h / HALF_PI, min=0.0)) * n_th - 0.5
    u_td = theta_d / HALF_PI * n_td - 0.5
    phi_d = torch.where(phi_d < 0.0, phi_d + torch.pi, phi_d)
    u_pd = phi_d / torch.pi * n_pd - 0.5
    return u_th, u_td, u_pd


def _stacked(table):
    return table if table.dim() == 5 else table.unsqueeze(0)


def eval_trilinear_plain(table, wi, wo, slot=None, mask=None):
    """Plain PyTorch K1: f(wi, wo) (no cosine) per lane, (N, 3).

    table: (n_th, n_td, n_pd, 3) or stacked (n_mat, ...); slot: (N,)
    material index (None = 0); mask: (N,) bool (None = all lanes).
    The eval_raw trilinear formula, with `_fast` angles and eval_packed's
    border clamping.
    """
    tbl = _stacked(table)
    n_mat, n_th, n_td, n_pd = tbl.shape[:4]
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    if mask is not None:
        valid = valid & mask
    theta_h, theta_d, phi_d = dirs_to_half_diff_fast(wi, wo)
    u_th, u_td, u_pd = grid_coords(n_th, n_td, n_pd, theta_h, theta_d, phi_d)

    def cell(u, n):
        # clamped in float, so NaN coordinates of masked lanes stay harmless
        i = torch.clamp(torch.floor(u), 0.0, float(n - 2))
        i = torch.where(valid, i, 0.0)
        return i.long(), torch.clamp(u - i, 0.0, 1.0)

    i0, fth = cell(u_th, n_th)
    j0, ftd = cell(u_td, n_td)
    k0f = torch.where(valid, torch.floor(u_pd), 0.0)
    fpd = u_pd - k0f
    k0 = k0f.long() % n_pd
    k1 = (k0 + 1) % n_pd
    s = (torch.zeros_like(i0) if slot is None
         else torch.where(valid, slot.long().clamp(0, n_mat - 1), 0))

    flat = tbl.reshape(-1, 3)

    def corner(a, b, k):
        return flat[((s * n_th + i0 + a) * n_td + j0 + b) * n_pd + k]

    wpd1, wpd0 = fpd[..., None], (1.0 - fpd)[..., None]
    wtd1, wtd0 = ftd[..., None], (1.0 - ftd)[..., None]
    wth1, wth0 = fth[..., None], (1.0 - fth)[..., None]
    c00 = corner(0, 0, k0) * wpd0 + corner(0, 0, k1) * wpd1
    c01 = corner(0, 1, k0) * wpd0 + corner(0, 1, k1) * wpd1
    c10 = corner(1, 0, k0) * wpd0 + corner(1, 0, k1) * wpd1
    c11 = corner(1, 1, k0) * wpd0 + corner(1, 1, k1) * wpd1
    c0 = c00 * wtd0 + c01 * wtd1
    c1 = c10 * wtd0 + c11 * wtd1
    val = c0 * wth0 + c1 * wth1
    return torch.where(valid[..., None], torch.clamp(val, min=0.0), 0.0)


def eval_trilinear(table, wi, wo, slot=None, mask=None):
    """K1 wrapper: f(wi, wo) (no cosine), (N, 3) float32.

    CPU tensors run eval_trilinear_plain; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    if not wi.is_cuda:
        return eval_trilinear_plain(table, wi, wo, slot, mask)
    tbl = _stacked(table).contiguous()
    n_mat, n_th, n_td, n_pd, c = tbl.shape
    n = wi.shape[0]
    if (tbl.dtype != torch.float32 or c != 3 or n_th < 2 or n_td < 2
            or wi.shape != (n, 3) or wo.shape != (n, 3)
            or wi.dtype != torch.float32 or wo.dtype != torch.float32):
        raise ValueError("eval_trilinear: unsupported table or direction shape")
    if not (tbl.is_cuda and wo.is_cuda):
        raise ValueError("eval_trilinear: all tensors must be on the GPU")
    wi, wo = wi.contiguous(), wo.contiguous()
    slot32 = None if slot is None else slot.to(torch.int32).contiguous()
    mask8 = None if mask is None else mask.to(torch.uint8).contiguous()
    for t in (slot32, mask8):
        if t is not None and t.shape != (n,):
            raise ValueError("eval_trilinear: slot/mask must be (N,)")
    out = torch.empty((n, 3), dtype=torch.float32, device=wi.device)
    err = build.library().mct_merl_eval(
        build.ptr(tbl), n_mat, n_th, n_td, n_pd, build.ptr(wi), build.ptr(wo),
        None if slot32 is None else build.ptr(slot32),
        None if mask8 is None else build.ptr(mask8),
        build.ptr(out), n, build.stream_of(wi),
    )
    build.check(err, "merl_eval")
    LAUNCHES += 1
    return out
