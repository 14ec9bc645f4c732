"""K1: trilinear MERL/tabulated-BRDF evaluation, one CUDA thread per lane.

Replaces the TPU kernel mitsuba_customization_tpu/ops/merl_sorted.py
`_segment_kernel` (launched by `_eval_sorted_impl`, reached through
`eval_sorted` / `eval_trilinear` from `tabulated.eval_f`). The TPU version
sorts lanes by table cell, walks the sorted wavefront segment by segment
over DMA'd slabs and unsorts, with 16-bit fixed-point fractions; those are
TPU workarounds for slow per-lane gathers and are not carried over.

What bounds it on the H100: the gathers of 4 corners x 2 phi_d bins x 3
floats per lane from the table (a stack of MERL materials, 17.5 MB each,
exceeds the 50 MB L2), and the lane I/O where most lanes are masked. The
kernel reads the natural (n_mat, n_th, n_td, n_pd, 3) table, whose
compactness lets L2 serve the cells nearby lanes share, each bin as two
aligned float2 loads; a masked lane reads only its mask. One call
evaluates both halves of a bounce (NEE and sampled directions) through
two pointers. Full float32 fractions, no sort.

`eval_trilinear` picks by device: a CPU tensor goes to the plain PyTorch
version `eval_trilinear_plain`, a CUDA tensor to the kernel (or it raises).

The table's gradient (the JAX package's `_eval_bwd`, XLA's VJP of
`eval_raw`) is K1's backward, `eval_trilinear_bwd`: a scatter-add of the
cotangent into the 8 corners of every lane that evaluates, the CUDA kernel
csrc/merl_eval_bwd.cu on the GPU, `eval_trilinear_bwd_plain` (index_add_)
on the CPU. `eval_trilinear` reaches it through an autograd Function only
where grad mode is on and the table requires grad; the primal render calls
the forward directly. The Function hands the backward K1's output, whose
channels > 0 pass K1's clamp without a read of the table. A render's
table enters autograd once, through a GradSink (grad_sink): every K1
backward of the render adds into one buffer, which autograd hands to the
table, in place of a dense gradient per call summed by autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core.rusinkiewicz import (
    dirs_to_half_diff_fast,
)
from mitsuba_customization_tpu_torch.ops import build

SOURCE = "mitsuba_customization_tpu_torch/csrc/merl_eval.cu"
SOURCE_BWD = "mitsuba_customization_tpu_torch/csrc/merl_eval_bwd.cu"

# Kernel launches in this process (each wrapper adds one per launch): K1
# and its backward; and the table-shaped gradient buffers allocated
# (new_grad): one per backward pass of a render through a GradSink.
LAUNCHES = 0
LAUNCHES_BWD = 0
GRAD_BUFFERS = 0

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


def concat_halves(wi, wo, slot=None, mask=None, wo_b=None, mask_b=None):
    """The lanes a K1 call evaluates, as one set (wi, wo, slot, mask): with
    wo_b, [wi ; wi] x [wo ; wo_b], the slot repeated and the masks joined
    (a missing one all set); without, the arguments as they are."""
    if wo_b is None:
        return wi, wo, slot, mask
    if mask is not None or mask_b is not None:
        ones = torch.ones(wi.shape[0], dtype=torch.bool, device=wi.device)
        mask = torch.cat([ones if m is None else m for m in (mask, mask_b)])
    return (torch.cat([wi, wi]), torch.cat([wo, wo_b]),
            None if slot is None else torch.cat([slot, slot]), mask)


def _corners(table, wi, wo, slot=None, mask=None):
    """What K1 computes per lane before it reads the table: (valid, flat
    bin index of the (theta_h, theta_d) corner (0, 0) at phi_d bins k0
    and k1, the bin strides to corners (0, 1) and (1, 0), and the
    fractions (fth, ftd, fpd))."""
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
    row = ((s * n_th + i0) * n_td + j0) * n_pd
    return valid, (row + k0, row + k1), (n_pd, n_td * n_pd), (fth, ftd, fpd)


def _trilinear(flat, bins, strides, fracs):
    """The interpolated value of each lane (N, 3), before the clamp."""
    (b0, b1), (sj, si), (fth, ftd, fpd) = bins, strides, fracs

    def corner(a, b, k):
        return flat[k + a * si + b * sj]

    wpd1, wpd0 = fpd[..., None], (1.0 - fpd)[..., None]
    wtd1, wtd0 = ftd[..., None], (1.0 - ftd)[..., None]
    wth1, wth0 = fth[..., None], (1.0 - fth)[..., None]
    c00 = corner(0, 0, b0) * wpd0 + corner(0, 0, b1) * wpd1
    c01 = corner(0, 1, b0) * wpd0 + corner(0, 1, b1) * wpd1
    c10 = corner(1, 0, b0) * wpd0 + corner(1, 0, b1) * wpd1
    c11 = corner(1, 1, b0) * wpd0 + corner(1, 1, b1) * wpd1
    c0 = c00 * wtd0 + c01 * wtd1
    c1 = c10 * wtd0 + c11 * wtd1
    return c0 * wth0 + c1 * wth1


def eval_trilinear_plain(table, wi, wo, slot=None, mask=None):
    """Plain PyTorch K1: f(wi, wo) (no cosine) per lane, (N, 3).

    table: (n_th, n_td, n_pd, 3) or stacked (n_mat, ...); slot: (N,)
    material index (None = 0); mask: (N,) bool (None = all lanes).
    The eval_raw trilinear formula, with `_fast` angles and eval_packed's
    border clamping.
    """
    valid, *cell = _corners(table, wi, wo, slot, mask)
    val = _trilinear(_stacked(table).reshape(-1, 3), *cell)
    return torch.where(valid[..., None], torch.clamp(val, min=0.0), 0.0)


def _clamp_passes(flat, valid, bins, strides, fracs, value=None):
    """(N, 3) bool: the channels whose cotangent K1's clamp at 0 passes
    (the value before it >= 0, torch.clamp's rule), on lanes that evaluate.
    With `value`, K1's output on these lanes, a channel > 0 passes as it
    is, and only the lanes with another channel read their bins (as the
    kernel does): exact, as an output > 0 means the value before the clamp
    was > 0."""
    if value is None:
        return valid[..., None] & (_trilinear(flat, bins, strides, fracs) >= 0.0)
    passes = valid[..., None] & (value > 0.0)
    idx = (valid & ~passes.all(-1)).nonzero().squeeze(-1)
    if idx.numel():
        sub = _trilinear(flat, tuple(b[idx] for b in bins), strides,
                         tuple(f[idx] for f in fracs))
        passes[idx] |= sub >= 0.0
    return passes


def scatter_pairs(table, g, wi, wo, slot=None, mask=None, value=None):
    """What K1's backward adds into the flat table gradient, as (float
    index (M,), addend (M,)): 24 per lane that evaluates and has a
    cotangent K1's clamp passes (_clamp_passes; `value` as there), g * w_th
    * w_td * w_pd at its 8 corner bins x 3 channels, multiplied in the
    order torch's autograd multiplies them. The same corners and fractions
    as the forward; wi and wo get no gradient."""
    valid, bins, strides, fracs = _corners(table, wi, wo, slot, mask)
    flat = _stacked(table).reshape(-1, 3)
    g = torch.where(_clamp_passes(flat, valid, bins, strides, fracs, value), g, 0.0)
    lanes = (g != 0.0).any(-1).nonzero().squeeze(-1)
    g = g[lanes]
    (fth, ftd, fpd), (b0, b1), (sj, si) = (f[lanes] for f in fracs), bins, strides
    chan = torch.arange(3, device=g.device)
    idx, add = [], []
    for a, wth in ((0, 1.0 - fth), (1, fth)):
        ga = g * wth[..., None]
        for b, wtd in ((0, 1.0 - ftd), (1, ftd)):
            gb = ga * wtd[..., None]
            for k, wpd in ((b0, 1.0 - fpd), (b1, fpd)):
                idx.append(3 * (k[lanes] + a * si + b * sj)[..., None] + chan)
                add.append(gb * wpd[..., None])
    return torch.stack(idx, 1).reshape(-1), torch.stack(add, 1).reshape(-1)


def eval_trilinear_bwd_plain(table, g, wi, wo, slot=None, mask=None, *, value=None,
                             out=None):
    """Plain PyTorch K1 backward: the table's gradient (its shape) from the
    cotangent g (N, 3) of eval_trilinear_plain(table, wi, wo, slot, mask):
    scatter_pairs' addends summed by index_add_ into a new zeroed tensor,
    or into `out` (contiguous, the table's shape), which it returns. value:
    K1's output on these lanes (see _clamp_passes), or None."""
    idx, add = scatter_pairs(table, g, wi, wo, slot, mask, value)
    grad = new_grad(table) if out is None else out
    grad.view(-1).index_add_(0, idx, add)
    return grad


def new_grad(table):
    """A zeroed, contiguous float32 gradient of the table's shape (counted
    in GRAD_BUFFERS)."""
    global GRAD_BUFFERS
    GRAD_BUFFERS += 1
    return torch.zeros(table.shape, dtype=torch.float32, device=table.device)


class _Buffer:
    """The table gradient of one backward pass: allocated by the first K1
    backward that adds into it, handed over once by _Sink."""

    __slots__ = ("grad",)

    def __init__(self):
        self.grad = None


class GradSink(NamedTuple):
    """A table's entry into autograd for K1 (grad_sink): `token`, a 0-d
    tensor computed from the table by _Sink, which every K1 call takes as
    its differentiable input in place of the table; `buf`, where their
    backwards add."""

    token: torch.Tensor
    buf: _Buffer


class _Sink(torch.autograd.Function):
    """table -> a 0-d zero token. Its backward runs after the backward of
    every K1 call that took the token (autograd's order) and returns the
    one buffer they added into as the table's gradient."""

    @staticmethod
    def forward(ctx, table, buf):
        ctx.buf = buf
        return table.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        grad, ctx.buf.grad = ctx.buf.grad, None
        return grad, None


def grad_sink(table):
    """One gradient buffer for every K1 call on `table` in a backward pass:
    a GradSink where grad mode is on and the table requires grad, else
    None. The K1 calls (eval_trilinear(..., sink=)) then add into one
    buffer, which autograd hands to the table once, in place of a dense
    gradient per call and autograd's sum of them."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return None
    buf = _Buffer()
    return GradSink(_Sink.apply(table, buf), buf)


class _EvalTrilinear(torch.autograd.Function):
    """K1 with the table's gradient: the backward is K1's backward kernel
    (eval_trilinear_bwd), handed K1's output for its clamp test. `source`
    is the differentiable input: the table itself (buf None; the backward
    returns the table's gradient) or a GradSink's token (the backward adds
    into its buffer and returns 0 for the token). wi, wo, the slot and the
    masks get no gradient, as in the JAX package's `_eval_bwd`."""

    @staticmethod
    def forward(ctx, source, buf, table, wi, wo, slot, mask, wo_b, mask_b):
        out = _eval(table, wi, wo, slot, mask, wo_b, mask_b)
        ctx.buf = buf
        ctx.save_for_backward(table, out, wi, wo, slot, mask, wo_b, mask_b)
        return out

    @staticmethod
    def backward(ctx, g):
        table, out, *lanes = ctx.saved_tensors
        none = (None,) * 8
        if ctx.buf is None:
            return (eval_trilinear_bwd(table, g, *lanes, value=out),) + none
        if ctx.buf.grad is None:
            ctx.buf.grad = new_grad(table)
        eval_trilinear_bwd(table, g, *lanes, value=out, out=ctx.buf.grad)
        return (g.new_zeros(()),) + none


def eval_trilinear(table, wi, wo, slot=None, mask=None, wo_b=None, mask_b=None,
                   sink=None):
    """K1 wrapper: f(wi, wo) (no cosine), (N, 3) float32. With wo_b the
    call evaluates two halves that share wi and slot, concat_halves(...)'s
    2N lanes, and returns (2N, 3); the kernel reads both halves in place.

    table: (n_th, n_td, n_pd, 3) or stacked (n_mat, ...) float32; slot:
    (N,) material index (None = 0; int64 is read in place); mask, mask_b:
    (N,) bool (None = all lanes). CPU tensors run eval_trilinear_plain;
    CUDA tensors launch the kernel. Where grad mode is on, the call goes
    through _EvalTrilinear, whose backward gives the table's gradient: into
    the sink's buffer with a GradSink of this table (grad_sink), else
    where the table requires grad, as a gradient of its own.
    """
    if torch.is_grad_enabled():
        if sink is not None:
            return _EvalTrilinear.apply(sink.token, sink.buf, table.detach(), wi, wo,
                                        slot, mask, wo_b, mask_b)
        if table.requires_grad:
            return _EvalTrilinear.apply(table, None, table.detach(), wi, wo, slot,
                                        mask, wo_b, mask_b)
    return _eval(table, wi, wo, slot, mask, wo_b, mask_b)


def _kernel_args(what, table, wi, wo, slot, mask, wo_b, mask_b):
    """The checks of a K1 or K1-backward call on the GPU. Returns the
    table as the kernels read it (stacked, contiguous, 8-byte aligned: a
    view at an odd float is copied, as the kernels read float2 pairs), the
    lanes [wi, wo, wo_b or None] contiguous, the slot int64 and the masks."""
    tbl = _stacked(table).contiguous()
    if tbl.data_ptr() % 8:
        tbl = tbl.clone()
    n_mat, n_th, n_td, n_pd, c = tbl.shape
    n = wi.shape[0]
    halves = [wo] if wo_b is None else [wo, wo_b]
    if (tbl.dtype != torch.float32 or c != 3 or n_th < 2 or n_td < 2
            or any(v.shape != (n, 3) or v.dtype != torch.float32
                   for v in [wi] + halves)):
        raise ValueError(f"{what}: unsupported table or direction shape")
    if wo_b is None and mask_b is not None:
        raise ValueError(f"{what}: mask_b without wo_b")
    if slot is not None:
        slot = slot.long().contiguous()
    masks = [None if m is None else m.contiguous() for m in (mask, mask_b)]
    lanes = [v.contiguous() for v in [wi] + halves]
    for t in lanes + [slot] + masks:
        if t is not None and t.device != tbl.device:
            raise ValueError(f"{what}: all tensors must be on the GPU")
    for t in [slot] + masks:
        if t is not None and t.shape != (n,):
            raise ValueError(f"{what}: slot/mask must be (N,)")
    if any(m is not None and m.dtype != torch.bool for m in masks):
        raise ValueError(f"{what}: masks must be bool")
    return tbl, lanes + [None] * (3 - len(lanes)), slot, masks


def _opt(t):
    return None if t is None else build.ptr(t)


def _eval(table, wi, wo, slot, mask, wo_b, mask_b):
    global LAUNCHES
    if not wi.is_cuda:
        return eval_trilinear_plain(table, *concat_halves(wi, wo, slot, mask,
                                                          wo_b, mask_b))
    tbl, lanes, slot, masks = _kernel_args("eval_trilinear", table, wi, wo, slot,
                                           mask, wo_b, mask_b)
    n_mat, n_th, n_td, n_pd, _ = tbl.shape
    n, halves = wi.shape[0], 1 if wo_b is None else 2
    out = torch.empty((halves * n, 3), dtype=torch.float32, device=wi.device)
    err = build.library().mct_merl_eval(
        build.ptr(tbl), n_mat, n_th, n_td, n_pd, build.ptr(lanes[0]),
        build.ptr(lanes[1]), _opt(lanes[2]), _opt(slot), _opt(masks[0]),
        _opt(masks[1]), build.ptr(out), n, halves, build.stream_of(wi),
    )
    build.check(err, "merl_eval")
    LAUNCHES += 1
    return out


def eval_trilinear_bwd(table, g, wi, wo, slot=None, mask=None, wo_b=None,
                       mask_b=None, *, value=None, out=None):
    """K1-backward wrapper: the gradient of the table (its shape, float32)
    from the cotangent g of eval_trilinear(table, wi, wo, slot, mask,
    wo_b, mask_b), (N, 3), or (2N, 3) with wo_b.

    value: K1's output on these lanes (g's shape), or None. With it, the
    clamp test reads the table's bins only on lanes with a channel at 0;
    without, on every lane that evaluates. out: a contiguous float32
    tensor of the table's shape on the same device to add into, which is
    returned; None: a new zeroed one (new_grad). CPU tensors run
    eval_trilinear_bwd_plain on the joined lanes; CUDA tensors launch the
    kernel (float atomics, so the sums' order and last bits vary from run
    to run)."""
    global LAUNCHES_BWD
    if out is not None and (out.shape != table.shape or out.dtype != torch.float32
                            or not out.is_contiguous() or out.device != table.device):
        raise ValueError("eval_trilinear_bwd: out must be a contiguous float32 "
                         "tensor of the table's shape on its device")
    if not wi.is_cuda:
        return eval_trilinear_bwd_plain(table, g, *concat_halves(
            wi, wo, slot, mask, wo_b, mask_b), value=value, out=out)
    tbl, lanes, slot, masks = _kernel_args("eval_trilinear_bwd", table, wi, wo,
                                           slot, mask, wo_b, mask_b)
    n_mat, n_th, n_td, n_pd, _ = tbl.shape
    n, halves = wi.shape[0], 1 if wo_b is None else 2
    g = g.contiguous()
    if g.shape != (halves * n, 3) or g.dtype != torch.float32 or g.device != tbl.device:
        raise ValueError("eval_trilinear_bwd: g must be float32 (halves * N, 3) on the GPU")
    if value is not None:
        value = value.contiguous()
        if value.shape != g.shape or value.dtype != torch.float32 or value.device != g.device:
            raise ValueError("eval_trilinear_bwd: value must be K1's output, g's shape")
    grad = new_grad(table) if out is None else out
    err = build.library().mct_merl_eval_bwd(
        build.ptr(tbl), n_mat, n_th, n_td, n_pd, build.ptr(g),
        build.ptr(lanes[0]), build.ptr(lanes[1]), _opt(lanes[2]), _opt(slot),
        _opt(masks[0]), _opt(masks[1]), _opt(value), build.ptr(grad), n, halves,
        build.stream_of(wi),
    )
    build.check(err, "merl_eval_bwd")
    LAUNCHES_BWD += 1
    return grad
