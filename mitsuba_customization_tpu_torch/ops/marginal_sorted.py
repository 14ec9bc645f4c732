"""K2: conditional-CDF inversion and cell masses, one CUDA thread per lane.

Replaces the TPU kernel mitsuba_customization_tpu/ops/marginal_sorted.py
`_cond_kernel` (launched by `_cond_impl`, reached through
`cond_sample_pdf` from `tabulated.bounce_shade`). The TPU version sorts
lanes by CDF slice, DMAs each slice transposed (row axis on the 128-lane
axis, padded with 2.0) and unsorts; none of that is needed here.

What bounds it on the H100: the L2 sectors each lane touches in its
W-float row of the conditional CDF (a material's whole sampling stack,
256 KB, stays in L2), and the lane I/O. The kernel keeps the
(n_slices, H, W) layout and finds the count of values below u by binary
search in the (nondecreasing) row: ceil(log2 W) one-sector loads instead
of W. It reads the int64 indices, the bool mask and the strided u column
as the caller holds them, so a call is one launch. The outputs are
sampling quantities consumed detached, so there is no backward.

`cond_sample_pdf` picks by device: a CPU tensor goes to the plain PyTorch
version `cond_sample_pdf_plain`, a CUDA tensor to the kernel (or it raises).
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.core.distr import _TINY, _invert_cdf
from mitsuba_customization_tpu_torch.ops import build

SOURCE = "mitsuba_customization_tpu_torch/csrc/cond_sample.cu"

# Kernel launches in this process (the wrapper adds one per launch).
LAUNCHES = 0


def cond_sample_pdf_plain(cdf_cond, slice_key, u_col, r_own, r_nee, c_nee,
                          r_cos, c_cos, valid):
    """Plain PyTorch K2 -> (x, mass_own, mass_nee, mass_cos), each (N,).

    cdf_cond: (n_slices, H, W) conditional CDFs. Row (slice_key, r_own) is
    inverted at u_col: x in [0, 1] is the sampled column position and
    mass_own that cell's mass. mass_nee / mass_cos are the cell masses at
    (r_nee, c_nee) / (r_cos, c_cos) of the same slice. Invalid lanes give 0.
    """
    n_sl, h, w = cdf_cond.shape

    def idx(a, hi):
        return torch.where(valid, a.long().clamp(0, hi - 1), 0)

    s = idx(slice_key, n_sl)
    col, lo, mass = _invert_cdf(cdf_cond[s, idx(r_own, h)], u_col)
    dx = torch.clamp((u_col - lo) / torch.clamp(mass, min=_TINY), 0.0, 1.0 - 1e-7)
    x = (col.to(torch.float32) + dx) / w

    def cell_mass(r, c):
        r, c = idx(r, h), idx(c, w)
        hi = cdf_cond[s, r, c]
        lo_ = torch.where(c > 0, cdf_cond[s, r, (c - 1).clamp(min=0)], 0.0)
        return hi - lo_

    outs = (x, mass, cell_mass(r_nee, c_nee), cell_mass(r_cos, c_cos))
    return tuple(torch.where(valid, v, 0.0) for v in outs)


def cond_sample_pdf(cdf_cond, slice_key, u_col, r_own, r_nee, c_nee, r_cos,
                    c_cos, valid):
    """K2 wrapper; see cond_sample_pdf_plain for the contract. The rows of
    cdf_cond must be nondecreasing (Marginal2D.build makes them so).

    CPU tensors run the plain version; CUDA tensors launch the kernel. It
    reads int64 indices, a bool `valid` and a strided float32 `u_col` in
    place; other integer index types are converted to int64 first.
    """
    global LAUNCHES
    if not u_col.is_cuda:
        return cond_sample_pdf_plain(cdf_cond, slice_key, u_col, r_own,
                                     r_nee, c_nee, r_cos, c_cos, valid)
    if cdf_cond.dim() != 3 or cdf_cond.dtype != torch.float32:
        raise ValueError("cond_sample_pdf: cdf_cond must be (S, H, W) float32")
    n_sl, h, w = cdf_cond.shape
    n = u_col.shape[0]
    if u_col.dim() != 1 or u_col.dtype != torch.float32:
        raise ValueError("cond_sample_pdf: u_col must be (N,) float32")
    if valid.dtype != torch.bool:
        raise ValueError("cond_sample_pdf: valid must be bool")
    cdf = cdf_cond.contiguous()
    ints = [a.long().contiguous()
            for a in (slice_key, r_own, r_nee, c_nee, r_cos, c_cos)]
    ok = valid.contiguous()
    for t in ints + [ok]:
        if t.shape != (n,) or t.device != u_col.device:
            raise ValueError("cond_sample_pdf: lane inputs must be (N,) on the GPU")
    if cdf.device != u_col.device:
        raise ValueError("cond_sample_pdf: cdf_cond must be on the GPU")
    outs = torch.empty((4, n), dtype=torch.float32, device=u_col.device)
    key, ro, rn, cn, rc, cc = ints
    err = build.library().mct_cond_sample(
        build.ptr(cdf), n_sl, h, w, build.ptr(key), build.ptr(u_col),
        u_col.stride(0), build.ptr(ro), build.ptr(rn), build.ptr(cn),
        build.ptr(rc), build.ptr(cc), build.ptr(ok), build.ptr(outs), n,
        build.stream_of(u_col),
    )
    build.check(err, "cond_sample")
    LAUNCHES += 1
    return tuple(outs)
