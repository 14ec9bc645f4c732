"""The BSDF stage of a bounce around K1 and K2, as two CUDA kernels.

`bsdf_shade_pre` and `bsdf_shade_post` (csrc/bsdf_shade.cu) replace no
TPU kernel: the JAX package leaves this stage to XLA's fusion. They run on
CUDA tensors the work that models/bsdf.py `_bounce_shade_plain` does as
~900 plain PyTorch passes a bounce: one thread a lane over every lane,
the lane I/O the bound. models/bsdf.py `_bounce_shade_fused` calls them:

    shade_pre -> K2 (marginal_sorted.cond_sample_pdf) -> shade_post
      -> K1 (tabulated.eval_f, both halves) -> f2 * scales

shade_pre computes every output of the diffuse and rough-conductor (GGX,
Beckmann) lanes: sample at (sample2, sample1), eval and pdf toward wo_nee,
as models/diffuse.py and models/roughconductor.py do. For the tabulated
lanes it computes what models/tabulated.bounce_shade does before K2 and
writes K2's inputs (int64 indices, a bool mask) and the state shade_post
reads. shade_post computes the tabulated lanes' direction and pdfs from
K2's outputs, K1's second mask, and the scales that turn K1's f into
f_nee and the weight. Lanes of no fused kernel come back 0.

The plain version of the stage is `_bounce_shade_plain` (today's
per-kernel code, which every CPU call runs); the GPU tests hold the
kernels to it on CUDA tensors. These wrappers take CUDA tensors only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mitsuba_customization_tpu_torch.ops import build

SOURCE = "mitsuba_customization_tpu_torch/csrc/bsdf_shade.cu"

# Kernel launches in this process (each wrapper adds one per launch).
LAUNCHES = {"pre": 0, "post": 0}

STATE_ROWS = 9  # csrc/bsdf_shade.cu kStateRows

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


class _Rough(ctypes.Structure):
    _fields_ = [("alpha_u", _P), ("alpha_v", _P), ("eta", _P), ("k", _P), ("spec", _P),
                ("n", _I64)]


class _PreArgs(ctypes.Structure):
    _fields_ = [
        ("n", _I64), ("mat_id", _P), ("mat_type", _P), ("mat_slot", _P), ("n_mat", _I64),
        ("wi", _P), ("wo_nee", _P), ("sample2", _P), ("sample1", _P), ("active", _P),
        ("nee_mask", _P), ("has_nee", _I32), ("kid_diffuse", _I32), ("kid_ggx", _I32),
        ("kid_beckmann", _I32), ("kid_tab", _I32), ("reflectance", _P), ("n_diffuse", _I64),
        ("ggx", _Rough), ("beckmann", _Rough), ("cdf_row", _P), ("n_tab", _I64),
        ("n_theta_i", _I32), ("res_h", _I32), ("res_phi", _I32), ("out", _P),
        ("is_delta", _P), ("idx", _P), ("valid", _P), ("flags", _P), ("state", _P),
        ("masks", _P), ("scales", _P),
    ]


class _PostArgs(ctypes.Structure):
    _fields_ = [
        ("n", _I64), ("flags", _P), ("state", _P), ("r_own", _P), ("x", _P),
        ("mass_own", _P), ("mass_nee", _P), ("mass_cos", _P), ("sample2", _P),
        ("remap", _I32), ("res_h", _I32), ("res_phi", _I32), ("wo", _P), ("pdf_s", _P),
        ("pdf_nee", _P), ("mask_b", _P), ("s_s", _P),
    ]


class Fused(NamedTuple):
    """The kernels' per-kernel inputs: (kernel id, parameter stack), None
    where the kernel is absent or not fused. tabulated: (kernel id,
    Marginal2D of the sampling)."""

    diffuse: Optional[tuple] = None
    ggx: Optional[tuple] = None
    beckmann: Optional[tuple] = None
    tabulated: Optional[tuple] = None


class Pre(NamedTuple):
    """shade_pre's outputs: the six of bounce_shade (f_nee, pdf_nee, wo,
    pdf_s, weight, is_delta), final for the analytic lanes; and, with a
    tabulated kernel, K2's inputs (idx rows key, r_own, r_nee, c_nee,
    r_cos, c_cos, then K1's slot; valid), what shade_post reads (flags,
    state) and K1's masks and the scales (2, n) each: row 0 the NEE half's
    (from shade_pre), row 1 the sampled half's (from shade_post)."""

    f_nee: torch.Tensor
    pdf_nee: torch.Tensor
    wo: torch.Tensor
    pdf_s: torch.Tensor
    weight: torch.Tensor
    is_delta: torch.Tensor
    idx: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    flags: Optional[torch.Tensor] = None
    state: Optional[torch.Tensor] = None
    masks: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    res: tuple = (0, 0)  # the sampling grid's rows and columns (res_h, res_phi)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lane(t, n, dtype, width, what):
    """A lane input as the kernels read it: (n,) or (n, width), contiguous,
    on the CUDA device."""
    shape = (n,) if width is None else (n, width)
    if t.shape != shape or t.dtype != dtype or not t.is_cuda:
        raise ValueError(f"bsdf_shade: {what} must be {tuple(shape)} {dtype} on the GPU")
    return t.contiguous()


def _rough(entry, dev):
    if entry is None:
        return -1, _Rough(), ()
    kid, p = entry
    fields = [f.detach().contiguous() for f in p]
    au, av, eta, k, spec = fields
    n = au.shape[0]
    if (au.shape != (n,) or av.shape != (n,) or any(f.shape != (n, 3) for f in (eta, k, spec))
            or any(f.dtype != torch.float32 or f.device != dev for f in fields)):
        raise ValueError("bsdf_shade: rough-conductor parameters must be (M,) / (M, 3) float32")
    return kid, _Rough(*(f.data_ptr() for f in fields), n), fields


def shade_pre(mat_type, mat_slot, mat_id, wi, wo_nee, sample2, sample1, active, nee_mask,
              has_nee, fused: Fused) -> Pre:
    """bsdf_shade_pre over every lane (one launch); see the module docstring.
    mat_type / mat_slot: the BSDFTable's (M,) int64; mat_id (N,); wi, wo_nee
    (N, 3) float32; sample2 (N, 2); sample1 (N,) or None; active, nee_mask
    (N,) bool or None (all)."""
    n = wi.shape[0]
    dev = wi.device
    wi = _lane(wi, n, torch.float32, 3, "wi")
    wo_nee = _lane(wo_nee, n, torch.float32, 3, "wo_nee")
    sample2 = _lane(sample2, n, torch.float32, 2, "sample2")
    sample1 = None if sample1 is None else _lane(sample1, n, torch.float32, None, "sample1")
    mat_id = _lane(mat_id.long(), n, torch.int64, None, "mat_id")
    active = None if active is None else _lane(active, n, torch.bool, None, "active")
    nee_mask = None if nee_mask is None else _lane(nee_mask, n, torch.bool, None, "nee_mask")
    mat_type, mat_slot = mat_type.long().contiguous(), mat_slot.long().contiguous()
    if mat_type.device != dev or mat_slot.shape != mat_type.shape:
        raise ValueError("bsdf_shade: mat_type / mat_slot must be (M,) on the lanes' GPU")

    kid_d, refl = -1, None
    if fused.diffuse is not None:
        kid_d, p = fused.diffuse
        refl = p.reflectance.detach().contiguous()
        if (refl.dim() != 2 or refl.shape[1] != 3 or refl.dtype != torch.float32
                or refl.device != dev):
            raise ValueError("bsdf_shade: diffuse reflectance must be (M, 3) float32")
    # the fields stay referenced here until the launch is enqueued
    kid_g, ggx, f_g = _rough(fused.ggx, dev)
    kid_b, beck, f_b = _rough(fused.beckmann, dev)

    out = torch.empty(11 * n, dtype=torch.float32, device=dev)
    pre = dict(f_nee=out[:3 * n].view(n, 3), pdf_nee=out[3 * n:4 * n],
               wo=out[4 * n:7 * n].view(n, 3), pdf_s=out[7 * n:8 * n],
               weight=out[8 * n:].view(n, 3),
               is_delta=torch.empty(n, dtype=torch.bool, device=dev))
    kid_t, cdf_row, n_th, res_h, res_phi = -1, None, 0, 0, 0
    if fused.tabulated is not None:
        kid_t, sampling = fused.tabulated
        cdf_row = sampling.cdf_row.detach().contiguous()
        n_th, res_h = cdf_row.shape[-2:]
        res_phi = sampling.cdf_cond.shape[-1]
        if cdf_row.dtype != torch.float32 or cdf_row.device != dev:
            raise ValueError("bsdf_shade: the tabulated CDFs must be float32 on the GPU")
        pre.update(idx=torch.empty((7, n), dtype=torch.int64, device=dev),
                   valid=torch.empty(n, dtype=torch.bool, device=dev),
                   flags=torch.empty(n, dtype=torch.uint8, device=dev),
                   state=torch.empty((STATE_ROWS, n), dtype=torch.float32, device=dev),
                   masks=torch.empty((2, n), dtype=torch.bool, device=dev),
                   scales=torch.empty((2, n), dtype=torch.float32, device=dev),
                   res=(res_h, res_phi))
    pre = Pre(**pre)
    args = _PreArgs(
        n, mat_id.data_ptr(), mat_type.data_ptr(), mat_slot.data_ptr(), mat_type.shape[0],
        wi.data_ptr(), wo_nee.data_ptr(), sample2.data_ptr(), _ptr(sample1), _ptr(active),
        _ptr(nee_mask), int(bool(has_nee)), kid_d, kid_g, kid_b, kid_t, _ptr(refl),
        0 if refl is None else refl.shape[0], ggx, beck, _ptr(cdf_row),
        0 if cdf_row is None else cdf_row.numel() // max(n_th * res_h, 1), n_th, res_h,
        res_phi, out.data_ptr(), pre.is_delta.data_ptr(), _ptr(pre.idx), _ptr(pre.valid),
        _ptr(pre.flags), _ptr(pre.state), _ptr(pre.masks), _ptr(pre.scales))
    err = build.library().mct_bsdf_shade_pre(ctypes.byref(args), build.stream_of(wi))
    build.check(err, "bsdf_shade_pre")
    LAUNCHES["pre"] += 1
    return pre


def shade_post(pre: Pre, k2, sample2, remap):
    """bsdf_shade_post over every lane (one launch): writes the tabulated
    lanes' wo, pdf_s and pdf_nee into pre's outputs, K1's second mask
    (pre.masks[1]) and the sampled half's scale (pre.scales[1]) in place.
    k2: K2's four outputs (x, mass_own, mass_nee, mass_cos), (N,) each;
    remap: no sample1 was given (sample2[..., 0] picked the branch)."""
    n = pre.wo.shape[0]
    k2 = [_lane(t, n, torch.float32, None, "K2's outputs") for t in k2]
    sample2 = _lane(sample2, n, torch.float32, 2, "sample2")
    args = _PostArgs(
        n, pre.flags.data_ptr(), pre.state.data_ptr(), pre.idx[1].data_ptr(),
        *(t.data_ptr() for t in k2), sample2.data_ptr(), int(bool(remap)), *pre.res,
        pre.wo.data_ptr(), pre.pdf_s.data_ptr(), pre.pdf_nee.data_ptr(),
        pre.masks[1].data_ptr(), pre.scales[1].data_ptr())
    err = build.library().mct_bsdf_shade_post(ctypes.byref(args), build.stream_of(pre.wo))
    build.check(err, "bsdf_shade_post")
    LAUNCHES["post"] += 1
