"""The emitter stage of a bounce as three CUDA kernels.

`emitter_hit`, `emitter_sample` and `emitter_nee` (csrc/emitter_shade.cu)
replace no TPU kernel: the JAX package leaves this stage to XLA's fusion.
They run on CUDA tensors the work that render/emitters.py's plain
functions do as ~370 PyTorch passes a bounce, one thread a lane over every
lane, for tables of area and constant emitters. render/emitters.py
`hit_term`, `sample_nee` and `nee_term` call them on the fused route:

    hit:    rad * w_mis where the mask holds (eval_hit, pdf_hit_direction,
            eval_background, pdf_miss_direction, mis_weight)
    sample: sample_direction's DirectionSample, the direction in the
            shading frame and the NEE mask (an independent sampler's three
            draws made in the kernel)
    nee:    radiance * w_nee / pdf where the shadow ray is clear

The products with the throughput and the BSDF value stay with the caller.
The plain versions are render/emitters.py's functions, which every CPU
call runs; the GPU tests hold the kernels to them on CUDA tensors. These
wrappers take CUDA tensors only, and hand no gradient back.
"""

from __future__ import annotations

import ctypes

import torch

from mitsuba_customization_tpu_torch.ops import build
from mitsuba_customization_tpu_torch.render.records import DirectionSample

SOURCE = "mitsuba_customization_tpu_torch/csrc/emitter_shade.cu"

# Kernel launches in this process (each wrapper adds one per launch).
LAUNCHES = {"hit": 0, "sample": 0, "nee": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


class _Table(ctypes.Structure):
    _fields_ = [
        ("em_type", _P), ("radiance", _P), ("sel_pmf", _P), ("sel_cdf", _P), ("prim_pmf", _P),
        ("prim_cdf", _P), ("em_prims", _P), ("prim_area", _P), ("prim_to_q", _P),
        ("prim_type", _P), ("p0", _P), ("e1", _P), ("e2", _P), ("n_emitters", _I64),
        ("n_q", _I64), ("background", _I64), ("has_area", _I32), ("sample_area", _I32),
        ("sample_constant", _I32),
    ]


class _HitArgs(ctypes.Structure):
    _fields_ = [
        ("n", _I64), ("table", _Table), ("valid", _P), ("p", _P), ("ng", _P), ("fs", _P),
        ("ft", _P), ("fn", _P), ("wi", _P), ("prim", _P), ("emitter", _P), ("ray_o", _P),
        ("prev_pdf", _P), ("prev_delta", _P), ("mask", _P), ("out", _P),
    ]


class _SampleArgs(ctypes.Structure):
    _fields_ = [
        ("n", _I64), ("table", _Table), ("p_ref", _P), ("fs", _P), ("ft", _P), ("fn", _P),
        ("lane_key", _P), ("dim", _I64), ("u3", _P), ("mask", _P), ("depth_ok", _I32),
        ("refl_only", _I32), ("out", _P), ("flags", _P),
    ]


class _NeeArgs(ctypes.Structure):
    _fields_ = [("n", _I64), ("radiance", _P), ("pdf", _P), ("delta", _P), ("pdf_nee", _P),
                ("vis", _P), ("out", _P)]


def _lane(t, n, dtype, width, what):
    """A lane input as the kernels read it: (n,) or (n, width), contiguous,
    on the CUDA device."""
    shape = (n,) if width is None else (n, width)
    if t.shape != shape or t.dtype != dtype or not t.is_cuda:
        raise ValueError(f"emitter_shade: {what} must be {tuple(shape)} {dtype} on the GPU")
    return t.detach().contiguous()


def _rows(t, shape, dtype, dev, what):
    if t.shape != shape or t.dtype != dtype or t.device != dev:
        raise ValueError(f"emitter_shade: {what} must be {tuple(shape)} {dtype} on the lanes' "
                         "GPU")
    return t.detach().contiguous()


def _table(table, geom, dev):
    """The kernels' Table and the tensors it points into (kept referenced by
    the caller until the launch is enqueued)."""
    from mitsuba_customization_tpu_torch.render.emitters import AREA, CONSTANT

    k, q, p = table.em_type.shape[0], table.em_prims.shape[0], geom.prim_type.shape[0]
    i64, f32 = torch.int64, torch.float32
    rows = [
        _rows(table.em_type, (k,), i64, dev, "em_type"),
        _rows(table.radiance, (k, 3), f32, dev, "radiance"),
        _rows(table.select.pmf, (k,), f32, dev, "the selection pmf"),
        _rows(table.select.cdf, (k,), f32, dev, "the selection cdf"),
        _rows(table.prim_dist.pmf, (k, q), f32, dev, "the prim pmf"),
        _rows(table.prim_dist.cdf, (k, q), f32, dev, "the prim cdf"),
        _rows(table.em_prims, (q,), i64, dev, "em_prims"),
        _rows(table.prim_area, (q,), f32, dev, "prim_area"),
        _rows(table.prim_to_q, (p,), i64, dev, "prim_to_q"),
        _rows(geom.prim_type, (p,), i64, dev, "prim_type"),
        _rows(geom.p0, (p, 3), f32, dev, "p0"),
        _rows(geom.e1, (p, 3), f32, dev, "e1"),
        _rows(geom.e2, (p, 3), f32, dev, "e2"),
    ]
    c = _Table(*(r.data_ptr() for r in rows), k, q, table.background_index,
               int(table.has_area), int(table.has_area and AREA in table.present),
               int(CONSTANT in table.present))
    return c, rows


def _frame(frame, n):
    return [_lane(v, n, torch.float32, 3, "the shading frame") for v in frame]


def hit(table, geom, si, ray_o, prev_pdf, prev_delta, mask):
    """emitter_hit over every lane (one launch): (N, 3) rad * w_mis where
    mask holds, 0 elsewhere. si: the bounce's SurfaceInteraction; ray_o
    (N, 3) the rays' origins; prev_pdf (N,), prev_delta, mask (N,) bool."""
    n = si.p.shape[0]
    dev = si.p.device
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    lanes = [
        _lane(si.valid, n, b8, None, "valid"),
        _lane(si.p, n, f32, 3, "p"),
        _lane(si.n, n, f32, 3, "n"),
        *_frame(si.frame, n),
        _lane(si.wi, n, f32, 3, "wi"),
        _lane(si.prim, n, i64, None, "prim"),
        _lane(si.emitter, n, i64, None, "emitter"),
        _lane(ray_o, n, f32, 3, "ray_o"),
        _lane(prev_pdf, n, f32, None, "prev_pdf"),
        _lane(prev_delta, n, b8, None, "prev_delta"),
        _lane(mask, n, b8, None, "mask"),
    ]
    c_table, rows = _table(table, geom, dev)
    out = torch.empty((n, 3), dtype=f32, device=dev)
    args = _HitArgs(n, c_table, *(t.data_ptr() for t in lanes), out.data_ptr())
    err = build.library().mct_emitter_hit(ctypes.byref(args), build.stream_of(out))
    build.check(err, "emitter_hit")
    LAUNCHES["hit"] += 1
    return out


def sample(table, geom, frame, p_ref, mask, depth_ok, refl_only, *, lane_key=None, dim=0,
           u3=None):
    """emitter_sample over every lane (one launch): (DirectionSample, the
    direction in `frame` (N, 3), nee_ok (N,) bool). The NEE draws: an
    independent sampler's lane keys (N,) int64 and its first draw's
    dimension `dim` (the kernel draws dims dim, dim + 1, dim + 2), or u3
    (N, 3). p_ref (N, 3); mask (N,) bool; depth_ok, refl_only Python
    bools: nee_ok = mask & (pdf > 0) & depth_ok (& wo_local.z > 0 with
    refl_only)."""
    n = p_ref.shape[0]
    dev = p_ref.device
    f32 = torch.float32
    lanes = [_lane(p_ref, n, f32, 3, "p_ref"), *_frame(frame, n)]
    if lane_key is not None:
        key = _lane(lane_key, n, torch.int64, None, "lane_key")
        draws = [key.data_ptr(), int(dim) & 0xFFFFFFFF, None]
    else:
        key = _lane(u3, n, f32, 3, "u3")
        draws = [None, 0, key.data_ptr()]
    mask = _lane(mask, n, torch.bool, None, "mask")
    c_table, rows = _table(table, geom, dev)
    out = torch.empty(12 * n, dtype=f32, device=dev)
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)
    args = _SampleArgs(n, c_table, *(t.data_ptr() for t in lanes), *draws, mask.data_ptr(),
                       int(bool(depth_ok)), int(bool(refl_only)), out.data_ptr(),
                       flags.data_ptr())
    err = build.library().mct_emitter_sample(ctypes.byref(args), build.stream_of(out))
    build.check(err, "emitter_sample")
    LAUNCHES["sample"] += 1
    ds = DirectionSample(d=out[:3 * n].view(n, 3), dist=out[3 * n:4 * n],
                         pdf=out[4 * n:5 * n], radiance=out[5 * n:8 * n].view(n, 3),
                         delta=flags[0], p_area=out[8 * n:9 * n])
    return ds, out[9 * n:].view(n, 3), flags[1]


def nee(radiance, pdf, delta, pdf_nee, vis):
    """emitter_nee over every lane (one launch): (N, 3) radiance * w_nee /
    pdf where vis holds, 0 elsewhere; w_nee = 1 where delta, else the power
    heuristic of pdf against pdf_nee."""
    n = pdf.shape[0]
    f32, b8 = torch.float32, torch.bool
    lanes = [_lane(radiance, n, f32, 3, "radiance"), _lane(pdf, n, f32, None, "pdf"),
             _lane(delta, n, b8, None, "delta"), _lane(pdf_nee, n, f32, None, "pdf_nee"),
             _lane(vis, n, b8, None, "vis")]
    out = torch.empty((n, 3), dtype=f32, device=pdf.device)
    args = _NeeArgs(n, *(t.data_ptr() for t in lanes), out.data_ptr())
    err = build.library().mct_emitter_nee(ctypes.byref(args), build.stream_of(out))
    build.check(err, "emitter_nee")
    LAUNCHES["nee"] += 1
    return out
