// What K1 (merl_eval.cu) and its backward (merl_eval_bwd.cu) compute per
// lane before and while they touch the table: the Rusinkiewicz angles, the
// clamped cell, the fractions and the 8 corner bins. One definition, so the
// backward scatters into exactly the bins, with exactly the weights, that
// the forward read.
//
// Semantics (see models/tabulated.py and ops/merl_sorted.py in the port):
//   angles  = dirs_to_half_diff_fast(wi, wo)     (3 transcendentals)
//   coords  = _grid_coords (sqrt-warped theta_h, phi_d folded mod pi)
//   clamp   = eval_packed: i0 in [0, n_th-2], j0 in [0, n_td-2], clamped
//             fractions; phi_d wraps with k1 = (k0 + 1) mod n_pd
//   value   = trilinear (phi_d, then theta_d, then theta_h), clamped at 0
//
// The arithmetic is plain float arithmetic (nvcc may contract products and
// sums into FMAs), which keeps the forward at its speed. K1-bwd, built from the
// same inline code, takes the same fractions and is the exact VJP of K1;
// the plain versions round otherwise (no FMA, torch's own reductions), so
// an ulp in a fraction may move a sliver of a lane's share of the gradient
// between bins. The backward is therefore checked against K1 itself by the
// linearity identity <K1-bwd(g), d> = <g, K1(d)>, and against its plain
// version in norm (chip_smoke.check_k1_bwd).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace merl {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The 3 floats at `off` from the float2 pairs [e, e + 2) and [e + 2, e + 4),
// e = off rounded down to even: the one extra float shares an 8-byte pair,
// so a sector, with a float that is needed. Only where the table holds an
// odd number of floats (kOddTotal) can the last bin, at an even offset,
// reach one float past the end: there, 3 scalar loads. Without that test
// every load is unconditional and all 16 issue together.
template <bool kOddTotal>
__device__ __forceinline__ Rgb bin_rgb(const float* __restrict__ table,
                                       int64_t off, int64_t total) {
  const int64_t e = off & ~(int64_t)1;
  if (kOddTotal && e + 4 > total) {
    return {__ldg(table + off), __ldg(table + off + 1), __ldg(table + off + 2)};
  }
  const float2 p = __ldg(reinterpret_cast<const float2*>(table + e));
  const float2 q = __ldg(reinterpret_cast<const float2*>(table + e + 2));
  return off != e ? Rgb{p.y, q.x, q.y} : Rgb{p.x, p.y, q.x};
}

// one channel before the clamp: phi_d first (a = bin k0, b = bin k1), then
// theta_d, theta_h
__device__ __forceinline__ float trilinear(float a00, float b00, float a01,
                                           float b01, float a10, float b10,
                                           float a11, float b11, float fpd,
                                           float ftd, float fth) {
  const float wpd0 = 1.f - fpd, wtd0 = 1.f - ftd, wth0 = 1.f - fth;
  const float v00 = a00 * wpd0 + b00 * fpd;
  const float v01 = a01 * wpd0 + b01 * fpd;
  const float v10 = a10 * wpd0 + b10 * fpd;
  const float v11 = a11 * wpd0 + b11 * fpd;
  const float v0 = v00 * wtd0 + v01 * ftd;
  const float v1 = v10 * wtd0 + v11 * ftd;
  return v0 * wth0 + v1 * fth;
}

// A lane's cell: the float offsets of its 8 corner bins, (theta_h,
// theta_d) corner c[2 * a + b] at phi_d bins k0 (+ bin0) and k1 (+ bin1),
// and its fractions.
struct Cell {
  int64_t c[4];
  int bin0, bin1;
  float fth, ftd, fpd;
};

__device__ __forceinline__ Cell lane_cell(int n_mat, int n_th, int n_td,
                                          int n_pd, const float* i,
                                          const float* o, int64_t slot) {
  const float ix = i[0], iy = i[1], iz = i[2];
  const float ox = o[0], oy = o[1], oz = o[2];
  // dirs_to_half_diff_fast
  float hx = ix + ox, hy = iy + oy, hz = iz + oz;
  const float inv = 1.f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-14f));
  hx *= inv;
  hy *= inv;
  hz = clampf(hz * inv, -1.f, 1.f);
  const float st = sqrtf(fmaxf(1.f - hz * hz, 0.f));
  const bool safe = st > 1e-12f;
  const float inv_st = safe ? 1.f / fmaxf(st, 1e-12f) : 0.f;
  const float cphi = safe ? hx * inv_st : 1.f;
  const float sphi = safe ? hy * inv_st : 0.f;
  const float vx = cphi * ix + sphi * iy;
  const float vy = -sphi * ix + cphi * iy;
  const float dx = hz * vx - st * iz;
  const float dz = st * vx + hz * iz;
  const float theta_h = acosf(hz);
  const float theta_d = acosf(clampf(dz, -1.f, 1.f));
  float phi_d = atan2f(vy, dx);

  // _grid_coords (cell-centred)
  const float u_th = sqrtf(fmaxf(theta_h / kHalfPi, 0.f)) * (float)n_th - 0.5f;
  const float u_td = theta_d / kHalfPi * (float)n_td - 0.5f;
  if (phi_d < 0.f) phi_d += kPi;  // reciprocity fold
  const float u_pd = phi_d / kPi * (float)n_pd - 0.5f;

  // eval_packed's border clamping (clamped in float, then converted)
  const int i0 = (int)clampf(floorf(u_th), 0.f, (float)(n_th - 2));
  const int j0 = (int)clampf(floorf(u_td), 0.f, (float)(n_td - 2));
  Cell cell;
  cell.fth = clampf(u_th - (float)i0, 0.f, 1.f);
  cell.ftd = clampf(u_td - (float)j0, 0.f, 1.f);
  const float k0f = floorf(u_pd);
  cell.fpd = u_pd - k0f;
  int k0 = (int)k0f % n_pd;
  if (k0 < 0) k0 += n_pd;
  const int k1 = (k0 + 1 == n_pd) ? 0 : k0 + 1;  // phi_d wraps

  const int64_t s = slot < 0 ? 0 : (slot >= n_mat ? n_mat - 1 : slot);
  const int64_t row = (int64_t)n_pd * 3;  // floats per (i, j) cell row
  cell.c[0] = ((s * n_th + i0) * n_td + j0) * row;  // (i0, j0)
  cell.c[1] = cell.c[0] + row;                       // (i0, j0 + 1)
  cell.c[2] = cell.c[0] + (int64_t)n_td * row;       // (i0 + 1, j0)
  cell.c[3] = cell.c[2] + row;                       // (i0 + 1, j0 + 1)
  cell.bin0 = 3 * k0;
  cell.bin1 = 3 * k1;
  return cell;
}

// The lane's three channels before the clamp, from its 16 float2 reads.
template <bool kOddTotal>
__device__ __forceinline__ Rgb lane_value(const float* __restrict__ table,
                                          const Cell& cell, int64_t total) {
  const Rgb a00 = bin_rgb<kOddTotal>(table, cell.c[0] + cell.bin0, total);
  const Rgb b00 = bin_rgb<kOddTotal>(table, cell.c[0] + cell.bin1, total);
  const Rgb a01 = bin_rgb<kOddTotal>(table, cell.c[1] + cell.bin0, total);
  const Rgb b01 = bin_rgb<kOddTotal>(table, cell.c[1] + cell.bin1, total);
  const Rgb a10 = bin_rgb<kOddTotal>(table, cell.c[2] + cell.bin0, total);
  const Rgb b10 = bin_rgb<kOddTotal>(table, cell.c[2] + cell.bin1, total);
  const Rgb a11 = bin_rgb<kOddTotal>(table, cell.c[3] + cell.bin0, total);
  const Rgb b11 = bin_rgb<kOddTotal>(table, cell.c[3] + cell.bin1, total);
  const float fpd = cell.fpd, ftd = cell.ftd, fth = cell.fth;
  return {trilinear(a00.r, b00.r, a01.r, b01.r, a10.r, b10.r, a11.r, b11.r,
                    fpd, ftd, fth),
          trilinear(a00.g, b00.g, a01.g, b01.g, a10.g, b10.g, a11.g, b11.g,
                    fpd, ftd, fth),
          trilinear(a00.b, b00.b, a01.b, b01.b, a10.b, b10.b, a11.b, b11.b,
                    fpd, ftd, fth)};
}

}  // namespace merl
