// K1: per-lane trilinear evaluation of a stacked MERL/tabulated BRDF table.
//
// Replaces the TPU kernel mitsuba_customization_tpu/ops/merl_sorted.py
// `_segment_kernel` (sort lanes by cell -> segment walk over DMA'd slabs ->
// unsort). On the H100 one thread per lane computes its angles, cell and
// fractions in registers and gathers its 8 corner bins; no sort, no unsort.
//
// What bounds it: the table gathers and, on wavefronts whose lanes are
// mostly masked, the lane I/O. The table stays in its natural (n_mat, n_th,
// n_td, n_pd, 3) float32 layout, the most compact one: in a frame nearby
// lanes share cells, so what L2 keeps of a stack (175 MB for ten MERL
// materials, past the 50 MB L2) decides. Copies padded so that a corner
// is aligned float4 loads (4/3 and 8/3 of the memory) were no faster in
// the matpreview frame and slower in the flagship's. A phi_d bin's 3
// floats are read as two aligned float2 loads, which touch exactly the
// sectors the 3 floats lie in: 16 loads a lane instead of 24, all issued
// together. A masked lane reads only its mask and writes zeros. A call
// may evaluate two halves that share wi and the slot, [wi ; wi] x
// [wo_a ; wo_b] (blockIdx.y picks the half), so the caller concatenates
// nothing; the int64 slot and bool masks are read in place.
//
// Semantics (see models/tabulated.py and ops/merl_sorted.py in the port):
//   angles  = dirs_to_half_diff_fast(wi, wo)     (3 transcendentals)
//   coords  = _grid_coords (sqrt-warped theta_h, phi_d folded mod pi)
//   clamp   = eval_packed: i0 in [0, n_th-2], j0 in [0, n_td-2], clamped
//             fractions; phi_d wraps with k1 = (k0 + 1) mod n_pd
//   result  = max(trilinear, 0) where cos(wi) > 0, cos(wo) > 0 and the
//             lane mask is set, else 0. Fractions are full float32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr int kThreads = 256;

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

// one channel: phi_d first (a = bin k0, b = bin k1), then theta_d, theta_h
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
  return fmaxf(v0 * wth0 + v1 * fth, 0.f);
}

template <bool kOddTotal>
__device__ void eval_lane(const float* __restrict__ table, int n_mat,
                          int n_th, int n_td, int n_pd, const float* i,
                          const float* o, int64_t slot, float* res) {
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
  const float fth = clampf(u_th - (float)i0, 0.f, 1.f);
  const float ftd = clampf(u_td - (float)j0, 0.f, 1.f);
  const float k0f = floorf(u_pd);
  const float fpd = u_pd - k0f;
  int k0 = (int)k0f % n_pd;
  if (k0 < 0) k0 += n_pd;
  const int k1 = (k0 + 1 == n_pd) ? 0 : k0 + 1;  // phi_d wraps

  const int64_t s = slot < 0 ? 0 : (slot >= n_mat ? n_mat - 1 : slot);
  const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
  const int64_t row = (int64_t)n_pd * 3;  // floats per (i, j) cell row
  const int64_t c00 = ((s * n_th + i0) * n_td + j0) * row;
  const int64_t c01 = c00 + row;                  // (i0, j0 + 1)
  const int64_t c10 = c00 + (int64_t)n_td * row;  // (i0 + 1, j0)
  const int64_t c11 = c10 + row;                  // (i0 + 1, j0 + 1)
  const int a = 3 * k0, b = 3 * k1;
  const Rgb a00 = bin_rgb<kOddTotal>(table, c00 + a, total);
  const Rgb b00 = bin_rgb<kOddTotal>(table, c00 + b, total);
  const Rgb a01 = bin_rgb<kOddTotal>(table, c01 + a, total);
  const Rgb b01 = bin_rgb<kOddTotal>(table, c01 + b, total);
  const Rgb a10 = bin_rgb<kOddTotal>(table, c10 + a, total);
  const Rgb b10 = bin_rgb<kOddTotal>(table, c10 + b, total);
  const Rgb a11 = bin_rgb<kOddTotal>(table, c11 + a, total);
  const Rgb b11 = bin_rgb<kOddTotal>(table, c11 + b, total);
  res[0] = trilinear(a00.r, b00.r, a01.r, b01.r, a10.r, b10.r, a11.r, b11.r,
                     fpd, ftd, fth);
  res[1] = trilinear(a00.g, b00.g, a01.g, b01.g, a10.g, b10.g, a11.g, b11.g,
                     fpd, ftd, fth);
  res[2] = trilinear(a00.b, b00.b, a01.b, b01.b, a10.b, b10.b, a11.b, b11.b,
                     fpd, ftd, fth);
}

template <bool kOddTotal>
__global__ void __launch_bounds__(kThreads) merl_eval_kernel(
    const float* __restrict__ table, int n_mat, int n_th, int n_td, int n_pd,
    const float* __restrict__ wi, const float* __restrict__ wo_a,
    const float* __restrict__ wo_b, const int64_t* __restrict__ slot,
    const uint8_t* __restrict__ mask_a, const uint8_t* __restrict__ mask_b,
    float* __restrict__ out, int64_t n) {
  const bool second = blockIdx.y != 0;
  const float* wo = second ? wo_b : wo_a;
  const uint8_t* mask = second ? mask_b : mask_a;
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  float res[3] = {0.f, 0.f, 0.f};
  // a masked lane returns 0 whatever its directions: it reads nothing more
  if (mask == nullptr || mask[lane] != 0) {
    const float i[3] = {__ldg(wi + 3 * lane), __ldg(wi + 3 * lane + 1),
                        __ldg(wi + 3 * lane + 2)};
    const float o[3] = {__ldg(wo + 3 * lane), __ldg(wo + 3 * lane + 1),
                        __ldg(wo + 3 * lane + 2)};
    if (i[2] > 0.f && o[2] > 0.f) {
      eval_lane<kOddTotal>(table, n_mat, n_th, n_td, n_pd, i, o,
                           slot ? slot[lane] : 0, res);
    }
  }
  float* dst = out + 3 * ((second ? n : 0) + lane);
  dst[0] = res[0];
  dst[1] = res[1];
  dst[2] = res[2];
}

}  // namespace

// table: (n_mat, n_th, n_td, n_pd, 3) float32, 8-B aligned; wi, wo_a,
// wo_b: (n, 3) float32 (wo_b NULL for one half); slot: (n,) int64 or NULL
// (material 0), shared by both halves; mask_a, mask_b: (n,) bool or NULL
// (all set); out: (halves * n, 3) float32.
extern "C" int mct_merl_eval(const float* table, int n_mat, int n_th,
                             int n_td, int n_pd, const float* wi,
                             const float* wo_a, const float* wo_b,
                             const int64_t* slot, const uint8_t* mask_a,
                             const uint8_t* mask_b, float* out, int64_t n,
                             int halves, cudaStream_t stream) {
  if (n > 0) {
    const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads),
                      (unsigned)halves);
    const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
    auto kernel = total % 2 ? merl_eval_kernel<true> : merl_eval_kernel<false>;
    kernel<<<blocks, kThreads, 0, stream>>>(table, n_mat, n_th, n_td, n_pd, wi,
                                            wo_a, wo_b, slot, mask_a, mask_b,
                                            out, n);
  }
  return (int)cudaGetLastError();
}
