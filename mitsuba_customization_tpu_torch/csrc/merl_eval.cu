// K1: per-lane trilinear evaluation of a stacked MERL/tabulated BRDF table.
//
// Replaces the TPU kernel mitsuba_customization_tpu/ops/merl_sorted.py
// `_segment_kernel` (sort lanes by cell -> segment walk over DMA'd slabs ->
// unsort). On the H100 one thread per lane is enough: the table stays in
// its natural (n_mat, n_th, n_td, n_pd, 3) float32 layout, one MERL
// material is 17.5 MB and fits in the 50 MB L2, and each lane reads its
// 4 (theta_h, theta_d) corner rows as 2 x 3 contiguous floats (phi_d bins
// k0 and k1). The cost is bound by those scattered L2 reads, not by
// arithmetic; the kernel issues them all up front from registers and
// needs no shared memory, sort or unsort.
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

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void merl_eval_kernel(const float* __restrict__ table, int n_mat,
                                 int n_th, int n_td, int n_pd,
                                 const float* __restrict__ wi,
                                 const float* __restrict__ wo,
                                 const int32_t* __restrict__ slot,
                                 const uint8_t* __restrict__ mask,
                                 float* __restrict__ out, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float ix = wi[3 * lane], iy = wi[3 * lane + 1], iz = wi[3 * lane + 2];
  const float ox = wo[3 * lane], oy = wo[3 * lane + 1], oz = wo[3 * lane + 2];
  const bool valid =
      iz > 0.f && oz > 0.f && (mask == nullptr || mask[lane] != 0);
  float res[3] = {0.f, 0.f, 0.f};
  if (valid) {
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

    int s = slot ? slot[lane] : 0;
    s = s < 0 ? 0 : (s >= n_mat ? n_mat - 1 : s);
    const int64_t row = (int64_t)n_pd * 3;  // floats per (i, j) cell row
    const float* c00 = table + (((int64_t)s * n_th + i0) * n_td + j0) * row;
    const float* c01 = c00 + row;                  // (i0, j0 + 1)
    const float* c10 = c00 + (int64_t)n_td * row;  // (i0 + 1, j0)
    const float* c11 = c10 + row;                  // (i0 + 1, j0 + 1)
    const int a = 3 * k0, b = 3 * k1;
    const float wpd0 = 1.f - fpd, wtd0 = 1.f - ftd, wth0 = 1.f - fth;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v00 = __ldg(c00 + a + c) * wpd0 + __ldg(c00 + b + c) * fpd;
      const float v01 = __ldg(c01 + a + c) * wpd0 + __ldg(c01 + b + c) * fpd;
      const float v10 = __ldg(c10 + a + c) * wpd0 + __ldg(c10 + b + c) * fpd;
      const float v11 = __ldg(c11 + a + c) * wpd0 + __ldg(c11 + b + c) * fpd;
      const float v0 = v00 * wtd0 + v01 * ftd;
      const float v1 = v10 * wtd0 + v11 * ftd;
      res[c] = fmaxf(v0 * wth0 + v1 * fth, 0.f);
    }
  }
  out[3 * lane] = res[0];
  out[3 * lane + 1] = res[1];
  out[3 * lane + 2] = res[2];
}

}  // namespace

// table: (n_mat, n_th, n_td, n_pd, 3) float32; wi, wo, out: (n, 3) float32;
// slot: (n,) int32 or NULL (material 0); mask: (n,) uint8 or NULL (all set).
extern "C" int mct_merl_eval(const float* table, int n_mat, int n_th,
                             int n_td, int n_pd, const float* wi,
                             const float* wo, const int32_t* slot,
                             const uint8_t* mask, float* out, int64_t n,
                             cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    merl_eval_kernel<<<blocks, threads, 0, stream>>>(
        table, n_mat, n_th, n_td, n_pd, wi, wo, slot, mask, out, n);
  }
  return (int)cudaGetLastError();
}
