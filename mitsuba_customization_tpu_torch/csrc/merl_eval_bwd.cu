// K1's backward: scatter-add of the cotangent of K1's output into the
// gradient of the stacked MERL/tabulated BRDF table.
//
// The TPU package has no kernel for this: its `eval_trilinear` is a
// jax.custom_vjp whose backward, mitsuba_customization_tpu/ops/
// merl_sorted.py `_eval_bwd`, runs XLA's VJP of `tabulated.eval_raw`, a
// scatter-add of 8 corners x 3 channels per lane. Here one thread per lane
// adds g[lane, c] * w_th * w_td * w_pd at each of the 8 corner bins its
// forward read, with float atomics into the gradient.
//
// The lane's cell, fractions and bins are merl_lane.cuh's, as in K1
// (merl_eval.cu), so the gradient is the exact VJP of what K1 computes. A
// lane adds where it evaluates (cos(wi) > 0, cos(wo) > 0, its mask set)
// and a cotangent passes K1's clamp at 0 (torch.clamp's rule: where the
// value before it is >= 0).
//
// What bounds it on the H100: the atomics, which the L2 serialises where
// lanes share a cell (the specular peak near theta_h = 0), and the lane
// I/O; the gradient bins a call touches are read and written once in L2.
// On 4M random lanes it runs at ~10 % of its byte bound: ~37M vector
// atomics (11 a live lane) at ~75 G/s, the rate the L2 takes them. The
// design, per lane:
// - The clamp test from K1's output (`value`, which the autograd Function
//   saves; under the per-bounce checkpoint its replay recomputes it): a
//   channel > 0 passes as it is, so only a lane with a channel at 0 reads
//   its 96 B of table bins. Exact: K1 writes max(v, 0) of the same v.
//   Without `value` (the standalone form) every lane reads its bins.
// - Vector atomics (float2 / float4 atomicAdd, compute capability 9.x):
//   the phi_d bins k0 and k0 + 1 of a (theta_h, theta_d) corner are 6
//   contiguous floats, added with the widest atomics their address allows
//   (2-4 a corner, 11 a lane on average, in place of 24 scalar ones);
//   where phi_d wraps (k1 = 0) the two bins are 3 floats each (2 atomics
//   each). The alignment is read from the address, so any gradient buffer
//   whose floats are 4-byte aligned works.
// Summing the addends of a warp's lanes that share a cell before one of
// them issues the atomics, and issuing a warp's atomics corner by corner
// from shared memory, were measured and left out: on the AD step's calls
// each took more device time than this form (PERF.md, K1-bwd).
// As in K1, a call may cover two halves that share wi and the slot
// (blockIdx.y picks the half).
#include <cuda_runtime.h>
#include <stdint.h>

#include "merl_lane.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned float_phase(const float* p, unsigned mod) {
  return (unsigned)(((uintptr_t)p >> 2) & (mod - 1));
}

// v[0..6) added to p[0..6) with float4 / float2 atomics where p's address
// is 16- / 8-byte aligned, scalars elsewhere.
__device__ __forceinline__ void add6(float* p, const float* v) {
  switch (float_phase(p, 4)) {
    case 0:
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
      atomicAdd(reinterpret_cast<float2*>(p + 4), make_float2(v[4], v[5]));
      break;
    case 1:
      atomicAdd(p, v[0]);
      atomicAdd(reinterpret_cast<float2*>(p + 1), make_float2(v[1], v[2]));
      atomicAdd(reinterpret_cast<float2*>(p + 3), make_float2(v[3], v[4]));
      atomicAdd(p + 5, v[5]);
      break;
    case 2:
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
      atomicAdd(reinterpret_cast<float4*>(p + 2), make_float4(v[2], v[3], v[4], v[5]));
      break;
    default:
      atomicAdd(p, v[0]);
      atomicAdd(reinterpret_cast<float4*>(p + 1), make_float4(v[1], v[2], v[3], v[4]));
      atomicAdd(p + 5, v[5]);
      break;
  }
}

// v[0..3) added to p[0..3): one float2 and one scalar atomic.
__device__ __forceinline__ void add3(float* p, const float* v) {
  if (float_phase(p, 2) == 0) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    atomicAdd(p + 2, v[2]);
  } else {
    atomicAdd(p, v[0]);
    atomicAdd(reinterpret_cast<float2*>(p + 1), make_float2(v[1], v[2]));
  }
}

template <bool kOddTotal>
__global__ void __launch_bounds__(kThreads) merl_eval_bwd_kernel(
    const float* __restrict__ table, int n_mat, int n_th, int n_td, int n_pd,
    const float* __restrict__ g, const float* __restrict__ wi,
    const float* __restrict__ wo_a, const float* __restrict__ wo_b,
    const int64_t* __restrict__ slot, const uint8_t* __restrict__ mask_a,
    const uint8_t* __restrict__ mask_b, const float* __restrict__ value,
    float* __restrict__ grad, int64_t n) {
  const bool second = blockIdx.y != 0;
  const float* wo = second ? wo_b : wo_a;
  const uint8_t* mask = second ? mask_b : mask_a;
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  // a masked lane reads its mask only
  if (mask != nullptr && mask[lane] == 0) return;
  const int64_t row = (second ? n : 0) + lane;  // the lane's row of g, value
  const float* gl = g + 3 * row;
  float gc[3] = {__ldg(gl), __ldg(gl + 1), __ldg(gl + 2)};
  if (gc[0] == 0.f && gc[1] == 0.f && gc[2] == 0.f) return;
  const float i[3] = {__ldg(wi + 3 * lane), __ldg(wi + 3 * lane + 1),
                      __ldg(wi + 3 * lane + 2)};
  const float o[3] = {__ldg(wo + 3 * lane), __ldg(wo + 3 * lane + 1),
                      __ldg(wo + 3 * lane + 2)};
  if (!(i[2] > 0.f && o[2] > 0.f)) return;
  const merl::Cell cell = merl::lane_cell(n_mat, n_th, n_td, n_pd, i, o,
                                          slot ? slot[lane] : 0);
  // K1's clamp: a channel > 0 in K1's output passes; the others read the
  // value before the clamp from the bins
  bool pass[3] = {false, false, false};
  if (value != nullptr) {
    for (int c = 0; c < 3; ++c) pass[c] = __ldg(value + 3 * row + c) > 0.f;
  }
  if ((!pass[0] && gc[0] != 0.f) || (!pass[1] && gc[1] != 0.f) ||
      (!pass[2] && gc[2] != 0.f)) {
    const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
    const merl::Rgb v = merl::lane_value<kOddTotal>(table, cell, total);
    pass[0] |= v.r >= 0.f;
    pass[1] |= v.g >= 0.f;
    pass[2] |= v.b >= 0.f;
  }
  for (int c = 0; c < 3; ++c) gc[c] = pass[c] ? gc[c] : 0.f;
  if (gc[0] == 0.f && gc[1] == 0.f && gc[2] == 0.f) return;

  // the addends: corner q = 2a + b, phi_d bin k, channel c at 6q + 3k + c
  float add[24];
  const float wth[2] = {1.f - cell.fth, cell.fth};
  const float wtd[2] = {1.f - cell.ftd, cell.ftd};
  const float wpd[2] = {1.f - cell.fpd, cell.fpd};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          add[6 * (2 * a + b) + 3 * k + c] = gc[c] * wth[a] * wtd[b] * wpd[k];
        }
      }
    }
  }

  const bool adjacent = cell.bin1 == cell.bin0 + 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* corner = grad + cell.c[q];
    if (adjacent) {
      add6(corner + cell.bin0, add + 6 * q);
    } else {
      add3(corner + cell.bin0, add + 6 * q);
      add3(corner + cell.bin1, add + 6 * q + 3);
    }
  }
}

}  // namespace

// table: (n_mat, n_th, n_td, n_pd, 3) float32, 8-B aligned; g: (halves * n,
// 3) float32, the cotangent of mct_merl_eval's output; wi, wo_a, wo_b,
// slot, mask_a, mask_b as mct_merl_eval takes them; value: mct_merl_eval's
// output on these lanes, or NULL (the clamp test then reads the bins of
// every lane); grad: the table's shape, float32, added into.
extern "C" int mct_merl_eval_bwd(const float* table, int n_mat, int n_th,
                                 int n_td, int n_pd, const float* g,
                                 const float* wi, const float* wo_a,
                                 const float* wo_b, const int64_t* slot,
                                 const uint8_t* mask_a, const uint8_t* mask_b,
                                 const float* value, float* grad, int64_t n,
                                 int halves, cudaStream_t stream) {
  if (n > 0) {
    const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads),
                      (unsigned)halves);
    const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
    auto kernel = total % 2 ? merl_eval_bwd_kernel<true> : merl_eval_bwd_kernel<false>;
    kernel<<<blocks, kThreads, 0, stream>>>(table, n_mat, n_th, n_td, n_pd, g,
                                            wi, wo_a, wo_b, slot, mask_a,
                                            mask_b, value, grad, n);
  }
  return (int)cudaGetLastError();
}
