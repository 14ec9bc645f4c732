// K1's backward: scatter-add of the cotangent of K1's output into the
// gradient of the stacked MERL/tabulated BRDF table.
//
// The TPU package has no kernel for this: its `eval_trilinear` is a
// jax.custom_vjp whose backward, mitsuba_customization_tpu/ops/
// merl_sorted.py `_eval_bwd`, runs XLA's VJP of `tabulated.eval_raw`, a
// scatter-add of 8 corners x 3 channels per lane. Here one thread per lane
// adds g[lane, c] * w_th * w_td * w_pd at each of the 8 corner bins its
// forward read, with float atomics into a zeroed gradient tensor.
//
// The lane's cell, fractions and bins are merl_lane.cuh's, as in K1
// (merl_eval.cu), so the gradient is the exact VJP of what K1 computes. A
// lane adds where it evaluates (cos(wi) > 0, cos(wo) > 0, its mask set)
// and its cotangent is not zero. A channel whose value before K1's clamp
// at 0 is below 0 adds nothing (torch.clamp's rule), so the lane reads its
// bins too.
//
// What bounds it on the H100: the bytes of the table bins (96 B a lane)
// and of the gradient bins each lane updates (96 B read and 96 B written
// by 24 atomics), and the lane I/O. Lanes that share a cell (the specular
// peak near theta_h = 0) contend on the same atomics. Vector atomics
// (float2 / float4 atomicAdd on compute capability 9.x) and a warp
// pre-reduction of lanes that share a cell are left for later; this is the
// simple form. The gradient tensor is allocated by the wrapper, zeroed and
// contiguous; no alignment of its bins is assumed. As in K1, a call may
// cover two halves that share wi and the slot (blockIdx.y picks the half).
#include <cuda_runtime.h>
#include <stdint.h>

#include "merl_lane.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kOddTotal>
__global__ void __launch_bounds__(kThreads) merl_eval_bwd_kernel(
    const float* __restrict__ table, int n_mat, int n_th, int n_td, int n_pd,
    const float* __restrict__ g, const float* __restrict__ wi,
    const float* __restrict__ wo_a, const float* __restrict__ wo_b,
    const int64_t* __restrict__ slot, const uint8_t* __restrict__ mask_a,
    const uint8_t* __restrict__ mask_b, float* __restrict__ grad, int64_t n) {
  const bool second = blockIdx.y != 0;
  const float* wo = second ? wo_b : wo_a;
  const uint8_t* mask = second ? mask_b : mask_a;
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  // a masked lane reads its mask only
  if (mask != nullptr && mask[lane] == 0) return;
  const float* gl = g + 3 * ((second ? n : 0) + lane);
  float gc[3] = {__ldg(gl), __ldg(gl + 1), __ldg(gl + 2)};
  if (gc[0] == 0.f && gc[1] == 0.f && gc[2] == 0.f) return;
  const float i[3] = {__ldg(wi + 3 * lane), __ldg(wi + 3 * lane + 1),
                      __ldg(wi + 3 * lane + 2)};
  const float o[3] = {__ldg(wo + 3 * lane), __ldg(wo + 3 * lane + 1),
                      __ldg(wo + 3 * lane + 2)};
  if (!(i[2] > 0.f && o[2] > 0.f)) return;
  const merl::Cell cell = merl::lane_cell(n_mat, n_th, n_td, n_pd, i, o,
                                          slot ? slot[lane] : 0);
  const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
  const merl::Rgb v = merl::lane_value<kOddTotal>(table, cell, total);
  if (!(v.r >= 0.f)) gc[0] = 0.f;
  if (!(v.g >= 0.f)) gc[1] = 0.f;
  if (!(v.b >= 0.f)) gc[2] = 0.f;
  const float wth[2] = {1.f - cell.fth, cell.fth};
  const float wtd[2] = {1.f - cell.ftd, cell.ftd};
  const float wpd[2] = {1.f - cell.fpd, cell.fpd};
  const int bins[2] = {cell.bin0, cell.bin1};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* dst = grad + cell.c[2 * a + b] + bins[k];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          atomicAdd(dst + c, gc[c] * wth[a] * wtd[b] * wpd[k]);
        }
      }
    }
  }
}

}  // namespace

// table: (n_mat, n_th, n_td, n_pd, 3) float32, 8-B aligned; g: (halves * n,
// 3) float32, the cotangent of mct_merl_eval's output; wi, wo_a, wo_b,
// slot, mask_a, mask_b as mct_merl_eval takes them; grad: the table's
// shape, float32, zeroed by the caller.
extern "C" int mct_merl_eval_bwd(const float* table, int n_mat, int n_th,
                                 int n_td, int n_pd, const float* g,
                                 const float* wi, const float* wo_a,
                                 const float* wo_b, const int64_t* slot,
                                 const uint8_t* mask_a, const uint8_t* mask_b,
                                 float* grad, int64_t n, int halves,
                                 cudaStream_t stream) {
  if (n > 0) {
    const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads),
                      (unsigned)halves);
    const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
    auto kernel =
        total % 2 ? merl_eval_bwd_kernel<true> : merl_eval_bwd_kernel<false>;
    kernel<<<blocks, kThreads, 0, stream>>>(table, n_mat, n_th, n_td, n_pd, g,
                                            wi, wo_a, wo_b, slot, mask_a,
                                            mask_b, grad, n);
  }
  return (int)cudaGetLastError();
}
