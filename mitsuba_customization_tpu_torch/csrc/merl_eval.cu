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
// The lane's angles, cell, fractions and corner reads are merl_lane.cuh's,
// which K1's backward (merl_eval_bwd.cu) shares. A lane evaluates where
// cos(wi) > 0, cos(wo) > 0 and its mask is set; elsewhere it returns 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merl_lane.cuh"

namespace {

constexpr int kThreads = 256;

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
      const merl::Cell cell = merl::lane_cell(n_mat, n_th, n_td, n_pd, i, o,
                                              slot ? slot[lane] : 0);
      const int64_t total = (int64_t)n_mat * n_th * n_td * n_pd * 3;
      const merl::Rgb v = merl::lane_value<kOddTotal>(table, cell, total);
      res[0] = fmaxf(v.r, 0.f);
      res[1] = fmaxf(v.g, 0.f);
      res[2] = fmaxf(v.b, 0.f);
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
