// K2: per-lane conditional-CDF inversion plus two cell masses for the
// tabulated BRDF's luminance importance sampler.
//
// Replaces the TPU kernel mitsuba_customization_tpu/ops/marginal_sorted.py
// `_cond_kernel` (sort lanes by CDF slice -> segment walk over transposed
// slabs -> unsort). On the H100 the conditional CDFs keep their natural
// (n_slices, H, W) layout; a material's stack (32 slices x 32 rows x 64
// columns x 4 B = 256 KB) stays resident in L2, so the cost is the L2
// sectors each lane touches, plus the lane I/O.
//
// Design: one thread per lane. A row is nondecreasing (Marginal2D.build
// takes a cumsum of positive weights), so the count of values below u is
// a lower bound, found by binary search over row[0 .. W-2]: ceil(log2 W)
// dependent loads of one 32-B sector each (6 at W = 64), then the values
// at cnt-1 and cnt. A scan of all W floats would cost W scalar loads,
// each a sector of its own, since a warp instruction touches 32
// different rows. The kernel reads the caller's tensors as they are:
// int64 indices, a bool mask and a strided u column, so a call is one
// launch and one output allocation.
//
// Semantics of core/distr._invert_cdf, exactly (bit-equal):
//   idx  = count of cdf < u (strict), clipped to W-1
//   lo   = largest value below u, else 0; hi = smallest value >= u, else
//          the last value; lo = min(lo, hi); mass = hi - lo
//   dx   = clip((u - lo) / max(mass, 1e-20), 0, 1 - 1e-7); x = (idx + dx) / W
//   cell mass at (r, c) = cdf[r][c] - (c > 0 ? cdf[r][c-1] : 0)
// Equal neighbours (cells of weight ~0) give the same count either way.
// Invalid lanes return zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTiny = 1e-20f;
constexpr float kOneMinus = (float)(1.0 - 1e-7);

__device__ __forceinline__ int64_t clamp_index(int64_t x, int64_t n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

__device__ __forceinline__ float cell_mass(const float* __restrict__ row,
                                           int64_t c) {
  const float hi = __ldg(row + c);
  return c > 0 ? hi - __ldg(row + c - 1) : hi;
}

__global__ void cond_sample_kernel(
    const float* __restrict__ cdf, int n_slices, int h, int w,
    const int64_t* __restrict__ key, const float* __restrict__ u_col,
    int64_t u_stride, const int64_t* __restrict__ r_own,
    const int64_t* __restrict__ r_nee, const int64_t* __restrict__ c_nee,
    const int64_t* __restrict__ r_cos, const int64_t* __restrict__ c_cos,
    const uint8_t* __restrict__ valid, float* __restrict__ out, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float x = 0.f, mass = 0.f, m_nee = 0.f, m_cos = 0.f;
  if (valid[lane]) {
    const float* slice = cdf + clamp_index(key[lane], n_slices) * h * w;
    const float* row = slice + clamp_index(r_own[lane], h) * w;
    const float u = u_col[lane * u_stride];
    // c = count of values below u, clipped to w-1: the lower bound of u in
    // row[0 .. w-2], or w-1 if all of those are below u
    int c = 0;
    for (int len = w - 1; len > 0;) {
      const int half = len >> 1;
      if (__ldg(row + c + half) < u) {
        c += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    const float hi = __ldg(row + c);
    // hi < u only if every value is below u: lo is then the last, = hi
    float lo = hi < u ? hi : (c > 0 ? __ldg(row + c - 1) : 0.f);
    lo = fminf(lo, hi);
    mass = hi - lo;
    const float dx =
        fminf(fmaxf((u - lo) / fmaxf(mass, kTiny), 0.f), kOneMinus);
    x = ((float)c + dx) / (float)w;
    m_nee = cell_mass(slice + clamp_index(r_nee[lane], h) * w,
                      clamp_index(c_nee[lane], w));
    m_cos = cell_mass(slice + clamp_index(r_cos[lane], h) * w,
                      clamp_index(c_cos[lane], w));
  }
  out[lane] = x;
  out[n + lane] = mass;
  out[2 * n + lane] = m_nee;
  out[3 * n + lane] = m_cos;
}

}  // namespace

// cdf: (n_slices, h, w) float32, rows nondecreasing; key, r_*, c_*: (n,)
// int64; u_col: n float32 at stride u_stride; valid: (n,) bool; out: (4, n)
// float32 (x, mass_own, mass_nee, mass_cos).
extern "C" int mct_cond_sample(const float* cdf, int n_slices, int h, int w,
                               const int64_t* key, const float* u_col,
                               int64_t u_stride, const int64_t* r_own,
                               const int64_t* r_nee, const int64_t* c_nee,
                               const int64_t* r_cos, const int64_t* c_cos,
                               const uint8_t* valid, float* out, int64_t n,
                               cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cond_sample_kernel<<<blocks, threads, 0, stream>>>(
        cdf, n_slices, h, w, key, u_col, u_stride, r_own, r_nee, c_nee, r_cos,
        c_cos, valid, out, n);
  }
  return (int)cudaGetLastError();
}
