// K2: per-lane conditional-CDF inversion plus two cell masses for the
// tabulated BRDF's luminance importance sampler.
//
// Replaces the TPU kernel mitsuba_customization_tpu/ops/marginal_sorted.py
// `_cond_kernel` (sort lanes by CDF slice -> segment walk over transposed
// slabs -> unsort). On the H100 one thread per lane reads its own W-float
// conditional-CDF row (256 B at W = 64) in the natural (n_slices, H, W)
// layout; the rows of a whole sampling stack (32 slices x 32 rows x 64
// columns x 4 B = 256 KB per material) stay resident in L2, so the kernel
// is bound by those 256 B per lane of L2 reads. No transpose, padding,
// sort or unsort is needed.
//
// Semantics of core/distr._invert_cdf, exactly:
//   idx  = count of cdf < u (strict), clipped to W-1
//   lo   = largest value below u, else 0; hi = smallest value >= u, else
//          the last value; lo = min(lo, hi); mass = hi - lo
//   dx   = clip((u - lo) / max(mass, 1e-20), 0, 1 - 1e-7); x = (idx + dx) / W
//   cell mass at (r, c) = cdf[r][c] - (c > 0 ? cdf[r][c-1] : 0)
// Invalid lanes return zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;
constexpr float kTiny = 1e-20f;
constexpr float kOneMinus = (float)(1.0 - 1e-7);

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float cell_mass(const float* __restrict__ row,
                                           int c) {
  const float hi = __ldg(row + c);
  return c > 0 ? hi - __ldg(row + c - 1) : hi;
}

__global__ void cond_sample_kernel(
    const float* __restrict__ cdf, int n_slices, int h, int w,
    const int32_t* __restrict__ key, const float* __restrict__ u_col,
    const int32_t* __restrict__ r_own, const int32_t* __restrict__ r_nee,
    const int32_t* __restrict__ c_nee, const int32_t* __restrict__ r_cos,
    const int32_t* __restrict__ c_cos, const uint8_t* __restrict__ valid,
    float* __restrict__ x_out, float* __restrict__ mass_own,
    float* __restrict__ mass_nee, float* __restrict__ mass_cos, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  if (!valid[lane]) {
    x_out[lane] = 0.f;
    mass_own[lane] = 0.f;
    mass_nee[lane] = 0.f;
    mass_cos[lane] = 0.f;
    return;
  }
  const float* slice =
      cdf + (int64_t)clampi(key[lane], 0, n_slices - 1) * h * w;

  const float* row = slice + (int64_t)clampi(r_own[lane], 0, h - 1) * w;
  const float u = u_col[lane];
  int cnt = 0;
  float lo = 0.f, hi = kBig;
  for (int c = 0; c < w; ++c) {
    const float v = __ldg(row + c);
    if (v < u) {
      ++cnt;
      lo = fmaxf(lo, v);
    } else {
      hi = fminf(hi, v);
    }
  }
  if (hi >= kBig) hi = __ldg(row + w - 1);  // u beyond the last value
  lo = fminf(lo, hi);
  const float mass = hi - lo;
  const int idx = cnt < w - 1 ? cnt : w - 1;
  const float dx = fminf(fmaxf((u - lo) / fmaxf(mass, kTiny), 0.f), kOneMinus);
  x_out[lane] = ((float)idx + dx) / (float)w;
  mass_own[lane] = mass;

  mass_nee[lane] =
      cell_mass(slice + (int64_t)clampi(r_nee[lane], 0, h - 1) * w,
                clampi(c_nee[lane], 0, w - 1));
  mass_cos[lane] =
      cell_mass(slice + (int64_t)clampi(r_cos[lane], 0, h - 1) * w,
                clampi(c_cos[lane], 0, w - 1));
}

}  // namespace

// cdf: (n_slices, h, w) float32; key, r_*, c_*: (n,) int32; u_col: (n,)
// float32; valid: (n,) uint8; outputs: (n,) float32 each.
extern "C" int mct_cond_sample(const float* cdf, int n_slices, int h, int w,
                               const int32_t* key, const float* u_col,
                               const int32_t* r_own, const int32_t* r_nee,
                               const int32_t* c_nee, const int32_t* r_cos,
                               const int32_t* c_cos, const uint8_t* valid,
                               float* x_out, float* mass_own, float* mass_nee,
                               float* mass_cos, int64_t n,
                               cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cond_sample_kernel<<<blocks, threads, 0, stream>>>(
        cdf, n_slices, h, w, key, u_col, r_own, r_nee, c_nee, r_cos, c_cos,
        valid, x_out, mass_own, mass_nee, mass_cos, n);
  }
  return (int)cudaGetLastError();
}
