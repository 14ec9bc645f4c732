// S1 (sdf_march): the sphere trace of render/sdf.py's `intersect` through
// one SDF grid, one CUDA thread a lane.
//
// Replaces the JAX package's mitsuba_customization_tpu/render/sdf.py
// `_bounded_trace` (:153) over `intersect`'s body (:112-147). That is not
// a Pallas kernel but an XLA while_loop in lock-step: every live lane
// advances each step, and the loop runs until no lane is active or
// MAX_STEPS (128) steps are done. Here each thread marches its own lane
// for at most 128 steps while the lane is active, which gives the lane
// the same t and hit flag: a lane that is no longer active never changes.
// Nothing is read back to the host, so a captured frame holds the march
// as one launch.
//
// A step samples the grid at p = o + t d (local units) as sdf.sample
// does: u = p (dims - 1), the cell floor(u) clamped to [0, dims - 2], the
// fractions clamp(u - i0, 0, 1), and c00 = at(0,0,0) (1 - fz) + at(0,0,1)
// fz ... in its order (x-major grid). A lane with dist < HIT_EPS hits and
// stops; else t += max(dist, HIT_EPS) / |d|, and the lane stays active
// while t <= t_end. Numerics follow the plain version (sdf.march_plain)
// as torch runs it on the card: every product, sum and quotient rounds on
// its own (__fmul_rn, __fadd_rn, __fdiv_rn), and clamps pass NaN on.
//
// What bounds it on the H100: the grid reads, eight dependent corner
// loads a step at a point that depends on the last step's t, lanes of a
// warp marching different distances. The design is the simplest that is
// right: a plain grid of 128-thread blocks, the corners through the
// read-only cache (a 128^3 grid is 8 MB, well inside the 50 MB L2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSteps = 128;  // sdf.MAX_STEPS
constexpr float kHitEps = 1e-4f;  // sdf.HIT_EPS

// torch.clamp passes NaN on (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, f)), __fmul_rn(b, f));
}

struct Grid {
  const float* v;  // (nx, ny, nz), x-major
  int64_t n[3];
};

// sdf.sample at local point p
__device__ float sample(const Grid& g, float px, float py, float pz) {
  const float p[3] = {px, py, pz};
  int64_t i0[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = __fmul_rn(p[a], __fsub_rn((float)g.n[a], 1.f));
    int64_t lo = (int64_t)floorf(u);
    lo = lo < 0 ? 0 : lo;
    lo = lo < g.n[a] - 2 ? lo : g.n[a] - 2;
    i0[a] = lo;
    f[a] = clamp(__fsub_rn(u, (float)lo), 0.f, 1.f);
  }
  const int64_t ny = g.n[1], nz = g.n[2];
  const float* base = g.v + (i0[0] * ny + i0[1]) * nz + i0[2];
  auto at = [&](int dx, int dy, int dz) { return __ldg(base + (dx * ny + dy) * nz + dz); };
  const float c00 = lerp(at(0, 0, 0), at(0, 0, 1), f[2]);
  const float c01 = lerp(at(0, 1, 0), at(0, 1, 1), f[2]);
  const float c10 = lerp(at(1, 0, 0), at(1, 0, 1), f[2]);
  const float c11 = lerp(at(1, 1, 0), at(1, 1, 1), f[2]);
  const float c0 = lerp(c00, c01, f[1]);
  const float c1 = lerp(c10, c11, f[1]);
  return lerp(c0, c1, f[0]);
}

__global__ void __launch_bounds__(kThreads)
    sdf_march_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_start, const float* __restrict__ t_end,
                     const float* __restrict__ d_norm, const uint8_t* __restrict__ active0,
                     int64_t n, Grid g, float* __restrict__ out_t, uint8_t* __restrict__ out_hit,
                     int32_t* __restrict__ out_steps) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  float t = t_start[lane];
  bool hit = false;
  int steps = 0;
  if (active0[lane]) {
    const float ox = o[3 * lane], oy = o[3 * lane + 1], oz = o[3 * lane + 2];
    const float dx = d[3 * lane], dy = d[3 * lane + 1], dz = d[3 * lane + 2];
    const float te = t_end[lane], dn = d_norm[lane];
    for (; steps < kMaxSteps;) {
      ++steps;
      const float dist = sample(g, __fadd_rn(ox, __fmul_rn(t, dx)),
                                __fadd_rn(oy, __fmul_rn(t, dy)),
                                __fadd_rn(oz, __fmul_rn(t, dz)));
      if (dist < kHitEps) {
        hit = true;
        break;
      }
      const float step = __fdiv_rn(dist != dist ? dist : fmaxf(dist, kHitEps), dn);
      t = __fadd_rn(t, step);
      if (!(t <= te)) break;
    }
  }
  out_t[lane] = t;
  out_hit[lane] = hit ? 1 : 0;
  out_steps[lane] = steps;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// o, d: (n, 3) f32 the rays in the grid's local frame (d not normalised);
// t_start, t_end, d_norm: (n,) f32; active0: (n,) u8 the lanes that enter
// the unit cube before maxt; values: (nx, ny, nz) f32, each of nx, ny, nz
// >= 2. out_t: (n,) f32 the lane's t after the march; out_hit: (n,) u8;
// out_steps: (n,) i32 the steps the lane was active.
extern "C" int mct_sdf_march(const float* o, const float* d, const float* t_start,
                             const float* t_end, const float* d_norm, const uint8_t* active0,
                             int64_t n, const float* values, int64_t nx, int64_t ny,
                             int64_t nz, float* out_t, uint8_t* out_hit, int32_t* out_steps,
                             cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  sdf_march_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      o, d, t_start, t_end, d_norm, active0, n, Grid{values, {nx, ny, nz}}, out_t, out_hit,
      out_steps);
  return (int)cudaGetLastError();
}
