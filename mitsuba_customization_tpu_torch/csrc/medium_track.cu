// T1 (medium_delta_track) and T2 (medium_ratio_track): the heterogeneous
// media's tracking loops of render/medium.py, one CUDA thread a lane.
//
// Replaces the JAX package's mitsuba_customization_tpu/render/medium.py
// `_tracking_loop` (:55) over `dt_body` (:293, weighted delta tracking, the
// free flight) and `rt_body` (:386, ratio tracking, the shadow ray's
// transmittance). Those are not Pallas kernels but XLA while_loops in
// lock-step: the wavefront steps until its slowest lane is done, and
// every step reads the density grid for every lane. Here each thread runs
// its own lane's loop to its own end: a lane is done when its flight
// passes t_max (T1: or scatters at a real collision), and at the latest
// after step MAX_TRACKING_STEPS (256), the 257th update, exactly the JAX
// loop's stop. Nothing is read back to the host, so a captured frame
// holds the loop as one launch.
//
// Step `s` of a lane draws u = _uniform_from_bits(hash_combine(key, dim))
// (core/qmc.py's lowbias32 hash on uint32) at dim = dim_base + 2 + 2 s
// and dim_base + 3 + 2 s (T1) or dim_base + s (T2), with key =
// hash_combine(seed, lane) as the wrapper computes it on the device. The
// free flight is -log1p(-clamp(u, 0, 1 - 1e-7)) / majorant, the density
// at o + t d is medium._density_at's trilinear lookup (world-to-grid
// affine, clamp, floor, the eight corners in (z, y, x) order, the lerps
// in its order, 0 outside the unit cube), and the weight and flag updates
// are dt_body's and rt_body's. Numerics follow the plain versions
// (medium.delta_track_plain / ratio_track_plain) as torch runs them on the
// card: every product, sum and quotient rounds on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: nvcc may not contract them into FMAs), the
// channel mean is ((s0 + s1) + s2) / 3 as the plain version writes it,
// clamps pass NaN on as torch's do, and log1pf is the CUDA math library's,
// as torch's log1p is on the card. A lane outside a heterogeneous medium
// (mid < 0, or a homogeneous one) writes the initial state (t 0, weight
// 1, no scatter, 0 steps) and exits.
//
// What bounds it on the H100: the grid reads. A lane reads its ray, key
// and medium once and writes 24 bytes, but every step gathers eight
// corners at a point of its own, one dependent load after another (the
// next step's point depends on this step's t); warps run to their slowest
// lane. The design is the simplest that is right: a plain grid of
// 128-thread blocks, the medium's row read once a lane into registers,
// the corners through the read-only cache. The density is not computed on
// the step that passes t_max (its value is never read).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSteps = 256;                 // medium.MAX_TRACKING_STEPS
constexpr int64_t kHeterogeneous = 1;          // medium.HETEROGENEOUS
constexpr float kUMax = (float)(1.0 - 1e-7);   // _free_step's clamp
constexpr float kMajMin = 1e-20f;              // the majorant's floor

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return hash_u32(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}

// core/sampler._uniform_from_bits: the top 24 bits times 2^-24 (exact)
__device__ __forceinline__ float draw(uint32_t key, uint32_t dim) {
  return (float)(hash_combine(key, dim) >> 8) * (1.0f / 16777216.0f);
}

// torch.clamp passes NaN on (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// medium._free_step(u) / majorant
__device__ __forceinline__ float flight(float u, float maj) {
  return __fdiv_rn(-log1pf(-clamp(u, 0.f, kUMax)), maj);
}

// medium._lerp: a * (1 - t) + b * t
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, t)), __fmul_rn(b, t));
}

// One lane's medium, read once: its extinction, majorant, world-to-grid
// rows and grid binding.
struct Medium {
  float sig[3];
  float maj;
  float w2g[12];
  const float* grid;  // the medium's (D, H, W) slab of the stack
  int64_t dims[3];    // its own (D, H, W)
  int64_t gh, gw;     // the stack's (padded) H, W
};

// medium._density_at at world point p: 0 outside the grid's unit cube
__device__ float density(const Medium& m, float px, float py, float pz) {
  float t[3];
  int64_t i0[3], i1[3];
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* w = m.w2g + 4 * a;
    const float g = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], px), __fmul_rn(w[1], py)),
                                        __fmul_rn(w[2], pz)), w[3]);
    inside = inside && g >= 0.f && g <= 1.f;
    const float f = __fmul_rn(clamp(g, 0.f, 1.f), __fsub_rn((float)m.dims[a], 1.f));
    int64_t lo = (int64_t)floorf(f);
    const int64_t top = m.dims[a] - 2 > 0 ? m.dims[a] - 2 : 0;
    lo = lo < 0 ? 0 : lo;
    lo = lo < top ? lo : top;
    i0[a] = lo;
    t[a] = __fsub_rn(f, (float)lo);
    i1[a] = lo + 1 < m.dims[a] - 1 ? lo + 1 : m.dims[a] - 1;
  }
  if (!inside) return 0.f;
  float c[2][2][2];
  const int64_t zs[2] = {i0[0], i1[0]}, ys[2] = {i0[1], i1[1]}, xs[2] = {i0[2], i1[2]};
#pragma unroll
  for (int z = 0; z < 2; ++z)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        c[z][y][x] = __ldg(m.grid + (zs[z] * m.gh + ys[y]) * m.gw + xs[x]);
  const float c00 = lerp(c[0][0][0], c[0][0][1], t[2]);
  const float c01 = lerp(c[0][1][0], c[0][1][1], t[2]);
  const float c10 = lerp(c[1][0][0], c[1][0][1], t[2]);
  const float c11 = lerp(c[1][1][0], c[1][1][1], t[2]);
  return lerp(lerp(c00, c01, t[1]), lerp(c10, c11, t[1]), t[0]);
}

// The tables of medium.MediumTable the kernels read.
struct Table {
  const int64_t* m_type;       // (K,)
  const float* sigma_t;        // (K, 3)
  const float* majorant;       // (K,)
  const float* world_to_grid;  // (K, 3, 4)
  const int64_t* grid_slot;    // (K,)
  const int64_t* grid_dims;    // (K, 3)
  const float* grid;           // (Kg, D, H, W)
  int64_t gd, gh, gw;
};

// Whether lane `mid` tracks (a heterogeneous medium), and its Medium.
__device__ bool load_medium(const Table& tb, int64_t mid, Medium& m) {
  if (mid < 0 || tb.m_type[mid] != kHeterogeneous) return false;
#pragma unroll
  for (int c = 0; c < 3; ++c) m.sig[c] = tb.sigma_t[3 * mid + c];
  m.maj = fmaxf(tb.majorant[mid], kMajMin);
#pragma unroll
  for (int i = 0; i < 12; ++i) m.w2g[i] = tb.world_to_grid[12 * mid + i];
#pragma unroll
  for (int a = 0; a < 3; ++a) m.dims[a] = tb.grid_dims[3 * mid + a];
  m.grid = tb.grid + tb.grid_slot[mid] * tb.gd * tb.gh * tb.gw;
  m.gh = tb.gh;
  m.gw = tb.gw;
  return true;
}

__global__ void __launch_bounds__(kThreads)
    medium_delta_track_kernel(const float* __restrict__ o, const float* __restrict__ d,
                              const float* __restrict__ t_max, const int64_t* __restrict__ mid,
                              const int64_t* __restrict__ key, uint32_t dim_base, int64_t n,
                              Table tb, float* __restrict__ out_t, float* __restrict__ out_w,
                              uint8_t* __restrict__ out_scat, int32_t* __restrict__ out_steps) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  float t = 0.f, w0 = 1.f, w1 = 1.f, w2 = 1.f;
  bool scat = false;
  int steps = 0;
  Medium m;
  if (load_medium(tb, mid[lane], m)) {
    const float ox = o[3 * lane], oy = o[3 * lane + 1], oz = o[3 * lane + 2];
    const float dx = d[3 * lane], dy = d[3 * lane + 1], dz = d[3 * lane + 2];
    const float tmax = t_max[lane];
    const uint32_t k = (uint32_t)key[lane];
    for (int s = 0; s <= kMaxSteps; ++s) {
      ++steps;
      const float u1 = draw(k, dim_base + 2u + 2u * (uint32_t)s);
      const float u2 = draw(k, dim_base + 3u + 2u * (uint32_t)s);
      const float t_new = __fadd_rn(t, flight(u1, m.maj));
      if (t_new >= tmax) {  // passed: t = t_max, the weight kept
        t = tmax;
        break;
      }
      const float dens = density(m, __fadd_rn(ox, __fmul_rn(t_new, dx)),
                                 __fadd_rn(oy, __fmul_rn(t_new, dy)),
                                 __fadd_rn(oz, __fmul_rn(t_new, dz)));
      const float s0 = __fmul_rn(m.sig[0], dens), s1 = __fmul_rn(m.sig[1], dens),
                  s2 = __fmul_rn(m.sig[2], dens);
      const float mean = __fdiv_rn(__fadd_rn(__fadd_rn(s0, s1), s2), 3.f);
      const float p_real = clamp(__fdiv_rn(mean, m.maj), 0.f, 1.f);
      t = t_new;
      if (u2 < p_real) {  // a real collision: scatter here
        if (mean != 0.f) {
          w0 = __fmul_rn(w0, __fdiv_rn(s0, mean));
          w1 = __fmul_rn(w1, __fdiv_rn(s1, mean));
          w2 = __fmul_rn(w2, __fdiv_rn(s2, mean));
        } else {
          w0 = __fmul_rn(w0, 0.f);
          w1 = __fmul_rn(w1, 0.f);
          w2 = __fmul_rn(w2, 0.f);
        }
        scat = true;
        break;
      }
      const float den = __fmul_rn(m.maj, __fsub_rn(1.f, p_real));
      if (den != 0.f) {
        w0 = __fmul_rn(w0, __fdiv_rn(__fsub_rn(m.maj, s0), den));
        w1 = __fmul_rn(w1, __fdiv_rn(__fsub_rn(m.maj, s1), den));
        w2 = __fmul_rn(w2, __fdiv_rn(__fsub_rn(m.maj, s2), den));
      } else {
        w0 = __fmul_rn(w0, 0.f);
        w1 = __fmul_rn(w1, 0.f);
        w2 = __fmul_rn(w2, 0.f);
      }
    }
  }
  out_t[lane] = t;
  out_w[3 * lane] = w0;
  out_w[3 * lane + 1] = w1;
  out_w[3 * lane + 2] = w2;
  out_scat[lane] = scat ? 1 : 0;
  out_steps[lane] = steps;
}

__global__ void __launch_bounds__(kThreads)
    medium_ratio_track_kernel(const float* __restrict__ o, const float* __restrict__ d,
                              const float* __restrict__ dist, const int64_t* __restrict__ mid,
                              const int64_t* __restrict__ key, uint32_t dim_base, int64_t n,
                              Table tb, float* __restrict__ out_w,
                              int32_t* __restrict__ out_steps) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  float t = 0.f, w0 = 1.f, w1 = 1.f, w2 = 1.f;
  int steps = 0;
  Medium m;
  if (load_medium(tb, mid[lane], m)) {
    const float ox = o[3 * lane], oy = o[3 * lane + 1], oz = o[3 * lane + 2];
    const float dx = d[3 * lane], dy = d[3 * lane + 1], dz = d[3 * lane + 2];
    const float dmax = dist[lane];
    const uint32_t k = (uint32_t)key[lane];
    for (int s = 0; s <= kMaxSteps; ++s) {
      ++steps;
      const float t_new = __fadd_rn(t, flight(draw(k, dim_base + (uint32_t)s), m.maj));
      if (t_new >= dmax) break;  // passed: the weight kept
      const float dens = density(m, __fadd_rn(ox, __fmul_rn(t_new, dx)),
                                 __fadd_rn(oy, __fmul_rn(t_new, dy)),
                                 __fadd_rn(oz, __fmul_rn(t_new, dz)));
      w0 = __fmul_rn(w0, clamp(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(m.sig[0], dens), m.maj)),
                               0.f, 1.f));
      w1 = __fmul_rn(w1, clamp(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(m.sig[1], dens), m.maj)),
                               0.f, 1.f));
      w2 = __fmul_rn(w2, clamp(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(m.sig[2], dens), m.maj)),
                               0.f, 1.f));
      t = t_new;
    }
  }
  out_w[3 * lane] = w0;
  out_w[3 * lane + 1] = w1;
  out_w[3 * lane + 2] = w2;
  out_steps[lane] = steps;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

Table make_table(const int64_t* m_type, const float* sigma_t, const float* majorant,
                 const float* world_to_grid, const int64_t* grid_slot,
                 const int64_t* grid_dims, const float* grid, int64_t gd, int64_t gh,
                 int64_t gw) {
  return Table{m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims, grid,
               gd, gh, gw};
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32; mid: (n,) i64 each lane's medium
// (-1: vacuum); key: (n,) i64 hash_combine(seed, lane) in its low 32 bits;
// dim_base: the loop's first sampler dimension (mod 2^32). The table
// (K media): m_type (K,) i64, sigma_t (K, 3) f32, majorant (K,) f32,
// world_to_grid (K, 3, 4) f32, grid_slot (K,) i64, grid_dims (K, 3) i64,
// grid (Kg, gd, gh, gw) f32. out_t: (n,) f32; out_w: (n, 3) f32; out_scat:
// (n,) u8; out_steps: (n,) i32, the updates the lane made (0 outside a
// heterogeneous medium).
extern "C" int mct_delta_track(const float* o, const float* d, const float* t_max,
                               const int64_t* mid, const int64_t* key, uint32_t dim_base,
                               int64_t n, const int64_t* m_type, const float* sigma_t,
                               const float* majorant, const float* world_to_grid,
                               const int64_t* grid_slot, const int64_t* grid_dims,
                               const float* grid, int64_t gd, int64_t gh, int64_t gw,
                               float* out_t, float* out_w, uint8_t* out_scat,
                               int32_t* out_steps, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  medium_delta_track_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      o, d, t_max, mid, key, dim_base, n,
      make_table(m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims, grid, gd, gh,
                 gw),
      out_t, out_w, out_scat, out_steps);
  return (int)cudaGetLastError();
}

// As mct_delta_track, with dist (n,) f32 the shadow segment's length
// (finite); out_w: (n, 3) f32 the transmittance; out_steps as above.
extern "C" int mct_ratio_track(const float* o, const float* d, const float* dist,
                               const int64_t* mid, const int64_t* key, uint32_t dim_base,
                               int64_t n, const int64_t* m_type, const float* sigma_t,
                               const float* majorant, const float* world_to_grid,
                               const int64_t* grid_slot, const int64_t* grid_dims,
                               const float* grid, int64_t gd, int64_t gh, int64_t gw,
                               float* out_w, int32_t* out_steps, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  medium_ratio_track_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      o, d, dist, mid, key, dim_base, n,
      make_table(m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims, grid, gd, gh,
                 gw),
      out_w, out_steps);
  return (int)cudaGetLastError();
}
