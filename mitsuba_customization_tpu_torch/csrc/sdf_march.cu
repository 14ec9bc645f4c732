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
// its own (__fmul_rn, __fadd_rn, __fdiv_rn), and clamps pass NaN on. The
// cell index is 32-bit (the wrapper bounds the grid): a float that does
// not fit, or NaN, converts to a value the clamps take to the same cell
// as the plain version's int64 conversion.
//
// What bounds it (PERF.md §6; H100 80GB HBM3 at 700 W): each lane's chain of
// dependent steps, since a step's point depends on the last step's t. A
// frame's marches take 0.012-0.057 ms of device time each (the kernel
// before this layout: 0.023-0.087); the small ones (a few thousand
// active lanes) sit at the floor of their longest lane, up to 128 steps
// of ~0.1-0.2 us, and the large ones (up to 741,288 active lanes,
// 5-9 steps a lane on average) at the rate the warps issue steps. The
// corners come from `corners`, a copy of the grid with four values a node
// (sdf.corner_layout: v[x,y,z], v[x,y,z+1], v[x,y+1,z], v[x,y+1,z+1]),
// so that a step reads its eight corners as two float4 loads, one a node
// (x0, y0, z0) and one a node (x0 + 1, y0, z0), instead of eight scalar
// loads from four lines: 4x the grid's memory (33.6 MB at 128^3), inside
// the 50 MB L2. Timed in turns against the parent's kernel and dropped:
// per-thread refill (persistent warps claiming 128 lanes at a time and
// queueing the active ones, so that a thread takes a new lane when its
// own ends; twice as slow: most lanes end within a few steps, and the
// refill's ballots, queue and scattered loads cost more than the idle
// lanes it fills), eight corners a cell (8x the memory, no faster),
// scalar loads from the grid with 32-bit cells (slower on the large
// marches), and fewer registers forced by launch bounds (slower).
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
  const float4* corners;  // (nx, ny, nz) float4, sdf.corner_layout
  int n[3];
};

// one axis of sdf.cell: the cell's lower node and the fraction f
__device__ __forceinline__ int cell_axis(float p, int n, float& f) {
  const float u = __fmul_rn(p, __fsub_rn((float)n, 1.f));
  int lo = __float2int_rd(u);
  lo = lo < 0 ? 0 : lo;
  lo = lo < n - 2 ? lo : n - 2;
  f = clamp(__fsub_rn(u, (float)lo), 0.f, 1.f);
  return lo;
}

// sdf.sample at local point p
__device__ __forceinline__ float sample(const Grid& g, float px, float py, float pz) {
  float fx, fy, fz;
  const int x0 = cell_axis(px, g.n[0], fx), y0 = cell_axis(py, g.n[1], fy),
            z0 = cell_axis(pz, g.n[2], fz);
  const int node = (x0 * g.n[1] + y0) * g.n[2] + z0;
  const float4 a = __ldg(g.corners + node);                    // x0: 00, 01, 10, 11 in (y, z)
  const float4 b = __ldg(g.corners + node + g.n[1] * g.n[2]);  // x0 + 1
  const float c00 = lerp(a.x, a.y, fz);
  const float c01 = lerp(a.z, a.w, fz);
  const float c10 = lerp(b.x, b.y, fz);
  const float c11 = lerp(b.z, b.w, fz);
  return lerp(lerp(c00, c01, fy), lerp(c10, c11, fy), fx);
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
// the unit cube before maxt; corners: (nx, ny, nz, 4) f32, 16-byte
// aligned, sdf.corner_layout of the grid's values, each of nx, ny, nz >=
// 2 and nx ny nz < 2^29. out_t: (n,) f32 the lane's t after the march;
// out_hit: (n,) u8; out_steps: (n,) i32 the steps the lane was active.
extern "C" int mct_sdf_march(const float* o, const float* d, const float* t_start,
                             const float* t_end, const float* d_norm, const uint8_t* active0,
                             int64_t n, const float* corners, int64_t nx, int64_t ny,
                             int64_t nz, float* out_t, uint8_t* out_hit, int32_t* out_steps,
                             cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nx < 2 || ny < 2 || nz < 2 || nx * ny * nz >= (int64_t)1 << 29 ||
      ((uintptr_t)corners & 15u) != 0u)
    return (int)cudaErrorInvalidValue;
  sdf_march_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      o, d, t_start, t_end, d_norm, active0, n,
      Grid{(const float4*)corners, {(int)nx, (int)ny, (int)nz}}, out_t, out_hit, out_steps);
  return (int)cudaGetLastError();
}
