// T1 (medium_delta_track) and T2 (medium_ratio_track): the heterogeneous
// media's tracking loops of render/medium.py, one CUDA thread a lane; and
// their backward T1-bwd / T2-bwd (medium_track_bwd), which ad_mode's
// autograd Function (medium._Track) runs.
//
// Replaces the JAX package's mitsuba_customization_tpu/render/medium.py
// `_tracking_loop` (:55) over `dt_body` (:293, weighted delta tracking, the
// free flight) and `rt_body` (:386, ratio tracking, the shadow ray's
// transmittance), and under ad_mode the XLA VJP of its fixed-length masked
// scan. Those are not Pallas kernels but XLA loops in lock-step: the
// wavefront steps until its slowest lane is done, and every step reads the
// density grid for every lane. Here each thread runs its own lane's loop
// to its own end: a lane is done when its flight passes t_max (T1: or
// scatters at a real collision), or after n_steps updates: the JAX while
// loop's MAX_TRACKING_STEPS + 1 = 257 in primal renders, its scan's
// AD_TRACKING_STEPS = 48 in ad_mode, where a lane not done by then keeps
// its partial t and weight, as the scan does. Nothing is read back to the
// host, so a captured frame or AD step holds each loop as one launch (the
// backward as one, behind the zeroing of sigma_t's gradient).
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
// (medium.delta_track_plain / ratio_track_plain, and _scan) as torch runs
// them on the card: every product, sum and quotient rounds on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc may not contract them into FMAs),
// the channel mean is ((s0 + s1) + s2) / 3 as the plain version writes it,
// clamps pass NaN on as torch's do, and log1pf is the CUDA math library's,
// as torch's log1p is on the card. A lane outside a heterogeneous medium
// (mid < 0, or a homogeneous one) gets the initial state (t 0, weight 1,
// no scatter, 0 steps).
//
// What bounds it on the H100: every lane's input and output bytes (a
// lane outside a medium still writes its 21), then the tracked lanes'
// grid reads: every step gathers eight corners at a point of its own, one
// dependent step after another (the next step's point depends on this
// step's t). The eight corner loads of a step are independent and issued
// together, through the read-only cache; the density is not computed on
// the step that passes t_max (its value is never read). A volpath bounce
// tracks a tenth of its lanes, scattered over the wavefront; a warp with
// no tracked lane exits at once, so the card fills with warps that track.
// Three schedules that list the tracked lanes first were timed against
// this one and the parent's kernel on the volpath frame's calls and were
// slower (PERF.md): the list strided over persistent blocks, the
// list fetched a lane at a time by persistent warps (Aila and Laine's
// while-while), and a block's tile listed in shared memory.
//
// T1-bwd and T2-bwd are one launch each, a thread a lane over every lane,
// as T1 / T2: a lane outside a heterogeneous medium writes zero ray and
// t_max gradients, and a tracked lane writes its own (T2's t_max gradient
// is 0 on every lane: ratio tracking's passed test carries none), so the
// wrapper zeroes only sigma_t's (K, 3) gradient. An AD step calls each on
// 262,144 lanes, at most a tenth of them tracked, for 1.4-1.7 steps a
// lane (T1) or 2.1-2.5 (T2), where the fixed cost of a call outweighs the
// work: the earlier schedule of
// both listed the tracked lanes first (a list kernel, a counter and
// persistent blocks whose warps fetched 32 listed lanes at a time) behind
// zeroing launches, about seven device operations a call; this design
// takes two. Timed in turns and dropped (PERF.md §6,
// PERF_APPENDIX.md): float2 / float4 atomics for the grid's x pairs (no
// faster: the adds are spread over a grid larger than the L2), the first
// 8 steps kept in registers with a lane of more steps replaying from its
// key (more registers, slower), 256-thread persistent blocks striding over
// the lanes, fewer registers forced by launch bounds (spills), and for
// T2-bwd two floats kept a step (flight, density) with the weight before
// each step rebuilt in the sweep (slower: the rebuild is quadratic in a
// lane's steps, and the three floats a step it saves sit in local memory
// that a lane of one or two steps barely touches).
//
// The backward, given each lane's cotangent gw (n, 3) of the weight (and
// gt (n,) of T1's t), replays the lane's steps from its key with the same
// draws, flights, points and decisions (they depend only on detached
// quantities: the majorant and p_real), keeping each step's flight,
// density and the weight before it (at most 48 steps), then sweeps the
// steps in reverse as autograd does through _scan: the cotangent of a
// factor is the running cotangent times the weight before the step, and
// the running cotangent is then multiplied by the factor (no division by
// a suffix product: a factor can be exactly 0). Each step's gradient in
// the extinction sig_p = sigma_t dens goes to sigma_t (dens times it,
// summed in the thread, then in shared memory, then once a block into
// global memory), to the grid (sum_c sigma_t[c] d/dsig_p[c], spread over
// the eight corners with the lerp weights by atomicAdd into one
// grid-sized buffer) and, where asked, to the ray's origin and direction
// (the trilinear density's gradient in the point). T1's t_max gets gt on
// the lanes that passed. Bound by the replayed grid reads and the
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBwdSteps = 48;                  // medium.AD_TRACKING_STEPS
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
  int64_t slab;       // the medium's (D, H, W) slab's offset in the stack
  int64_t dims[3];    // its own (D, H, W)
  int64_t gh, gw;     // the stack's (padded) H, W
};

// A point's cell (medium._corners): the corner indices (z, y, x), the
// fractions, the world-to-grid coordinates and whether p lies inside the
// grid's unit cube.
struct Cell {
  int64_t zs[2], ys[2], xs[2];
  float t[3];
  bool inside;

  __device__ int64_t at(const Medium& m, int z, int y, int x) const {
    return m.slab + (zs[z] * m.gh + ys[y]) * m.gw + xs[x];
  }
};

__device__ __forceinline__ Cell locate(const Medium& m, float px, float py, float pz) {
  Cell c;
  c.inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* w = m.w2g + 4 * a;
    const float g = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], px), __fmul_rn(w[1], py)),
                                        __fmul_rn(w[2], pz)), w[3]);
    c.inside = c.inside && g >= 0.f && g <= 1.f;
    const float f = __fmul_rn(clamp(g, 0.f, 1.f), __fsub_rn((float)m.dims[a], 1.f));
    int64_t lo = (int64_t)floorf(f);
    const int64_t top = m.dims[a] - 2 > 0 ? m.dims[a] - 2 : 0;
    lo = lo < 0 ? 0 : lo;
    lo = lo < top ? lo : top;
    const int64_t hi = lo + 1 < m.dims[a] - 1 ? lo + 1 : m.dims[a] - 1;
    c.t[a] = __fsub_rn(f, (float)lo);
    int64_t* lohi = a == 0 ? c.zs : a == 1 ? c.ys : c.xs;
    lohi[0] = lo;
    lohi[1] = hi;
  }
  return c;
}

// The eight corners of a cell, all loads issued before the first use.
__device__ __forceinline__ void corners(const float* __restrict__ grid, const Medium& m,
                                        const Cell& c, float v[2][2][2]) {
#pragma unroll
  for (int z = 0; z < 2; ++z)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int x = 0; x < 2; ++x) v[z][y][x] = __ldg(grid + c.at(m, z, y, x));
}

// medium._density_at at world point p: 0 outside the grid's unit cube
__device__ __forceinline__ float density(const float* __restrict__ grid, const Medium& m,
                                         float px, float py, float pz) {
  const Cell c = locate(m, px, py, pz);
  if (!c.inside) return 0.f;
  float v[2][2][2];
  corners(grid, m, c, v);
  const float c00 = lerp(v[0][0][0], v[0][0][1], c.t[2]);
  const float c01 = lerp(v[0][1][0], v[0][1][1], c.t[2]);
  const float c10 = lerp(v[1][0][0], v[1][0][1], c.t[2]);
  const float c11 = lerp(v[1][1][0], v[1][1][1], c.t[2]);
  return lerp(lerp(c00, c01, c.t[1]), lerp(c10, c11, c.t[1]), c.t[0]);
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

__device__ __forceinline__ bool tracks(const Table& tb, int64_t mid) {
  return mid >= 0 && tb.m_type[mid] == kHeterogeneous;
}

// A tracked lane's Medium.
__device__ Medium load_medium(const Table& tb, int64_t mid) {
  Medium m;
#pragma unroll
  for (int c = 0; c < 3; ++c) m.sig[c] = tb.sigma_t[3 * mid + c];
  m.maj = fmaxf(tb.majorant[mid], kMajMin);
#pragma unroll
  for (int i = 0; i < 12; ++i) m.w2g[i] = tb.world_to_grid[12 * mid + i];
#pragma unroll
  for (int a = 0; a < 3; ++a) m.dims[a] = tb.grid_dims[3 * mid + a];
  m.slab = tb.grid_slot[mid] * tb.gd * tb.gh * tb.gw;
  m.gh = tb.gh;
  m.gw = tb.gw;
  return m;
}

// The lanes' inputs.
struct Rays {
  const float* o;        // (n, 3)
  const float* d;        // (n, 3)
  const float* t_max;    // (n,) T1's segment end, T2's dist
  const int64_t* mid;    // (n,)
  const int64_t* key;    // (n,)
  uint32_t dim_base;
  int64_t n;
  int n_steps;           // the most updates a lane makes
};

// The outputs (T2: t and scat null).
struct Out {
  float* t;
  float* w;
  uint8_t* scat;
  int32_t* steps;

  __device__ void write(int64_t lane, float tv, const float w3[3], bool sc, int st) const {
    if (t != nullptr) t[lane] = tv;
    w[3 * lane] = w3[0];
    w[3 * lane + 1] = w3[1];
    w[3 * lane + 2] = w3[2];
    if (scat != nullptr) scat[lane] = sc ? 1 : 0;
    steps[lane] = st;
  }
};

// dt_body's factor at a step that did not pass: w_real = sig_p / mean on a
// real collision (u2 < p_real), else w_null = (maj - sig_p) / (maj (1 -
// p_real)); 0 where the denominator is. Returns whether it was real.
__device__ __forceinline__ bool delta_factor(const Medium& m, float dens, float u2, float f[3]) {
  const float s0 = __fmul_rn(m.sig[0], dens), s1 = __fmul_rn(m.sig[1], dens),
              s2 = __fmul_rn(m.sig[2], dens);
  const float mean = __fdiv_rn(__fadd_rn(__fadd_rn(s0, s1), s2), 3.f);
  const float p_real = clamp(__fdiv_rn(mean, m.maj), 0.f, 1.f);
  if (u2 < p_real) {
    f[0] = mean != 0.f ? __fdiv_rn(s0, mean) : 0.f;
    f[1] = mean != 0.f ? __fdiv_rn(s1, mean) : 0.f;
    f[2] = mean != 0.f ? __fdiv_rn(s2, mean) : 0.f;
    return true;
  }
  const float den = __fmul_rn(m.maj, __fsub_rn(1.f, p_real));
  f[0] = den != 0.f ? __fdiv_rn(__fsub_rn(m.maj, s0), den) : 0.f;
  f[1] = den != 0.f ? __fdiv_rn(__fsub_rn(m.maj, s1), den) : 0.f;
  f[2] = den != 0.f ? __fdiv_rn(__fsub_rn(m.maj, s2), den) : 0.f;
  return false;
}

// rt_body's factor clamp(1 - sig_p / maj, 0, 1), and its argument x
__device__ __forceinline__ void ratio_factor(const Medium& m, float dens, float f[3],
                                             float x[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[c] = __fsub_rn(1.f, __fdiv_rn(__fmul_rn(m.sig[c], dens), m.maj));
    f[c] = clamp(x[c], 0.f, 1.f);
  }
}

// One tracked lane's loop, a step at a time (the backward replays it).
template <bool kDelta>
struct Lane {
  Medium m;
  float ox, oy, oz, dx, dy, dz, tmax;
  uint32_t key;
  int64_t lane;
  float t, w[3];
  int steps;
  bool scat;

  __device__ void begin(const Table& tb, const Rays& r, int64_t l) {
    lane = l;
    m = load_medium(tb, r.mid[l]);
    ox = r.o[3 * l];
    oy = r.o[3 * l + 1];
    oz = r.o[3 * l + 2];
    dx = r.d[3 * l];
    dy = r.d[3 * l + 1];
    dz = r.d[3 * l + 2];
    tmax = r.t_max[l];
    key = (uint32_t)r.key[l];
    t = 0.f;
    w[0] = w[1] = w[2] = 1.f;
    steps = 0;
    scat = false;
  }

  // step `steps`'s flight: the new t
  __device__ __forceinline__ float t_new(uint32_t dim_base) const {
    const uint32_t dim = kDelta ? dim_base + 2u + 2u * (uint32_t)steps : dim_base + (uint32_t)steps;
    return __fadd_rn(t, flight(draw(key, dim), m.maj));
  }

  __device__ __forceinline__ float u2(uint32_t dim_base) const {
    return draw(key, dim_base + 3u + 2u * (uint32_t)steps);
  }

  __device__ __forceinline__ float dens_at(const float* grid, float tn) const {
    return density(grid, m, __fadd_rn(ox, __fmul_rn(tn, dx)), __fadd_rn(oy, __fmul_rn(tn, dy)),
                   __fadd_rn(oz, __fmul_rn(tn, dz)));
  }

  // One update; true when the lane is done.
  __device__ bool step(const float* grid, const Rays& r) {
    const float tn = t_new(r.dim_base);
    const float u = kDelta ? u2(r.dim_base) : 0.f;
    ++steps;
    if (tn >= tmax) {  // passed: T1's t = t_max, the weight kept
      if (kDelta) t = tmax;
      return true;
    }
    const float dens = dens_at(grid, tn);
    float f[3];
    bool real = false;
    if (kDelta) {
      real = delta_factor(m, dens, u, f);
    } else {
      float x[3];
      ratio_factor(m, dens, f, x);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = __fmul_rn(w[c], f[c]);
    t = tn;
    scat = real;
    return real || steps >= r.n_steps;
  }

  __device__ void finish(const Out& out) const { out.write(lane, t, w, scat, steps); }
};

__device__ __forceinline__ void write_initial(const Out& out, int64_t lane) {
  const float one[3] = {1.f, 1.f, 1.f};
  out.write(lane, 0.f, one, false, 0);
}

// T1 / T2: a thread a lane over every lane.
template <bool kDelta>
__device__ void track_all(const Table& tb, const Rays& r, const Out& out) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= r.n) return;
  if (!tracks(tb, r.mid[lane])) {
    write_initial(out, lane);
    return;
  }
  Lane<kDelta> ln;
  ln.begin(tb, r, lane);
  while (!ln.step(tb.grid, r)) {
  }
  ln.finish(out);
}

// The gradients the backward writes (null: not asked for).
struct Grads {
  const float* gw;   // (n, 3) the weight's cotangent
  const float* gt;   // (n,) T1's t's cotangent, or null
  float* sigma_t;    // (K, 3)
  float* grid;       // the grid stack's shape
  float* o;          // (n, 3)
  float* d;          // (n, 3)
  float* t_max;      // (n,)
};

// The backward of one tracked lane: replay, then the reverse sweep. The
// extinction's gradient is summed into acc (3 floats).
template <bool kDelta>
__device__ void backward_lane(const Table& tb, const Rays& r, const Grads& g, int64_t lane,
                              float acc[3]) {
  Lane<kDelta> ln;
  ln.begin(tb, r, lane);
  const Medium& m = ln.m;
  float wp[kBwdSteps][3], tn_s[kBwdSteps], dn_s[kBwdSteps];
  int k = 0;
  bool real = false, passed = false;
  const int n_steps = r.n_steps < kBwdSteps ? r.n_steps : kBwdSteps;
  for (int s = 0; s < n_steps; ++s) {
    const float tn = ln.t_new(r.dim_base);
    const float u = kDelta ? ln.u2(r.dim_base) : 0.f;
    ++ln.steps;
    if (tn >= ln.tmax) {
      passed = true;
      break;
    }
    const float dens = ln.dens_at(tb.grid, tn);
    float f[3];
    if (kDelta) {
      real = delta_factor(m, dens, u, f);
    } else {
      float x[3];
      ratio_factor(m, dens, f, x);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wp[k][c] = ln.w[c];
      ln.w[c] = __fmul_rn(ln.w[c], f[c]);
    }
    tn_s[k] = tn;
    dn_s[k] = dens;
    ++k;
    ln.t = tn;
    if (real) break;
  }
  if (g.t_max != nullptr) g.t_max[lane] = kDelta && passed ? g.gt[lane] : 0.f;
  float cw[3] = {g.gw[3 * lane], g.gw[3 * lane + 1], g.gw[3 * lane + 2]};
  float go[3] = {0.f, 0.f, 0.f}, gd[3] = {0.f, 0.f, 0.f};
  const bool rays = g.o != nullptr;
  for (int j = k - 1; j >= 0; --j) {
    const float dens = dn_s[j];
    float f[3], gs[3];
    if (kDelta) {
      const float s0 = __fmul_rn(m.sig[0], dens), s1 = __fmul_rn(m.sig[1], dens),
                  s2 = __fmul_rn(m.sig[2], dens);
      const float sp[3] = {s0, s1, s2};
      const float mean = __fdiv_rn(__fadd_rn(__fadd_rn(s0, s1), s2), 3.f);
      const float p_real = clamp(__fdiv_rn(mean, m.maj), 0.f, 1.f);
      const float den = __fmul_rn(m.maj, __fsub_rn(1.f, p_real));
      const bool re = real && j == k - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gf = __fmul_rn(cw[c], wp[j][c]);
        if (re) {
          f[c] = mean != 0.f ? __fdiv_rn(sp[c], mean) : 0.f;
          gs[c] = mean != 0.f ? __fdiv_rn(gf, mean) : 0.f;
        } else {
          f[c] = den != 0.f ? __fdiv_rn(__fsub_rn(m.maj, sp[c]), den) : 0.f;
          gs[c] = den != 0.f ? -__fdiv_rn(gf, den) : 0.f;
        }
      }
    } else {
      float x[3];
      ratio_factor(m, dens, f, x);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gf = __fmul_rn(cw[c], wp[j][c]);
        gs[c] = (x[c] >= 0.f && x[c] <= 1.f) ? __fdiv_rn(-gf, m.maj) : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cw[c] = __fmul_rn(cw[c], f[c]);
      acc[c] = __fadd_rn(acc[c], __fmul_rn(dens, gs[c]));
    }
    const float gdn = __fadd_rn(__fadd_rn(__fmul_rn(m.sig[0], gs[0]), __fmul_rn(m.sig[1], gs[1])),
                                __fmul_rn(m.sig[2], gs[2]));
    if (gdn == 0.f || (g.grid == nullptr && !rays)) continue;
    const float tn = tn_s[j];
    const Cell c = locate(m, __fadd_rn(ln.ox, __fmul_rn(tn, ln.dx)),
                          __fadd_rn(ln.oy, __fmul_rn(tn, ln.dy)),
                          __fadd_rn(ln.oz, __fmul_rn(tn, ln.dz)));
    if (!c.inside) continue;
    const float tz = c.t[0], ty = c.t[1], tx = c.t[2];
    const float ga = __fmul_rn(gdn, __fsub_rn(1.f, tz)), gb = __fmul_rn(gdn, tz);
    const float gzy[2][2] = {{__fmul_rn(ga, __fsub_rn(1.f, ty)), __fmul_rn(ga, ty)},
                             {__fmul_rn(gb, __fsub_rn(1.f, ty)), __fmul_rn(gb, ty)}};
    if (g.grid != nullptr) {
#pragma unroll
      for (int z = 0; z < 2; ++z)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          atomicAdd(g.grid + c.at(m, z, y, 0), __fmul_rn(gzy[z][y], __fsub_rn(1.f, tx)));
          atomicAdd(g.grid + c.at(m, z, y, 1), __fmul_rn(gzy[z][y], tx));
        }
    }
    if (!rays) continue;
    float v[2][2][2];
    corners(tb.grid, m, c, v);
    float row[2][2];
#pragma unroll
    for (int z = 0; z < 2; ++z)
#pragma unroll
      for (int y = 0; y < 2; ++y) row[z][y] = lerp(v[z][y][0], v[z][y][1], tx);
    float gt3[3];
    gt3[0] = __fmul_rn(gdn, __fsub_rn(lerp(row[1][0], row[1][1], ty),
                                      lerp(row[0][0], row[0][1], ty)));
    gt3[1] = __fadd_rn(__fmul_rn(ga, __fsub_rn(row[0][1], row[0][0])),
                       __fmul_rn(gb, __fsub_rn(row[1][1], row[1][0])));
    gt3[2] = 0.f;
#pragma unroll
    for (int z = 0; z < 2; ++z)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        gt3[2] = __fadd_rn(gt3[2], __fmul_rn(gzy[z][y], __fsub_rn(v[z][y][1], v[z][y][0])));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float gg = __fmul_rn(gt3[a], __fsub_rn((float)m.dims[a], 1.f));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float gp = __fmul_rn(gg, m.w2g[4 * a + q]);
        go[q] = __fadd_rn(go[q], gp);
        gd[q] = __fadd_rn(gd[q], __fmul_rn(gp, tn));
      }
    }
  }
  if (rays) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      g.o[3 * lane + q] = go[q];
      g.d[3 * lane + q] = gd[q];
    }
  }
}

// A lane's sigma_t gradient acc added into the block's sums in shared
// memory (3 K floats), which the block adds once into global memory.
__device__ __forceinline__ void add_sigma(float* s_sig, int64_t mid, const float acc[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (acc[c] != 0.f) atomicAdd(s_sig + 3 * mid + c, acc[c]);
}

__device__ __forceinline__ void flush_sigma(const Grads& g, const float* s_sig, int k_media) {
  if (g.sigma_t != nullptr)
    for (int i = threadIdx.x; i < 3 * k_media; i += kThreads)
      if (s_sig[i] != 0.f) atomicAdd(g.sigma_t + i, s_sig[i]);
}

// T1-bwd / T2-bwd: a thread a lane over every lane, no list and no
// counter. A lane outside a heterogeneous medium writes zero ray and t_max
// gradients, so that the wrapper zeroes none of them.
template <bool kDelta>
__device__ void track_bwd_all(const Table& tb, const Rays& r, const Grads& g, int k_media) {
  extern __shared__ float s_sig[];
  for (int i = threadIdx.x; i < 3 * k_media; i += kThreads) s_sig[i] = 0.f;
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane < r.n) {
    const int64_t mid = r.mid[lane];
    if (tracks(tb, mid)) {
      float acc[3] = {0.f, 0.f, 0.f};
      backward_lane<kDelta>(tb, r, g, lane, acc);
      if (g.sigma_t != nullptr) add_sigma(s_sig, mid, acc);
    } else {
      if (g.o != nullptr) {
#pragma unroll
        for (int q = 0; q < 3; ++q) g.o[3 * lane + q] = g.d[3 * lane + q] = 0.f;
      }
      if (g.t_max != nullptr) g.t_max[lane] = 0.f;
    }
  }
  __syncthreads();
  flush_sigma(g, s_sig, k_media);
}

// The kernels by the names a profiler trace gives them.
#define MCT_KERNEL(name, body, ...)                                               \
  __global__ void __launch_bounds__(kThreads) name(__VA_ARGS__) { body; }
MCT_KERNEL(medium_delta_track_kernel, track_all<true>(tb, r, out), Table tb, Rays r, Out out)
MCT_KERNEL(medium_ratio_track_kernel, track_all<false>(tb, r, out), Table tb, Rays r, Out out)
MCT_KERNEL(medium_delta_track_bwd_kernel, track_bwd_all<true>(tb, r, g, k_media), Table tb,
           Rays r, Grads g, int k_media)
MCT_KERNEL(medium_ratio_track_bwd_kernel, track_bwd_all<false>(tb, r, g, k_media), Table tb,
           Rays r, Grads g, int k_media)
#undef MCT_KERNEL

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

Table make_table(const int64_t* m_type, const float* sigma_t, const float* majorant,
                 const float* world_to_grid, const int64_t* grid_slot,
                 const int64_t* grid_dims, const float* grid, int64_t gd, int64_t gh,
                 int64_t gw) {
  return Table{m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims, grid,
               gd, gh, gw};
}

// Launch `kernel` on a block a 128 lanes.
template <typename K, typename... A>
cudaError_t launch(K kernel, int64_t n, size_t smem, cudaStream_t stream, A... args) {
  kernel<<<blocks_for(n), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

int track(bool delta, const Rays& r, const Table& tb, const Out& out, cudaStream_t stream) {
  if (r.n <= 0) return (int)cudaGetLastError();
  return (int)launch(delta ? medium_delta_track_kernel : medium_ratio_track_kernel, r.n, 0, stream,
                     tb, r, out);
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32; mid: (n,) i64 each lane's medium
// (-1: vacuum); key: (n,) i64 hash_combine(seed, lane) in its low 32 bits;
// dim_base: the loop's first sampler dimension (mod 2^32); n_steps: the
// most updates a lane makes (257 primal, 48 in ad_mode). The table (K
// media): m_type (K,) i64, sigma_t (K, 3) f32, majorant (K,) f32,
// world_to_grid (K, 3, 4) f32, grid_slot (K,) i64, grid_dims (K, 3) i64,
// grid (Kg, gd, gh, gw) f32. out_t: (n,) f32; out_w: (n, 3) f32;
// out_scat: (n,) u8; out_steps: (n,) i32, the updates the lane made (0
// outside a heterogeneous medium).
extern "C" int mct_delta_track(const float* o, const float* d, const float* t_max,
                               const int64_t* mid, const int64_t* key, uint32_t dim_base,
                               int64_t n, int n_steps, const int64_t* m_type,
                               const float* sigma_t, const float* majorant,
                               const float* world_to_grid, const int64_t* grid_slot,
                               const int64_t* grid_dims, const float* grid, int64_t gd,
                               int64_t gh, int64_t gw, float* out_t, float* out_w,
                               uint8_t* out_scat, int32_t* out_steps, cudaStream_t stream) {
  const Rays r{o, d, t_max, mid, key, dim_base, n, n_steps};
  return track(true, r,
               make_table(m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims, grid,
                          gd, gh, gw),
               Out{out_t, out_w, out_scat, out_steps}, stream);
}

// As mct_delta_track, with t_max the shadow segment's length (finite);
// out_w: (n, 3) f32 the transmittance; out_steps as above.
extern "C" int mct_ratio_track(const float* o, const float* d, const float* dist,
                               const int64_t* mid, const int64_t* key, uint32_t dim_base,
                               int64_t n, int n_steps, const int64_t* m_type,
                               const float* sigma_t, const float* majorant,
                               const float* world_to_grid, const int64_t* grid_slot,
                               const int64_t* grid_dims, const float* grid, int64_t gd,
                               int64_t gh, int64_t gw, float* out_w, int32_t* out_steps,
                               cudaStream_t stream) {
  const Rays r{o, d, dist, mid, key, dim_base, n, n_steps};
  return track(false, r,
               make_table(m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims, grid,
                          gd, gh, gw),
               Out{nullptr, out_w, nullptr, out_steps}, stream);
}

// T1-bwd (delta 1) / T2-bwd (delta 0) over the lanes of a call of the
// forward at n_steps (at most 48) with the same inputs; k_media: K. gw:
// (n, 3) f32 the weight's (transmittance's) cotangent; gt: (n,) f32 T1's
// t's cotangent or null. g_sigma: (K, 3) f32, zeroed, added into; g_grid:
// the grid stack's shape, added into, or null; g_o, g_d: (n, 3) f32 or
// null (both or neither) and g_t_max: (n,) f32 or null (T1: gt on the
// lanes that passed, else 0; T2: 0), written on every lane.
extern "C" int mct_track_bwd(int delta, const float* o, const float* d, const float* t_max,
                             const int64_t* mid, const int64_t* key, uint32_t dim_base,
                             int64_t n, int n_steps, int k_media, const int64_t* m_type,
                             const float* sigma_t, const float* majorant,
                             const float* world_to_grid, const int64_t* grid_slot,
                             const int64_t* grid_dims, const float* grid, int64_t gd,
                             int64_t gh, int64_t gw, const float* g_w, const float* g_t,
                             float* g_sigma, float* g_grid, float* g_o, float* g_d,
                             float* g_t_max, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_steps > kBwdSteps || (delta && g_t_max != nullptr && g_t == nullptr))
    return (int)cudaErrorInvalidValue;
  const Table tb = make_table(m_type, sigma_t, majorant, world_to_grid, grid_slot, grid_dims,
                              grid, gd, gh, gw);
  const Rays r{o, d, t_max, mid, key, dim_base, n, n_steps};
  const Grads g{g_w, g_t, g_sigma, g_grid, g_o, g_d, g_t_max};
  const size_t smem = (size_t)3 * k_media * sizeof(float);
  return (int)launch(delta ? medium_delta_track_bwd_kernel : medium_ratio_track_bwd_kernel, n,
                     smem, stream, tb, r, g, k_media);
}
