// The emitter stage of a path-tracer bounce: three kernels, one thread a
// lane, over every lane of the wavefront.
//
// Replaces no TPU kernel. The JAX package leaves this stage to XLA, which
// fuses it (mitsuba_customization_tpu/render/emitters.py and the bounce
// bodies of render/integrator.py); in PyTorch the same code is ~370
// launches a bounce, each a pass over the lanes (render/emitters.py's
// plain functions, which stay the reference and run every CPU call).
//
//   emitter_hit (after intersect): eval_hit, pdf_hit_direction,
//     eval_background, pdf_miss_direction and the power-heuristic weight
//     against the previous bounce's NEE (1 after a delta lobe): rad * w_mis
//     where the caller's mask holds, 0 elsewhere.
//   emitter_sample (the NEE point): sample_direction for area and constant
//     emitters (the emitter by the selection CDF, the prim by its emitter's
//     row of prim_dist, a point on a triangle, sphere or cylinder), the
//     three NEE uniforms of an independent sampler (hash_combine(lane key,
//     dim) in uint32, bit-equal to its next_1d), the direction in the
//     shading frame and the lanes whose shadow ray is traced.
//   emitter_nee (after the BSDF): radiance * w_nee / pdf where the shadow
//     ray is clear, w_nee the weight against the BSDF's pdf (1 for a delta
//     emitter).
//
// What bounds them on the H100: the lane I/O (~350 B a lane a bounce in
// all). The tables (K emitters, Q emissive prims and their rows of
// geometry) stay in L1 and L2. The products with the throughput and the
// BSDF value stay in PyTorch: they carry the gradient under AD.
//
// Arithmetic is that of the plain PyTorch code on the card, op by op, as
// in bsdf_shade.cu: each product and sum rounded on its own (this file is
// built with -fmad=false), a division by a tensor an IEEE division, a
// Python constant rounded once to float from its double, IEEE sqrtf /
// sinf / cosf, rsqrtf where torch calls rsqrt, clamps that pass NaN
// through, safe_div's zero guard, a sum(-1) of three as (x + z) + y and
// torch.linalg.cross with one fused multiply-add a component.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The entry points' argument structs (ops/emitter_shade.py mirrors them in
// ctypes): outside the anonymous namespace, as the extern "C" functions
// that take them must keep external linkage.
namespace emitter_shade {

struct Table {  // render/emitters.EmitterTable's rows, and the scene's geometry
  const int64_t* em_type;    // (K,)
  const float* radiance;     // (K, 3)
  const float* sel_pmf;      // (K,)
  const float* sel_cdf;      // (K,)
  const float* prim_pmf;     // (K, Q)
  const float* prim_cdf;     // (K, Q)
  const int64_t* em_prims;   // (Q,)
  const float* prim_area;    // (Q,)
  const int64_t* prim_to_q;  // (P,)
  const int64_t* prim_type;  // (P,)
  const float* p0;           // (P, 3)
  const float* e1;           // (P, 3)
  const float* e2;           // (P, 3)
  int64_t n_emitters;
  int64_t n_q;
  int64_t background;  // the constant emitter's id, -1 without one
  int32_t has_area;    // emissive prims exist
  int32_t sample_area;      // has_area and AREA among the table's types
  int32_t sample_constant;  // CONSTANT among the table's types
};

struct HitArgs {
  int64_t n;
  Table table;
  const uint8_t* valid;    // (n,) the hit record
  const float* p;          // (n, 3)
  const float* ng;         // (n, 3) geometric normal
  const float* fs;         // (n, 3) shading frame
  const float* ft;         // (n, 3)
  const float* fn;         // (n, 3)
  const float* wi;         // (n, 3) in the shading frame
  const int64_t* prim;     // (n,)
  const int64_t* emitter;  // (n,)
  const float* ray_o;      // (n, 3)
  const float* prev_pdf;   // (n,)
  const uint8_t* prev_delta;  // (n,)
  const uint8_t* mask;     // (n,)
  float* out;              // (n, 3)
};

struct SampleArgs {
  int64_t n;
  Table table;
  const float* p_ref;  // (n, 3)
  const float* fs;     // (n, 3) shading frame
  const float* ft;     // (n, 3)
  const float* fn;     // (n, 3)
  const int64_t* lane_key;  // (n,) an independent sampler's lane keys, or NULL
  int64_t dim;              // the first NEE draw's dimension, with lane_key
  const float* u3;          // (n, 3) the draws, without lane_key
  const uint8_t* mask;      // (n,)
  int32_t depth_ok;
  int32_t refl_only;  // nee_ok needs the direction above the horizon
  // outputs: out (12, n) planar = d (n, 3), dist, pdf, radiance (n, 3),
  // p_area, wo_local (n, 3); flags (2, n) = delta, nee_ok
  float* out;
  uint8_t* flags;
};

struct NeeArgs {
  int64_t n;
  const float* radiance;  // (n, 3)
  const float* pdf;       // (n,)
  const uint8_t* delta;   // (n,)
  const float* pdf_nee;   // (n,)
  const uint8_t* vis;     // (n,)
  float* out;             // (n, 3)
};

}  // namespace emitter_shade

namespace {

using emitter_shade::HitArgs;
using emitter_shade::NeeArgs;
using emitter_shade::SampleArgs;
using emitter_shade::Table;

constexpr int kThreads = 256;
constexpr int64_t kScan = 32;  // rows up to this long are scanned, longer ones searched

constexpr int64_t kArea = 0, kConstant = 1;  // render/emitters.py AREA, CONSTANT
constexpr int64_t kTri = 0, kCylinder = 2;   // render/geometry.py TRI, CYLINDER

// Python constants as PyTorch hands them to a float32 kernel
constexpr double kPiD = 3.14159265358979323846;
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kInvFourPi = (float)(1.0 / (4.0 * kPiD));
constexpr float kOneMinus = (float)(1.0 - 1e-7);
constexpr float kTiny = (float)1e-20;    // core/distr._TINY
constexpr float kEps2 = (float)(1e-7 * 1e-7);  // safe_rsqrt's clamp
constexpr float kEps12 = (float)1e-12;  // the clamps of dist2, |e1| and the prim area

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
// torch's sum(-1) over three floats adds them as (x + z) + y on the card
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.z * b.z) + a.y * b.y; }
// torch.linalg.cross on the card: one fused multiply-add a component
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// torch.clamp: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
__device__ __forceinline__ int64_t clamp_i(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float safe_div(float a, float b) { return b == 0.f ? 0.f : a / b; }
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(clamp_min(x, 0.f)); }
__device__ __forceinline__ V3 normalize(V3 v) { return scale(v, rsqrtf(clamp_min(dot(v, v), kEps2))); }

// render/integrator.mis_weight: the power heuristic
__device__ __forceinline__ float mis_weight(float a, float b) {
  const float a2 = a * a;
  const float w = safe_div(a2, a2 + b * b);
  return a > 0.f ? w : 0.f;
}

// core/qmc.hash_combine and IndependentSampler's draw, in uint32 registers
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float draw(uint32_t key, uint32_t dim) {
  const uint32_t mixed = dim + 0x9E3779B9u + (key << 6) + (key >> 2);
  return (float)(hash_u32(key ^ mixed) >> 8) * (float)(1.0 / (1 << 24));
}

// core/distr._invert_cdf on a nondecreasing row of w floats at u: the count
// of values below u clipped to w - 1, lo and mass. Short rows are scanned,
// long ones searched: the count is the same on a nondecreasing row.
__device__ int64_t invert_row(const float* __restrict__ row, int64_t w, float u, float& lo,
                              float& mass) {
  int64_t c = 0;
  if (w <= kScan) {
    for (int64_t i = 0; i < w; ++i) c += __ldg(row + i) < u ? 1 : 0;
    c = c < w - 1 ? c : w - 1;
  } else {
    for (int64_t len = w - 1; len > 0;) {
      const int64_t half = len >> 1;
      if (__ldg(row + c + half) < u) {
        c += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
  }
  const float hi = __ldg(row + c);
  lo = hi < u ? hi : (c > 0 ? __ldg(row + c - 1) : 0.f);
  lo = fminf(lo, hi);
  mass = hi - lo;
  return c;
}

// DiscreteDistribution.sample_reuse: (index, the re-uniformized u)
__device__ __forceinline__ int64_t sample_reuse(const float* row, int64_t w, float u,
                                                float& u_out) {
  float lo, mass;
  const int64_t idx = invert_row(row, w, u, lo, mass);
  u_out = clamp((u - lo) / clamp_min(mass, kTiny), 0.f, kOneMinus);
  return idx;
}

// core/warp.square_to_uniform_sphere
__device__ __forceinline__ V3 uniform_sphere(float s0, float s1) {
  const float z = 1.f - 2.f * s0;
  const float r = safe_sqrt(1.f - z * z);
  const float phi = kTwoPi * s1;
  return {r * cosf(phi), r * sinf(phi), z};
}

// core/math.coordinate_system (Duff et al.): -1 / (s + z) is torch's
// reciprocal times -1
__device__ __forceinline__ void coordinate_system(V3 n, V3& s_out, V3& t_out) {
  const float s = n.z >= 0.f ? 1.f : -1.f;
  const float a = (1.f / (s + n.z)) * -1.f;
  const float b = n.x * n.y * a;
  s_out = {1.f + s * n.x * n.x * a, s * b, -s * n.x};
  t_out = {b, s + n.y * n.y * a, -n.y};
}

// render/emitters._sample_position_on_prim: a uniform point on the prim and
// its outward normal
__device__ void position_on_prim(const Table& t, int64_t prim, float s0, float s1, V3& p,
                                 V3& nrm) {
  const int64_t type = t.prim_type[prim];
  const V3 p0 = load3(t.p0, prim), e1 = load3(t.e1, prim), e2 = load3(t.e2, prim);
  if (type == kTri) {
    const float r = safe_sqrt(1.f - s0);
    const float b0 = 1.f - r, b1 = r * s1;
    p = add(add(p0, scale(e1, b0)), scale(e2, b1));
    nrm = normalize(cross(e1, e2));
  } else if (type == kCylinder) {
    const float len = clamp_min(sqrtf(dot(e1, e1)), kEps12);
    const V3 axis = {e1.x / len, e1.y / len, e1.z / len};
    V3 fs, ft;
    coordinate_system(axis, fs, ft);
    const float phi = kTwoPi * s0;
    const float c = cosf(phi), sn = sinf(phi);
    nrm = add(scale(fs, c), scale(ft, sn));
    p = add(add(p0, scale(axis, s1 * len)), scale(nrm, e2.x));
  } else {  // sphere
    const V3 d = uniform_sphere(s0, s1);
    p = add(p0, scale(d, e1.x));
    nrm = d;
  }
}

__global__ void __launch_bounds__(kThreads) emitter_hit_kernel(const HitArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  if (!a.mask[lane]) {
    store3(a.out, lane, {0.f, 0.f, 0.f});
    return;
  }
  const Table& t = a.table;
  V3 rad = {0.f, 0.f, 0.f};
  float em_pdf = 0.f;
  if (a.valid[lane]) {
    // eval_hit: area emitters, front side only
    const int64_t emitter = a.emitter[lane];
    const int64_t em = emitter < 0 ? 0 : emitter;
    const V3 ng = load3(a.ng, lane), wi = load3(a.wi, lane);
    const V3 w = add(add(scale(load3(a.fs, lane), wi.x), scale(load3(a.ft, lane), wi.y)),
                     scale(load3(a.fn, lane), wi.z));
    if (emitter >= 0 && dot(ng, w) > 0.f && t.em_type[em] == kArea) rad = load3(t.radiance, em);
    // pdf_hit_direction: NEE's density of the hit point, in solid angle
    if (t.has_area) {
      const int64_t prim = a.prim[lane];
      const int64_t q_raw = t.prim_to_q[prim < 0 ? 0 : prim];
      const int64_t q = q_raw < 0 ? 0 : q_raw;
      const float pmf_q = t.prim_pmf[clamp_i(em, 0, t.n_emitters - 1) * t.n_q +
                                     clamp_i(q, 0, t.n_q - 1)];
      const float sel = t.sel_pmf[clamp_i(em, 0, t.n_emitters - 1)];
      const V3 to_x = sub(load3(a.p, lane), load3(a.ray_o, lane));
      const float dist2 = dot(to_x, to_x);
      const V3 d = scale(to_x, rsqrtf(clamp_min(dist2, kEps2)));
      const float cos_e = dot(ng, neg(d));
      const float pdf_sa = safe_div(pmf_q / clamp_min(t.prim_area[q], kEps12) * dist2, cos_e);
      em_pdf = prim >= 0 && emitter >= 0 && cos_e > 0.f ? sel * pdf_sa : 0.f;
    }
  } else if (t.background >= 0) {
    // eval_background and pdf_miss_direction: the constant sky
    const V3 r = load3(t.radiance, t.background);
    rad = {0.f + r.x, 0.f + r.y, 0.f + r.z};
    em_pdf = 0.f + t.sel_pmf[t.background] * kInvFourPi;
  }
  const float w_mis = a.prev_delta[lane] ? 1.f : mis_weight(a.prev_pdf[lane], em_pdf);
  store3(a.out, lane, scale(rad, w_mis));
}

__global__ void __launch_bounds__(kThreads) emitter_sample_kernel(const SampleArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  const int64_t n = a.n;
  const Table& t = a.table;
  float u[3];
  if (a.lane_key != nullptr) {
    const uint32_t key = (uint32_t)a.lane_key[lane];
    for (int i = 0; i < 3; ++i) u[i] = draw(key, (uint32_t)(a.dim + i));
  } else {
    for (int i = 0; i < 3; ++i) u[i] = a.u3[3 * lane + i];
  }
  // the emitter; its u re-uniformized picks the prim and the sky direction
  float u0;
  const int64_t k = sample_reuse(t.sel_cdf, t.n_emitters, u[0], u0);
  const int64_t et = t.em_type[k];
  const float sel_pmf = t.sel_pmf[k];
  const V3 rad_k = load3(t.radiance, k);
  const V3 p_ref = load3(a.p_ref, lane);

  V3 d = {0.f, 0.f, 0.f}, rad = {0.f, 0.f, 0.f};
  float dist = INFINITY, pdf = 0.f, p_area = 0.f;
  if (t.sample_area && et == kArea) {
    float unused;
    const int64_t q = sample_reuse(t.prim_cdf + k * t.n_q, t.n_q, u0, unused);
    V3 x, n_e;
    position_on_prim(t, t.em_prims[q], u[1], u[2], x, n_e);
    const V3 to_x = sub(x, p_ref);
    const float dist2 = dot(to_x, to_x);
    dist = sqrtf(clamp_min(dist2, kEps12));
    d = {to_x.x / dist, to_x.y / dist, to_x.z / dist};
    const float cos_e = dot(n_e, neg(d));
    const float pa = safe_div(t.prim_pmf[k * t.n_q + q], t.prim_area[q]);
    const bool front = cos_e > 0.f;
    pdf = front ? safe_div(pa * dist2, cos_e) : 0.f;
    rad = front ? rad_k : V3{0.f, 0.f, 0.f};
    p_area = front ? pa * sel_pmf : 0.f;
  } else if (t.sample_constant && et == kConstant) {
    d = uniform_sphere(u0, u[1]);
    pdf = kInvFourPi;
    rad = rad_k;
  }
  pdf = pdf * sel_pmf;
  const V3 wo = {dot(d, load3(a.fs, lane)), dot(d, load3(a.ft, lane)),
                 dot(d, load3(a.fn, lane))};
  const bool ok = a.mask[lane] && pdf > 0.f && a.depth_ok && (!a.refl_only || wo.z > 0.f);

  float* out = a.out;
  store3(out, lane, d);
  out[3 * n + lane] = dist;
  out[4 * n + lane] = pdf;
  store3(out + 5 * n, lane, rad);
  out[8 * n + lane] = p_area;
  store3(out + 9 * n, lane, wo);
  a.flags[lane] = 0;  // delta: no delta emitter takes this route
  a.flags[n + lane] = ok;
}

__global__ void __launch_bounds__(kThreads) emitter_nee_kernel(const NeeArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  V3 e = {0.f, 0.f, 0.f};
  if (a.vis[lane]) {
    const float pdf = a.pdf[lane];
    const float w = a.delta[lane] ? 1.f : mis_weight(pdf, a.pdf_nee[lane]);
    e = scale(load3(a.radiance, lane), safe_div(w, pdf));
  }
  store3(a.out, lane, e);
}

unsigned blocks_of(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int mct_emitter_hit(const emitter_shade::HitArgs* args, cudaStream_t stream) {
  if (args->n > 0) emitter_hit_kernel<<<blocks_of(args->n), kThreads, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int mct_emitter_sample(const emitter_shade::SampleArgs* args, cudaStream_t stream) {
  if (args->n > 0) emitter_sample_kernel<<<blocks_of(args->n), kThreads, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int mct_emitter_nee(const emitter_shade::NeeArgs* args, cudaStream_t stream) {
  if (args->n > 0) emitter_nee_kernel<<<blocks_of(args->n), kThreads, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}
