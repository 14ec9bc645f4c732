// The BSDF stage of a path-tracer bounce around K1 and K2: two kernels,
// one thread a lane, over every lane of the wavefront.
//
// Replaces no TPU kernel. The JAX package leaves this stage to XLA, which
// fuses the dispatch's elementwise work (mitsuba_customization_tpu/models/
// bsdf.py `bounce_shade`, models/tabulated.py `bounce_shade`); in PyTorch
// the same code is ~900 launches a bounce, each a full pass over the lanes
// (models/bsdf.py `_bounce_shade_plain`, which stays the reference).
//
// What bounds it on the H100: the lane I/O (~100 B a lane in, ~60 B out,
// and the tabulated lanes' ~150 B of state, indices and masks handed to
// K2, the post kernel and K1). The parameter stacks, the marginal CDF rows
// (40 KB for ten materials) and the mat_type / mat_slot tables stay in L1
// and L2. So the design is the fewest passes: pre computes every output of
// the diffuse and rough-conductor lanes and everything of the tabulated
// lanes before K2; post everything between K2 and K1. K1 and K2 stay as
// they are, between and after the two.
//
//   bsdf_shade_pre: models/diffuse.py and models/roughconductor.py (sample
//     at (sample2, sample1), eval and pdf toward wo_nee), and
//     models/tabulated.bounce_shade up to K2: the canonical frame, the
//     mixture branch, the marginal-row inversion (core/distr._invert_cdf's
//     semantics, by binary search as K2 does), the NEE and cosine cells.
//   bsdf_shade_post: tabulated.bounce_shade from K2's outputs to K1's
//     inputs: the sampled half vector and direction, the three table pdfs,
//     pdf_s, pdf_nee, K1's second mask and the per-lane scales that turn
//     K1's f into f_nee and the weight (s_nee = max(cos wo_nee, 0) from
//     pre; s_s = max(cos wo, 0) / pdf_s where the sample is valid).
//
// Arithmetic is that of the plain PyTorch code on the card, op by op: each
// product and sum rounded on its own (this file is built with
// -fmad=false), a division by a Python scalar as a product with its float
// reciprocal (as PyTorch's CUDA division by a CPU scalar does), IEEE
// sinf / cosf / atan2f / acosf / expf / logf / sqrtf, rsqrtf where torch
// calls rsqrt, clamps that pass NaN through, and safe_div's zero guards.
// A dot product adds its products in the order torch's sum(-1) does, and
// the cross product fuses as torch.linalg.cross does on the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The entry points' argument structs (ops/bsdf_shade.py mirrors them in
// ctypes): outside the anonymous namespace, as the extern "C" functions
// that take them must keep external linkage.
namespace bsdf_shade {

struct Rough {  // RoughConductorParams, (n,) and (n, 3) rows
  const float* alpha_u;
  const float* alpha_v;
  const float* eta;
  const float* k;
  const float* spec;
  int64_t n;
};

struct PreArgs {
  int64_t n;
  const int64_t* mat_id;
  const int64_t* mat_type;
  const int64_t* mat_slot;
  int64_t n_mat;
  const float* wi;       // (n, 3)
  const float* wo_nee;   // (n, 3)
  const float* sample2;  // (n, 2)
  const float* sample1;  // (n,) or NULL
  const uint8_t* active;    // (n,) or NULL (all)
  const uint8_t* nee_mask;  // (n,) or NULL (all)
  int32_t has_nee;
  // kernel ids of the fused kernels, -1 where absent or not fused
  int32_t kid_diffuse, kid_ggx, kid_beckmann, kid_tab;
  const float* reflectance;  // DiffuseParams, (n_diffuse, 3)
  int64_t n_diffuse;
  Rough ggx, beckmann;
  const float* cdf_row;  // (n_tab, n_theta_i, res_h), rows nondecreasing
  int64_t n_tab;
  int32_t n_theta_i, res_h, res_phi;
  // outputs: out (11, n) planar = f_nee (n, 3), pdf_nee, wo (n, 3),
  // pdf_s, weight (n, 3); the tabulated ones only with kid_tab >= 0
  float* out;
  uint8_t* is_delta;
  int64_t* idx;     // (7, n): K2's key, r_own, r_nee, c_nee, r_cos, c_cos; slot
  uint8_t* valid;   // (n,): K2's lanes
  uint8_t* flags;   // (n,)
  float* state;     // (kStateRows, n)
  uint8_t* masks;   // (2, n): K1's two masks
  float* scales;    // (2, n): s_nee, s_s
};

struct PostArgs {
  int64_t n;
  const uint8_t* flags;
  const float* state;
  const int64_t* r_own;
  const float* x;         // K2's outputs, (n,) each
  const float* mass_own;
  const float* mass_nee;
  const float* mass_cos;
  const float* sample2;  // (n, 2)
  int32_t remap;         // 1: no sample1, sample2[0] picks the branch
  int32_t res_h, res_phi;
  float* wo;        // (n, 3)
  float* pdf_s;     // (n,)
  float* pdf_nee;   // (n,)
  uint8_t* mask_b;  // (n,)
  float* s_s;       // (n,)
};

}  // namespace bsdf_shade

namespace {

using bsdf_shade::PostArgs;
using bsdf_shade::PreArgs;
using bsdf_shade::Rough;

constexpr int kThreads = 256;

// Python constants as PyTorch hands them to a float32 kernel
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
constexpr float kHalfPi = (float)(kPiD / 2.0);
constexpr float kQuarterPi = (float)(kPiD / 4.0);
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kTwoPiSq = (float)(2.0 * kPiD * kPiD);  // jac_h's 2 pi^2
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kCosMix = (float)0.1;         // tabulated.COSINE_MIX
constexpr float kTabMix = (float)(1.0 - 0.1);  // 1 - COSINE_MIX
constexpr float kOneMinus = (float)(1.0 - 1e-7);

// flags a tabulated lane hands from pre to post
constexpr uint8_t kTab = 1, kCosWiOk = 2, kUseCos = 4, kNeeOk = 8;
// rows of the tabulated state (planar, n floats a row)
enum { kThetaI, kPhiI, kDy, kRowMassOwn, kRowMassCos, kDenomCos, kRowMassNee,
       kDenomNee, kPCosNee, kStateRows };

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
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
// torch's sum(-1) over three floats adds them as (x + z) + y on the card
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.z * b.z) + a.y * b.y; }

// torch.clamp: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
__device__ __forceinline__ int64_t clamp_i(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float safe_div(float a, float b, float dflt = 0.f) {
  return b == 0.f ? dflt : a / b;
}
// a / s for a Python scalar s: PyTorch's CUDA division multiplies by 1 / s
__device__ __forceinline__ float div_scalar(float a, float s) { return a * (1.f / s); }
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(clamp_min(x, 0.f)); }
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, rsqrtf(clamp_min(dot(v, v), 1e-14f)));
}
__device__ __forceinline__ V3 reflect_about(V3 wi, V3 h) {  // 2 (wi.h) h - wi
  return sub(scale(h, 2.f * dot(wi, h)), wi);
}
__device__ __forceinline__ V3 rotate_phi(V3 v, float phi) {
  const float c = cosf(phi), s = sinf(phi);
  return {c * v.x - s * v.y, s * v.x + c * v.y, v.z};
}

// core/warp: concentric disk, cosine hemisphere
__device__ __forceinline__ V3 cosine_hemisphere(float s0, float s1) {
  const float x = 2.f * s0 - 1.f, y = 2.f * s1 - 1.f;
  const bool is_zero = x == 0.f && y == 0.f;
  const bool qx = fabsf(x) > fabsf(y);
  float r = qx ? x : y;
  const float ratio = qx ? (x != 0.f ? y / (x == 0.f ? 1.f : x) : 0.f)
                         : (y != 0.f ? x / (y == 0.f ? 1.f : y) : 0.f);
  const float phi = qx ? kQuarterPi * ratio : kHalfPi - kQuarterPi * ratio;
  r = is_zero ? 0.f : r;
  const float px = r * cosf(phi), py = r * sinf(phi);
  return {px, py, safe_sqrt(1.f - px * px - py * py)};
}
__device__ __forceinline__ float cosine_hemisphere_pdf(V3 d) {
  return clamp_min(d.z, 0.f) * kInvPi;
}

// ---- models/diffuse.py ----

struct Shade {  // one lane's six outputs
  V3 f_nee = {0.f, 0.f, 0.f};
  float pdf_nee = 0.f;
  V3 wo = {0.f, 0.f, 0.f};
  float pdf_s = 0.f;
  V3 weight = {0.f, 0.f, 0.f};
};

__device__ void diffuse_lane(const PreArgs& a, int64_t slot, V3 wi, V3 wo_nee,
                             float s0, float s1, Shade& o) {
  const int64_t sl = clamp_i(slot, 0, a.n_diffuse - 1);
  const V3 refl = load3(a.reflectance, sl);
  const bool ci_ok = wi.z > 0.f;
  o.wo = cosine_hemisphere(s0, s1);
  o.pdf_s = ci_ok && o.wo.z > 0.f ? cosine_hemisphere_pdf(o.wo) : 0.f;
  o.weight = ci_ok ? refl : V3{0.f, 0.f, 0.f};
  if (a.has_nee) {
    const bool act = ci_ok && wo_nee.z > 0.f;
    const float c = kInvPi * clamp_min(wo_nee.z, 0.f);
    o.f_nee = act ? scale(refl, c) : V3{0.f, 0.f, 0.f};
    o.pdf_nee = act ? cosine_hemisphere_pdf(wo_nee) : 0.f;
  }
}

// ---- models/microfacet.py and models/roughconductor.py ----

template <bool kBeckmann>
__device__ float eval_ndf(float au, float av, V3 h) {
  const float cz = h.z;
  float d;
  if (!kBeckmann) {
    const float x = h.x / au, y = h.y / av;
    const float t = x * x + y * y + h.z * h.z;
    d = safe_div(1.f, kPi * au * av * t * t);
  } else {
    const float c2 = cz * cz;
    const float st2 = clamp_min(1.f - h.z * h.z, 0.f);
    const float t2 = safe_div(st2, c2);
    const float cphi2 = st2 > 0.f ? (h.x * h.x) / clamp_min(st2, 1e-12f) : 1.f;
    const float sphi2 = 1.f - cphi2;
    d = safe_div(expf(-t2 * (cphi2 / (au * au) + sphi2 / (av * av))),
                 kPi * au * av * c2 * c2);
  }
  return cz > 0.f ? d : 0.f;
}

template <bool kBeckmann>
__device__ float lambda_smith(float au, float av, V3 v) {
  const float vz = v.z;
  if (!kBeckmann) {
    const float x = au * v.x, y = av * v.y;
    const float t = safe_div(x * x + y * y, vz * vz);
    return 0.5f * (sqrtf(1.f + t) + -1.f);
  }
  const float xy2 = v.x * v.x + v.y * v.y;
  const float x = au * v.x, y = av * v.y;
  const float alpha2 = xy2 > 0.f ? (x * x + y * y) / clamp_min(xy2, 1e-12f) : au * au;
  const float tan_theta = safe_div(sqrtf(xy2), fabsf(vz));
  const float aa = safe_div(1.f, sqrtf(alpha2) * tan_theta, 1e8f);
  return aa < 1.6f ? safe_div(1.f - 1.259f * aa + 0.396f * aa * aa,
                              3.535f * aa + 2.181f * aa * aa)
                   : 0.f;
}

template <bool kBeckmann>
__device__ float smith_g1(float au, float av, V3 v, V3 h) {
  const float g = 1.f / (1.f + lambda_smith<kBeckmann>(au, av, v));
  return dot(v, h) * v.z <= 0.f ? 0.f : g;
}

template <bool kBeckmann>
__device__ float pdf_micronormal(float au, float av, V3 wi, V3 h) {
  if (kBeckmann) return eval_ndf<true>(au, av, h) * clamp_min(h.z, 0.f);
  const float d = eval_ndf<false>(au, av, h);
  const float g1 = smith_g1<false>(au, av, wi, h);
  return safe_div(g1 * clamp_min(dot(wi, h), 0.f) * d, fabsf(wi.z));
}

template <bool kBeckmann>
__device__ V3 sample_micronormal(float au, float av, V3 wi, float s0, float s1) {
  if (kBeckmann) {
    const float a2 = au * au;
    const float t2 = -a2 * logf(clamp_min(1.f - s0, 1e-12f));
    const float cos_t = 1.f / sqrtf(1.f + t2);
    const float sin_t = sqrtf(clamp_min(1.f - cos_t * cos_t, 0.f));
    const float phi = kTwoPi * s1;
    return {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
  }
  // Heitz 2018 visible normals
  const V3 vh = normalize({au * wi.x, av * wi.y, wi.z});
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = rsqrtf(clamp_min(lensq, 1e-14f));
  const V3 t1 = lensq > 1e-12f ? V3{-vh.y * inv_len, vh.x * inv_len, 0.f}
                               : V3{1.f, 0.f, 0.f};
  // torch.linalg.cross on the card: one fused multiply-add a component
  const V3 t2 = {fmaf(vh.y, t1.z, -(vh.z * t1.y)), fmaf(vh.z, t1.x, -(vh.x * t1.z)),
                 fmaf(vh.x, t1.y, -(vh.y * t1.x))};
  const float r = sqrtf(s0);
  const float phi = kTwoPi * s1;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.f + vh.z);
  p2 = (1.f - s) * safe_sqrt(1.f - p1 * p1) + s * p2;
  const float sq = safe_sqrt(1.f - p1 * p1 - p2 * p2);
  const V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vh, sq));
  return normalize({au * nh.x, av * nh.y, clamp_min(nh.z, 1e-6f)});
}

__device__ float fresnel_conductor(float cos_i, float eta, float k) {
  const float c = clamp_min(fabsf(cos_i), 1e-6f);
  const float c2 = c * c;
  const float s2 = 1.f - c2;
  const float e2 = eta * eta, k2 = k * k;
  const float t0 = e2 - k2 - s2;
  const float a2b2 = safe_sqrt(t0 * t0 + 4.f * e2 * k2);
  const float t1 = a2b2 + c2;
  const float aa = safe_sqrt(0.5f * (a2b2 + t0));
  const float t2 = 2.f * aa * c;
  const float rs = (t1 - t2) / clamp_min(t1 + t2, 1e-12f);
  const float t3 = c2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 - t4) / clamp_min(t3 + t4, 1e-12f);
  return 0.5f * (rp + rs);
}

struct RoughLane {
  float au, av;
  V3 eta, k, spec;
};

template <bool kBeckmann>
__device__ V3 rough_eval(const RoughLane& p, V3 wi, V3 wo) {
  const float ci = wi.z, co = wo.z;
  if (!(ci > 0.f && co > 0.f)) return {0.f, 0.f, 0.f};
  const V3 h = normalize(add(wi, wo));
  const float d = eval_ndf<kBeckmann>(p.au, p.av, h);
  const float g = smith_g1<kBeckmann>(p.au, p.av, wi, h) *
                  smith_g1<kBeckmann>(p.au, p.av, wo, h);
  const float cih = dot(wi, h);
  const float sd = safe_div(d * g, 4.f * ci);
  return {p.spec.x * fresnel_conductor(cih, p.eta.x, p.k.x) * sd,
          p.spec.y * fresnel_conductor(cih, p.eta.y, p.k.y) * sd,
          p.spec.z * fresnel_conductor(cih, p.eta.z, p.k.z) * sd};
}

template <bool kBeckmann>
__device__ float rough_pdf(const RoughLane& p, V3 wi, V3 wo) {
  if (!(wi.z > 0.f && wo.z > 0.f)) return 0.f;
  const V3 h = normalize(add(wi, wo));
  const float dv = pdf_micronormal<kBeckmann>(p.au, p.av, wi, h);
  return safe_div(dv, 4.f * fabsf(dot(wo, h)));
}

template <bool kBeckmann>
__device__ void rough_lane(const Rough& r, int64_t slot, int has_nee, V3 wi,
                           V3 wo_nee, float s0, float s1, Shade& o) {
  const int64_t sl = clamp_i(slot, 0, r.n - 1);
  RoughLane p;
  p.au = clamp_min(r.alpha_u[sl], 1e-4f);
  p.av = clamp_min(r.alpha_v[sl], 1e-4f);
  p.eta = load3(r.eta, sl);
  p.k = load3(r.k, sl);
  p.spec = load3(r.spec, sl);
  const V3 h = sample_micronormal<kBeckmann>(p.au, p.av, wi, s0, s1);
  const V3 wo = reflect_about(wi, h);
  const float pdf = rough_pdf<kBeckmann>(p, wi, wo);
  const V3 f = rough_eval<kBeckmann>(p, wi, wo);
  const bool ok = wi.z > 0.f && wo.z > 0.f && pdf > 0.f;
  o.wo = wo;
  o.pdf_s = ok ? pdf : 0.f;
  o.weight = ok ? V3{safe_div(f.x, pdf), safe_div(f.y, pdf), safe_div(f.z, pdf)}
                : V3{0.f, 0.f, 0.f};
  if (has_nee) {
    o.f_nee = rough_eval<kBeckmann>(p, wi, wo_nee);
    o.pdf_nee = rough_pdf<kBeckmann>(p, wi, wo_nee);
  }
}

// ---- models/tabulated.py ----

// _invert_cdf on a nondecreasing row of w floats at u, by K2's binary
// search: (count of values below u clipped to w - 1, lo, mass)
__device__ __forceinline__ int invert_row(const float* __restrict__ row, int w,
                                          float u, float& lo, float& mass) {
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
  lo = hi < u ? hi : (c > 0 ? __ldg(row + c - 1) : 0.f);
  lo = fminf(lo, hi);
  mass = hi - lo;
  return c;
}

__device__ __forceinline__ float row_mass_at(const float* __restrict__ row, int64_t r) {
  const float hi = __ldg(row + r);
  return hi - (r > 0 ? __ldg(row + r - 1) : 0.f);
}

// _square_cells: the half vector's cell (r, c) and the Jacobian's denom
__device__ void square_cells(V3 wi_c, V3 wo_c, int res_h, int res_phi, int64_t& r,
                             int64_t& c, float& denom) {
  const V3 h = normalize(add(wi_c, wo_c));
  const float theta_h = acosf(clamp(h.z, -1.f, 1.f));
  const float phi_h = atan2f(h.y, h.x);
  const float y = safe_sqrt(div_scalar(theta_h, kHalfPi));
  const float x = clamp(div_scalar(phi_h + kPi, kTwoPi), 0.f, kOneMinus);
  r = clamp_i((int64_t)(y * (float)res_h), 0, res_h - 1);
  c = clamp_i((int64_t)(x * (float)res_phi), 0, res_phi - 1);
  const float th = kHalfPi * y * y;
  const float jac = kTwoPiSq * y * sinf(th);
  denom = jac * 4.f * fabsf(dot(wo_c, h));
}

__device__ __forceinline__ V3 canonical_wi(float theta_i) {
  const float st = sinf(theta_i);
  return {st * 1.f, st * 0.f, cosf(theta_i)};  // sph_to_dir(theta_i, 0)
}

__device__ void tab_pre(const PreArgs& a, int64_t lane, int64_t slot, V3 wi,
                        V3 wo_nee, float s0, float s1, bool has_s1) {
  const int64_t n = a.n;
  const bool cos_wi_ok = wi.z > 0.f;
  const bool any_mask = cos_wi_ok;  // the lane is in the tabulated mask
  const bool mask_nee = a.has_nee && (a.nee_mask == nullptr || a.nee_mask[lane]);
  const float theta_i = acosf(clamp(wi.z, -1.f, 1.f));
  const float phi_i = atan2f(wi.y, wi.x);
  const V3 wi_c = canonical_wi(theta_i);
  const int64_t tbin =
      any_mask ? clamp_i((int64_t)(div_scalar(theta_i, kHalfPi) * (float)a.n_theta_i), 0,
                         a.n_theta_i - 1)
               : 0;
  const int64_t slot_safe = any_mask ? clamp_i(slot, 0, a.n_tab - 1) : 0;

  // mixture branch
  bool use_cos;
  float u_row;
  if (has_s1) {
    use_cos = s1 < kCosMix;
    u_row = s0;
  } else {
    use_cos = s0 < kCosMix;
    const float u0r = use_cos ? div_scalar(s0, kCosMix) : div_scalar(s0 - kCosMix, kTabMix);
    u_row = clamp(u0r, 0.f, kOneMinus);
  }

  // marginal row
  const float* row = a.cdf_row + (slot_safe * a.n_theta_i + tbin) * a.res_h;
  float row_lo, row_mass_own;
  const int64_t r_own = invert_row(row, a.res_h, u_row, row_lo, row_mass_own);
  const float dy =
      clamp((u_row - row_lo) / clamp_min(row_mass_own, 1e-20f), 0.f, kOneMinus);

  // NEE and cosine-branch cells (canonical frame)
  const bool nee_ok = wo_nee.z > 0.f && mask_nee;
  const V3 wo_nee_c = nee_ok ? rotate_phi(wo_nee, -phi_i) : wi_c;
  int64_t r_nee, c_nee, r_cos, c_cos;
  float denom_nee, denom_cos;
  square_cells(wi_c, wo_nee_c, a.res_h, a.res_phi, r_nee, c_nee, denom_nee);
  const V3 wo_cos = cosine_hemisphere(u_row, a.sample2[2 * lane + 1]);
  square_cells(wi_c, wo_cos, a.res_h, a.res_phi, r_cos, c_cos, denom_cos);

  int64_t* idx = a.idx;
  idx[lane] = slot_safe * a.n_theta_i + tbin;
  idx[n + lane] = r_own;
  idx[2 * n + lane] = r_nee;
  idx[3 * n + lane] = c_nee;
  idx[4 * n + lane] = r_cos;
  idx[5 * n + lane] = c_cos;
  idx[6 * n + lane] = slot_safe;
  a.valid[lane] = any_mask;
  a.flags[lane] = kTab | (cos_wi_ok ? kCosWiOk : 0) | (use_cos ? kUseCos : 0) |
                  (nee_ok ? kNeeOk : 0);
  float* st = a.state;
  st[kThetaI * n + lane] = theta_i;
  st[kPhiI * n + lane] = phi_i;
  st[kDy * n + lane] = dy;
  st[kRowMassOwn * n + lane] = row_mass_own;
  st[kRowMassCos * n + lane] = row_mass_at(row, r_cos);
  st[kDenomCos * n + lane] = denom_cos;
  st[kRowMassNee * n + lane] = row_mass_at(row, r_nee);
  st[kDenomNee * n + lane] = denom_nee;
  st[kPCosNee * n + lane] = cosine_hemisphere_pdf(wo_nee_c);
  a.masks[lane] = nee_ok && cos_wi_ok;
  a.scales[lane] = clamp_min(wo_nee.z, 0.f);
}

__global__ void __launch_bounds__(kThreads) bsdf_shade_pre_kernel(const PreArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  const int64_t n = a.n;
  Shade o;
  bool tab = false;
  if (a.active == nullptr || a.active[lane]) {
    int64_t mid = a.mat_id[lane];
    if (mid < 0) mid += a.n_mat;
    if (mid >= 0 && mid < a.n_mat) {
      const int64_t t = a.mat_type[mid], slot = a.mat_slot[mid];
      if (t == a.kid_diffuse || t == a.kid_ggx || t == a.kid_beckmann || t == a.kid_tab) {
        const V3 wi = load3(a.wi, lane), wo_nee = load3(a.wo_nee, lane);
        const float s0 = a.sample2[2 * lane], s1 = a.sample2[2 * lane + 1];
        if (t == a.kid_diffuse) {
          diffuse_lane(a, slot, wi, wo_nee, s0, s1, o);
        } else if (t == a.kid_ggx) {
          rough_lane<false>(a.ggx, slot, a.has_nee, wi, wo_nee, s0, s1, o);
        } else if (t == a.kid_beckmann) {
          rough_lane<true>(a.beckmann, slot, a.has_nee, wi, wo_nee, s0, s1, o);
        } else {
          const bool has_s1 = a.sample1 != nullptr;
          tab_pre(a, lane, slot, wi, wo_nee, s0, has_s1 ? a.sample1[lane] : 0.f, has_s1);
          tab = true;
        }
      }
    }
  }
  float* out = a.out;
  store3(out, lane, o.f_nee);
  out[3 * n + lane] = o.pdf_nee;
  store3(out + 4 * n, lane, o.wo);
  out[7 * n + lane] = o.pdf_s;
  store3(out + 8 * n, lane, o.weight);
  a.is_delta[lane] = 0;
  if (a.kid_tab >= 0 && !tab) {
    a.valid[lane] = 0;
    a.flags[lane] = 0;
    a.masks[lane] = 0;
    a.masks[n + lane] = 0;
    a.scales[lane] = 0.f;
    a.scales[n + lane] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) bsdf_shade_post_kernel(const PostArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  const uint8_t f = a.flags[lane];
  if (!(f & kTab)) return;
  const int64_t n = a.n;
  const float* st = a.state;
  const float theta_i = st[kThetaI * n + lane], phi_i = st[kPhiI * n + lane];
  const V3 wi_c = canonical_wi(theta_i);
  const float x = a.x[lane], mass_own = a.mass_own[lane];
  const float mass_nee = a.mass_nee[lane], mass_cos = a.mass_cos[lane];
  const float hw = (float)(a.res_h * a.res_phi);

  // the sampled half vector (_halfvec_from_square) and direction
  const float y = div_scalar((float)a.r_own[lane] + st[kDy * n + lane], (float)a.res_h);
  const float theta_h = kHalfPi * y * y;
  const float phi_h = kTwoPi * x - kPi;
  const float sth = sinf(theta_h);
  const V3 h = {sth * cosf(phi_h), sth * sinf(phi_h), cosf(theta_h)};
  const float jac = kTwoPiSq * y * sinf(theta_h);
  const V3 wo_tab = reflect_about(wi_c, h);
  const float denom_own = jac * 4.f * fabsf(dot(wo_tab, h));
  V3 wo_c;
  float p_tab;
  if (f & kUseCos) {
    const float s0 = a.sample2[2 * lane], s1 = a.sample2[2 * lane + 1];
    const float u_row = a.remap ? clamp(div_scalar(s0, kCosMix), 0.f, kOneMinus) : s0;
    wo_c = cosine_hemisphere(u_row, s1);
    p_tab = safe_div(st[kRowMassCos * n + lane] * mass_cos * hw, st[kDenomCos * n + lane]);
  } else {
    wo_c = wo_tab;
    p_tab = safe_div(st[kRowMassOwn * n + lane] * mass_own * hw, denom_own);
  }
  const V3 wo = rotate_phi(wo_c, phi_i);
  const float pdf_s = kTabMix * p_tab + kCosMix * cosine_hemisphere_pdf(wo_c);
  const bool valid_s = pdf_s > 1e-12f && wo_c.z > 0.f && (f & kCosWiOk);
  const float p_tab_nee =
      safe_div(st[kRowMassNee * n + lane] * mass_nee * hw, st[kDenomNee * n + lane]);
  const bool nee = (f & kNeeOk) && (f & kCosWiOk);
  store3(a.wo, lane, wo);
  a.pdf_s[lane] = valid_s ? pdf_s : 0.f;
  a.pdf_nee[lane] = nee ? kTabMix * p_tab_nee + kCosMix * st[kPCosNee * n + lane] : 0.f;
  a.mask_b[lane] = valid_s;
  a.s_s[lane] = valid_s ? clamp_min(wo.z, 0.f) / pdf_s : 0.f;
}

}  // namespace

extern "C" int mct_bsdf_shade_pre(const bsdf_shade::PreArgs* args, cudaStream_t stream) {
  if (args->n > 0) {
    const unsigned blocks = (unsigned)((args->n + kThreads - 1) / kThreads);
    bsdf_shade_pre_kernel<<<blocks, kThreads, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int mct_bsdf_shade_post(const bsdf_shade::PostArgs* args, cudaStream_t stream) {
  if (args->n > 0) {
    const unsigned blocks = (unsigned)((args->n + kThreads - 1) / kThreads);
    bsdf_shade_post_kernel<<<blocks, kThreads, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
