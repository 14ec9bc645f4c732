// B1 (bvh_closest) and B2 (bvh_any): closest hit and any hit over the
// skip-link BVH that render/bvh.py builds, on the packed storage that
// render/bvh.pack_nodes / pack_prims make of it, one CUDA thread a ray.
//
// Replaces the JAX package's mitsuba_customization_tpu/render/bvh.py
// `intersect` (:238) and `occluded` (:290). Those are not Pallas kernels
// but an XLA while_loop in lock-step: every ray carries one node cursor
// and the loop runs until the slowest ray of the wavefront is done.
//
// B1 walks each ray in the lock-step walk's own order, the pre-order
// skip-link walk: it tests a node's box; on a miss it jumps to the node's
// skip link, on a hit it steps to the node's first child or, at a leaf,
// tests the leaf's prims slot after slot and then jumps to the skip link.
// It then tests the same prims against the same best t as the plain walk,
// and the first slot in walk order wins a tie. B2 answers whether some
// prim of an entered leaf lies below maxt; every box is tested against
// maxt, so the leaves entered do not depend on the order of the visits:
// it visits the nearer entered child first, the other on a short stack
// (trees deeper than kStack take the skip-link walk), and stops at its
// first hit.
//
// Numerics follow the plain walk in render/bvh.py (the prim tests of
// geometry._intersect_prims in its gathered form, geometry.ray_triangle /
// ray_sphere / ray_cylinder with rn=True): every product and sum is
// rounded on its own (cluster_common.cuh's mul / add / sub / dot3), the
// dot products sum x, y, z in that order, divisions and square roots
// round to nearest, and the epsilons are geometry.py's. B1's t, prim, u,
// v are then the plain version's bit for bit, and B2's answer is. A lane
// with maxt <= 0 (or NaN) returns a miss at once: no prim test passes
// below such a maxt, so the plain walk's result is the same.
//
// What bounds it on the H100: the walk's loads. A ray reads 28 bytes and
// writes 16 (B2: 1), but visits tens to hundreds of nodes one after
// another, each a load the next step waits on, from lanes of a warp that
// soon sit at different nodes. The storage cuts the loads and the cache
// sectors a visit touches (the parent layout read four arrays a node and
// four a prim):
//   - one 32-byte record a node, bb_min.xyz + `first` (the first child's
//     slot, or for a leaf ~(start << 3 | count) into the prim records) and
//     bb_max.xyz + the skip link's slot (-1 past the last node): two
//     16-byte loads from one sector; a node's two children side by side,
//     so B2 loads both boxes at once;
//   - one 48-byte record a prim, p0 + type, e1 + the prim's id, e2, in
//     walk order: a leaf's prims side by side.
// A plain grid of 128-thread blocks keeps about 40 warps on a SM. Tried
// on the H100 and dropped (PERF.md §6): the tree's top in shared
// memory with persistent blocks that fetch rays a warp at a time, the
// while-while walk, a register cap for more warps, loading both
// successors or both children ahead, and 64-byte aligned pairs.
#include "cluster_common.cuh"

namespace {

using mct_cluster::add;
using mct_cluster::dot3;
using mct_cluster::load_ray;
using mct_cluster::mul;
using mct_cluster::Ray;
using mct_cluster::sub;

constexpr int kThreads = 128;
constexpr int kStack = 64;     // B2 near child first: the deepest tree it takes
constexpr float kEps = 1e-7f;  // geometry._EPS
constexpr int kTri = 0, kCylinder = 2;
constexpr int kEnd = -1;       // the skip link past the last node

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// The JAX `_slab_test`: the box is entered (near <= far), not behind the
// origin (far > 0) and nearer than the best hit so far (near < t_best).
__device__ __forceinline__ bool slab(const float4& lo, const float4& hi, const Ray& r,
                                     float t_best, float& near) {
  const float lx = mul(sub(lo.x, r.ox), r.ix);
  const float ly = mul(sub(lo.y, r.oy), r.iy);
  const float lz = mul(sub(lo.z, r.oz), r.iz);
  const float hx = mul(sub(hi.x, r.ox), r.ix);
  const float hy = mul(sub(hi.y, r.oy), r.iy);
  const float hz = mul(sub(hi.z, r.oz), r.iz);
  near = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float far = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  return near <= far && far > 0.f && near < t_best;
}

struct Prim {
  float p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// geometry.ray_triangle (Moller-Trumbore); +inf on a miss. It returns as
// soon as det, u or v rules the triangle out, which gives the same t as
// testing every condition at the end (u > 1 with v >= 0 fails u + v <= 1,
// rounding being monotone).
__device__ __forceinline__ float tri(const Prim& p, const Ray& r, float& u,
                                     float& v) {
  const float px = sub(mul(r.dy, p.e2z), mul(r.dz, p.e2y));
  const float py = sub(mul(r.dz, p.e2x), mul(r.dx, p.e2z));
  const float pz = sub(mul(r.dx, p.e2y), mul(r.dy, p.e2x));
  const float det = dot3(p.e1x, p.e1y, p.e1z, px, py, pz);
  if (!(fabsf(det) > kEps)) return inf();
  const float inv_det = __fdiv_rn(1.f, det);
  const float tx = sub(r.ox, p.p0x), ty = sub(r.oy, p.p0y), tz = sub(r.oz, p.p0z);
  u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  if (!(u >= 0.f && u <= 1.f)) return inf();
  const float qx = sub(mul(ty, p.e1z), mul(tz, p.e1y));
  const float qy = sub(mul(tz, p.e1x), mul(tx, p.e1z));
  const float qz = sub(mul(tx, p.e1y), mul(ty, p.e1x));
  v = mul(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv_det);
  if (!(v >= 0.f && add(u, v) <= 1.f)) return inf();
  const float t = mul(dot3(p.e2x, p.e2y, p.e2z, qx, qy, qz), inv_det);
  return t > 0.f ? t : inf();
}

// geometry.ray_sphere: p0 = centre, e1.x = radius.
__device__ __forceinline__ float sphere(const Prim& p, const Ray& r) {
  const float tx = sub(r.ox, p.p0x), ty = sub(r.oy, p.p0y), tz = sub(r.oz, p.p0z);
  const float b = dot3(tx, ty, tz, r.dx, r.dy, r.dz);
  const float c = sub(dot3(tx, ty, tz, tx, ty, tz), mul(p.e1x, p.e1x));
  const float disc = sub(mul(b, b), c);
  const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
  const float t0 = sub(-b, sq), t1 = add(-b, sq);
  const float t = t0 > kEps ? t0 : t1;
  return (disc >= 0.f && t > kEps) ? t : inf();
}

// geometry.ray_cylinder: p0 = base, e1 = axis (length = height), e2.x =
// radius; the lateral surface only.
__device__ __forceinline__ float cylinder(const Prim& p, const Ray& r) {
  const float length =
      fmaxf(__fsqrt_rn(dot3(p.e1x, p.e1y, p.e1z, p.e1x, p.e1y, p.e1z)), 1e-12f);
  const float ax = __fdiv_rn(p.e1x, length), ay = __fdiv_rn(p.e1y, length),
              az = __fdiv_rn(p.e1z, length);
  const float tx = sub(r.ox, p.p0x), ty = sub(r.oy, p.p0y), tz = sub(r.oz, p.p0z);
  const float d_par = dot3(r.dx, r.dy, r.dz, ax, ay, az);
  const float oc_par = dot3(tx, ty, tz, ax, ay, az);
  const float ddx = sub(r.dx, mul(d_par, ax)), ddy = sub(r.dy, mul(d_par, ay)),
              ddz = sub(r.dz, mul(d_par, az));
  const float oox = sub(tx, mul(oc_par, ax)), ooy = sub(ty, mul(oc_par, ay)),
              ooz = sub(tz, mul(oc_par, az));
  const float qa = dot3(ddx, ddy, ddz, ddx, ddy, ddz);
  const float qb = dot3(ddx, ddy, ddz, oox, ooy, ooz);
  const float qc = sub(dot3(oox, ooy, ooz, oox, ooy, ooz), mul(p.e2x, p.e2x));
  const float disc = sub(mul(qb, qb), mul(qa, qc));
  const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
  const float inv_a = qa == 0.f ? 0.f : __fdiv_rn(1.f, qa);
  const float t0 = mul(sub(-qb, sq), inv_a), t1 = mul(add(-qb, sq), inv_a);
  const float s0 = add(oc_par, mul(t0, d_par)), s1 = add(oc_par, mul(t1, d_par));
  const bool ok0 = t0 > kEps && s0 >= 0.f && s0 <= length;
  const bool ok1 = t1 > kEps && s1 >= 0.f && s1 <= length;
  const float t = ok0 ? t0 : (ok1 ? t1 : inf());
  return (disc >= 0.f && qa > 1e-12f && (ok0 || ok1)) ? t : inf();
}

// geometry._intersect_prims for one prim: t (+inf on a miss), with u, v
// set for triangles and 0 otherwise. Without cylinders (a host fact)
// every non-triangle is a sphere, as in the plain version.
__device__ __forceinline__ float prim_test(const Prim& p, int type, bool cylinders,
                                           const Ray& r, float& u, float& v) {
  u = 0.f;
  v = 0.f;
  if (type == kTri) return tri(p, r, u, v);
  if (cylinders && type == kCylinder) return cylinder(p, r);
  return sphere(p, r);
}

struct Tree {
  const float4* nodes;  // two a node (pack_nodes)
  const float4* prims;  // three a prim, in walk order (pack_prims)
  int n_nodes;
  bool cylinders;
};

__device__ __forceinline__ void fetch(const Tree& tr, int i, float4& lo, float4& hi) {
  const float4* p = tr.nodes + 2 * (int64_t)i;
  lo = __ldg(p);
  hi = __ldg(p + 1);
}

// The prims of the leaf with code ~(start << 3 | count), slot after slot
// against the best so far (B1: the first slot in walk order among equal
// t). kAny: true at the first prim hit below maxt.
template <bool kAny>
__device__ __forceinline__ bool leaf(const Tree& tr, int code, const Ray& r, float mt,
                                     float& t_best, float& u_best, float& v_best,
                                     int& best) {
  const int start = (~code) >> 3, count = (~code) & 7;
  for (int i = 0; i < count; ++i) {
    const float4* q = tr.prims + 3 * (int64_t)(start + i);
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const Prim p{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
    float u, v;
    const float t = prim_test(p, __float_as_int(a.w), tr.cylinders, r, u, v);
    if (t < t_best && t < mt) {
      best = __float_as_int(b.w);
      if (kAny) return true;
      t_best = t;
      u_best = u;
      v_best = v;
    }
  }
  return false;
}

// The skip-link walk of one ray. Returns the hit prim, -1 for none.
template <bool kAny>
__device__ __forceinline__ int walk(const Tree& tr, const Ray& r, float mt, float& t_best,
                                    float& u_best, float& v_best) {
  int best = -1;
  int node = tr.n_nodes > 0 ? 0 : kEnd;
  while (node != kEnd) {
    float4 lo, hi;
    fetch(tr, node, lo, hi);
    const int first = __float_as_int(lo.w), skip = __float_as_int(hi.w);
    float near;
    if (!slab(lo, hi, r, t_best, near)) {
      node = skip;
      continue;
    }
    if (first >= 0) {  // internal: its first child
      node = first;
      continue;
    }
    if (leaf<kAny>(tr, first, r, mt, t_best, u_best, v_best, best)) return best;
    node = skip;
  }
  return best;
}

// B2 near child first: an entered node's two children load together (they
// sit side by side); of two entered children the nearer goes first and
// the other's code (its first child's slot or its leaf code) waits on the
// stack.
__device__ __forceinline__ bool any_near_first(const Tree& tr, const Ray& r, float mt) {
  if (tr.n_nodes == 0) return false;
  int stack[kStack];
  int sp = 0;
  float4 lo, hi;
  fetch(tr, 0, lo, hi);
  float near_l, near_r;
  if (!slab(lo, hi, r, mt, near_l)) return false;
  int code = __float_as_int(lo.w);
  float t_best = mt, u, v;
  int best = -1;
  for (;;) {
    if (code < 0) {
      if (leaf<true>(tr, code, r, mt, t_best, u, v, best)) return true;
      if (sp == 0) return false;
      code = stack[--sp];
      continue;
    }
    float4 l0, l1, r0, r1;
    fetch(tr, code, l0, l1);
    fetch(tr, code + 1, r0, r1);
    const bool hl = slab(l0, l1, r, mt, near_l), hr = slab(r0, r1, r, mt, near_r);
    if (hl && hr) {
      const bool left = near_l <= near_r;
      stack[sp++] = __float_as_int(left ? r0.w : l0.w);
      code = __float_as_int(left ? l0.w : r0.w);
    } else if (hl || hr) {
      code = __float_as_int(hl ? l0.w : r0.w);
    } else {
      if (sp == 0) return false;
      code = stack[--sp];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ maxt, int64_t n, Tree tr,
                       float* __restrict__ out_t, float* __restrict__ out_u,
                       float* __restrict__ out_v, int32_t* __restrict__ out_prim) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float mt = maxt[lane];
  float t = mt, u = 0.f, v = 0.f;
  int prim = -1;
  if (mt > 0.f) prim = walk<false>(tr, load_ray(o, d, lane), mt, t, u, v);
  out_t[lane] = prim < 0 ? inf() : t;
  out_u[lane] = u;
  out_v[lane] = v;
  out_prim[lane] = prim;
}

__global__ void __launch_bounds__(kThreads)
    bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int64_t n, Tree tr, int near_first,
                   uint8_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float mt = maxt[lane];
  bool hit = false;
  if (mt > 0.f) {
    const Ray r = load_ray(o, d, lane);
    if (near_first) {
      hit = any_near_first(tr, r, mt);
    } else {
      float t = mt, u, v;
      hit = walk<true>(tr, r, mt, t, u, v) >= 0;
    }
  }
  out[lane] = hit ? 1 : 0;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

Tree make_tree(const void* nodes, int n_nodes, const void* prims, int cylinders) {
  return Tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(prims),
              n_nodes, cylinders != 0};
}

}  // namespace

// o, d: (n, 3) f32; maxt: (n,) f32; nodes: (n_nodes, 8) i32 records
// (render/bvh.pack_nodes), prims: (P, 12) i32 records (pack_prims), both
// 16-byte aligned; cylinders: 0 when the soup holds none. out_t, out_u,
// out_v: (n,) f32; out_prim: (n,) i32, -1 on a miss (t = +inf, u = v = 0).
extern "C" int mct_bvh_closest(const float* o, const float* d, const float* maxt, int64_t n,
                               const void* nodes, int n_nodes, const void* prims,
                               int cylinders, float* out_t, float* out_u, float* out_v,
                               int32_t* out_prim, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  bvh_closest_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      o, d, maxt, n, make_tree(nodes, n_nodes, prims, cylinders), out_t, out_u, out_v,
      out_prim);
  return (int)cudaGetLastError();
}

// As mct_bvh_closest; depth: the tree's depth (NodePack.depth), at most
// kStack for B2 to visit near children first; out: (n,) u8, 1 = a prim
// hit below maxt.
extern "C" int mct_bvh_any(const float* o, const float* d, const float* maxt, int64_t n,
                           const void* nodes, int n_nodes, const void* prims, int cylinders,
                           int depth, uint8_t* out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  bvh_any_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      o, d, maxt, n, make_tree(nodes, n_nodes, prims, cylinders), depth <= kStack, out);
  return (int)cudaGetLastError();
}
