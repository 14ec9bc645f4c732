// B1 (bvh_closest) and B2 (bvh_any): closest hit and any hit over the
// skip-link BVH that render/bvh.py builds, one CUDA thread per ray.
//
// Replaces the JAX package's mitsuba_customization_tpu/render/bvh.py
// `intersect` (:238) and `occluded` (:290). Those are not Pallas kernels
// but an XLA while_loop in lock-step: every ray carries one node cursor
// and the loop runs until the slowest ray of the wavefront is done. On
// the card each thread walks its own ray: from node 0 it tests the node's
// box; on a miss it jumps to the node's skip link, on a hit it steps to
// the next node in depth-first order (the first child) or, at a leaf,
// tests the leaf's prims slot after slot and then jumps to the skip link;
// it stops when the cursor passes the last node. B2 stops at its first
// hit below maxt. No stack, no shared memory.
//
// Numerics follow the plain walk in render/bvh.py (the prim tests of
// geometry._intersect_prims in its gathered form, geometry.ray_triangle /
// ray_sphere / ray_cylinder with rn=True): every product and sum is
// rounded on its own (cluster_common.cuh's mul / add / sub / dot3), the
// dot products sum x, y, z in that order, divisions and square roots
// round to nearest, and the epsilons are geometry.py's. A thread then
// walks the same nodes and tests the same prims as its lane of the
// lock-step walk, and its t, prim, u, v are the plain version's bit for
// bit. A lane with maxt <= 0 (or NaN) returns a miss at once: no prim
// test passes below such a maxt, so the plain walk's result is the same.
//
// What bounds it on the H100: the walk's latency. A ray reads 28 bytes
// and writes 16 (B2: 1), but visits tens to thousands of nodes one after
// another, each a dependent chain of loads (box, then leaf slots, then
// the skip link) from a tree of ~0.63 nodes a prim (44 bytes a node,
// ~42 MB at 1.5M prims, near the 50 MB L2). This first version loads a
// node's 6 bounds, its 4 slots (one int4) and its skip link through
// __ldg and keeps nothing in shared memory; node packing, warp voting and
// ray sorting are left to a later redesign.
#include "cluster_common.cuh"

namespace {

using mct_cluster::add;
using mct_cluster::dot3;
using mct_cluster::load_ray;
using mct_cluster::mul;
using mct_cluster::Ray;
using mct_cluster::sub;

constexpr int kThreadsBvh = 128;
constexpr int kLeafSize = 4;    // render/bvh.LEAF_SIZE
constexpr float kEps = 1e-7f;   // geometry._EPS
constexpr int64_t kTri = 0, kCylinder = 2;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// The JAX `_slab_test`: the box is entered (near <= far), not behind the
// origin (far > 0) and nearer than the best hit so far (near < t_best).
__device__ __forceinline__ bool slab(const float* __restrict__ bb_min,
                                     const float* __restrict__ bb_max,
                                     int node, const Ray& r, float t_best) {
  const float* lo = bb_min + 3 * (int64_t)node;
  const float* hi = bb_max + 3 * (int64_t)node;
  const float lx = mul(sub(__ldg(lo), r.ox), r.ix);
  const float ly = mul(sub(__ldg(lo + 1), r.oy), r.iy);
  const float lz = mul(sub(__ldg(lo + 2), r.oz), r.iz);
  const float hx = mul(sub(__ldg(hi), r.ox), r.ix);
  const float hy = mul(sub(__ldg(hi + 1), r.oy), r.iy);
  const float hz = mul(sub(__ldg(hi + 2), r.oz), r.iz);
  const float near = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float far = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  return near <= far && far > 0.f && near < t_best;
}

struct Prim {
  float p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ Prim load_prim(const float* __restrict__ p0,
                                          const float* __restrict__ e1,
                                          const float* __restrict__ e2,
                                          int pid) {
  const int64_t i = 3 * (int64_t)pid;
  return Prim{__ldg(p0 + i), __ldg(p0 + i + 1), __ldg(p0 + i + 2),
              __ldg(e1 + i), __ldg(e1 + i + 1), __ldg(e1 + i + 2),
              __ldg(e2 + i), __ldg(e2 + i + 1), __ldg(e2 + i + 2)};
}

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
__device__ __forceinline__ float prim_test(const int64_t* __restrict__ prim_type,
                                           const float* __restrict__ p0,
                                           const float* __restrict__ e1,
                                           const float* __restrict__ e2,
                                           bool cylinders, int pid,
                                           const Ray& r, float& u, float& v) {
  const int64_t type = __ldg(prim_type + pid);
  const Prim p = load_prim(p0, e1, e2, pid);
  u = 0.f;
  v = 0.f;
  if (type == kTri) return tri(p, r, u, v);
  if (cylinders && type == kCylinder) return cylinder(p, r);
  return sphere(p, r);
}

struct Tree {
  const float* bb_min;
  const float* bb_max;
  const int32_t* skip;
  const int4* leaf;   // (n_nodes, 4) i32 slots, one int4 a node
  int n_nodes;
  const int64_t* prim_type;
  const float* p0;
  const float* e1;
  const float* e2;
  bool cylinders;
};

// The skip-link walk of one ray. kAny: stop at the first prim hit below
// maxt (B2), else keep the nearest (B1: the first slot in walk order
// among equal t). Returns the hit prim, -1 for none.
template <bool kAny>
__device__ __forceinline__ int walk(const Tree& tr, const Ray& r, float mt,
                                   float& t_best, float& u_best,
                                   float& v_best) {
  int best = -1;
  int node = 0;
  while (node < tr.n_nodes) {
    if (!slab(tr.bb_min, tr.bb_max, node, r, t_best)) {
      node = __ldg(tr.skip + node);
      continue;
    }
    const int4 slots = __ldg(tr.leaf + node);
    if (slots.x < 0) {  // internal: its first child follows
      ++node;
      continue;
    }
    const int ids[kLeafSize] = {slots.x, slots.y, slots.z, slots.w};
#pragma unroll
    for (int i = 0; i < kLeafSize; ++i) {
      if (ids[i] < 0) continue;
      float u, v;
      const float t = prim_test(tr.prim_type, tr.p0, tr.e1, tr.e2, tr.cylinders,
                                ids[i], r, u, v);
      if (t < t_best && t < mt) {
        best = ids[i];
        if (kAny) return best;
        t_best = t;
        u_best = u;
        v_best = v;
      }
    }
    node = __ldg(tr.skip + node);
  }
  return best;
}

__global__ void __launch_bounds__(kThreadsBvh)
    bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ maxt, int64_t n, Tree tr,
                       float* __restrict__ out_t, float* __restrict__ out_u,
                       float* __restrict__ out_v, int32_t* __restrict__ out_prim) {
  const int64_t lane = (int64_t)blockIdx.x * kThreadsBvh + threadIdx.x;
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

__global__ void __launch_bounds__(kThreadsBvh)
    bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int64_t n, Tree tr,
                   uint8_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * kThreadsBvh + threadIdx.x;
  if (lane >= n) return;
  const float mt = maxt[lane];
  bool hit = false;
  if (mt > 0.f) {
    float t = mt, u, v;
    hit = walk<true>(tr, load_ray(o, d, lane), mt, t, u, v) >= 0;
  }
  out[lane] = hit ? 1 : 0;
}

Tree make_tree(const float* bb_min, const float* bb_max, const int32_t* skip,
               const int32_t* leaf, int n_nodes, const int64_t* prim_type,
               const float* p0, const float* e1, const float* e2, int cylinders) {
  return Tree{bb_min, bb_max, skip, reinterpret_cast<const int4*>(leaf), n_nodes,
              prim_type, p0, e1, e2, cylinders != 0};
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreadsBvh - 1) / kThreadsBvh);
}

}  // namespace

// o, d: (n, 3) f32; maxt: (n,) f32; bb_min, bb_max: (n_nodes, 3) f32;
// skip: (n_nodes,) i32; leaf: (n_nodes, 4) i32 (16-byte aligned rows);
// prim_type: (P,) i64; p0, e1, e2: (P, 3) f32; cylinders: 0 when the soup
// holds none. out_t, out_u, out_v: (n,) f32; out_prim: (n,) i32, -1 on a
// miss (t = +inf, u = v = 0).
extern "C" int mct_bvh_closest(const float* o, const float* d, const float* maxt,
                               int64_t n, const float* bb_min, const float* bb_max,
                               const int32_t* skip, const int32_t* leaf,
                               int n_nodes, const int64_t* prim_type,
                               const float* p0, const float* e1, const float* e2,
                               int cylinders, float* out_t, float* out_u,
                               float* out_v, int32_t* out_prim,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  bvh_closest_kernel<<<blocks_for(n), kThreadsBvh, 0, stream>>>(
      o, d, maxt, n,
      make_tree(bb_min, bb_max, skip, leaf, n_nodes, prim_type, p0, e1, e2, cylinders),
      out_t, out_u, out_v, out_prim);
  return (int)cudaGetLastError();
}

// As mct_bvh_closest; out: (n,) u8, 1 = a prim hit below maxt.
extern "C" int mct_bvh_any(const float* o, const float* d, const float* maxt,
                           int64_t n, const float* bb_min, const float* bb_max,
                           const int32_t* skip, const int32_t* leaf, int n_nodes,
                           const int64_t* prim_type, const float* p0,
                           const float* e1, const float* e2, int cylinders,
                           uint8_t* out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  bvh_any_kernel<<<blocks_for(n), kThreadsBvh, 0, stream>>>(
      o, d, maxt, n,
      make_tree(bb_min, bb_max, skip, leaf, n_nodes, prim_type, p0, e1, e2, cylinders),
      out);
  return (int)cudaGetLastError();
}
