// Shared device code of K3 (cluster_closest.cu) and K4 (cluster_shadow.cu):
// the ray setup, the box test and the slot tests of the two-level cluster
// structure built by ops/clusters.py.
//
// Layout (see ops/clusters.ClusterSet): boxes are rows of 8 floats
// [min xyz, max xyz, pad, pad]; a cluster's slab is kL slot rows of
// kFields floats, slot-major, so a slot's type, p0, e1 and e2 are its
// first 10 floats (loaded as two float4 and one float2).
//
// Numerics follow the TPU kernels of mitsuba_customization_tpu/ops/
// clusters.py (`_box_entry`, `_tri_test`, `_sphere_test`, `_cyl_test`)
// and the plain PyTorch versions beside the wrappers: every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), because
// nvcc would otherwise contract a*b + c into one FMA, which the plain
// version (one PyTorch op per step) never does. Divisions and square
// roots are IEEE round-to-nearest as well.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mct_cluster {

constexpr int kL = 32;        // slots per cluster
constexpr int kGroup = 16;    // clusters per supercluster
constexpr int kFields = 32;   // floats per slot row
constexpr float kBig = 1e30f;
constexpr float kTri = 0.f, kSphere = 1.f, kCylinder = 2.f;
constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // origin, direction, 1/direction
};

__device__ __forceinline__ float inv_dir(float c) {
  return __fdiv_rn(1.f, fabsf(c) < 1e-12f ? 1e-12f : c);
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int64_t lane) {
  Ray r;
  r.ox = o[3 * lane];
  r.oy = o[3 * lane + 1];
  r.oz = o[3 * lane + 2];
  r.dx = d[3 * lane];
  r.dy = d[3 * lane + 1];
  r.dz = d[3 * lane + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// Slab test: entry <= exit, exit > 0 and entry < t_cap.
__device__ __forceinline__ bool box_pass(const float* box, const Ray& r,
                                         float t_cap) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box) + 1);
  const float lx = mul(sub(a.x, r.ox), r.ix), hx = mul(sub(a.w, r.ox), r.ix);
  const float ly = mul(sub(a.y, r.oy), r.iy), hy = mul(sub(b.x, r.oy), r.iy);
  const float lz = mul(sub(a.z, r.oz), r.iz), hz = mul(sub(b.y, r.oz), r.iz);
  const float near = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float far = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  return near <= far && far > 0.f && near < t_cap;
}

// The lane's starting cap: min(maxt, exit distance of the root box *
// 1.0001 + 1e-4, kBig). No primitive lies past the point where the ray
// leaves the union of all boxes, so the cap only prunes; a ray that misses
// the root box (exit <= 0) gets 0 and can hit nothing.
__device__ __forceinline__ float root_cap(const float* root, const Ray& r,
                                          float mt) {
  const float fx = fmaxf(mul(sub(root[0], r.ox), r.ix), mul(sub(root[3], r.ox), r.ix));
  const float fy = fmaxf(mul(sub(root[1], r.oy), r.iy), mul(sub(root[4], r.oy), r.iy));
  const float fz = fmaxf(mul(sub(root[2], r.oz), r.iz), mul(sub(root[5], r.oz), r.iz));
  const float far = fminf(fminf(fx, fy), fz);
  const float t_exit = far > 0.f ? add(mul(far, 1.0001f), 1e-4f) : 0.f;
  return fminf(fminf(mt, t_exit), kBig);
}

// Moller-Trumbore; t = kBig on a miss.
__device__ __forceinline__ float tri_test(const float4& a, const float4& b,
                                          const float2& c, const Ray& r,
                                          float& u, float& v) {
  const float p0x = a.y, p0y = a.z, p0z = a.w;
  const float e1x = b.x, e1y = b.y, e1z = b.z;
  const float e2x = b.w, e2y = c.x, e2z = c.y;
  const float px = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float py = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  const float inv_det = __fdiv_rn(1.f, fabsf(det) < 1e-12f ? 1e-12f : det);
  const float tx = sub(r.ox, p0x), ty = sub(r.oy, p0y), tz = sub(r.oz, p0z);
  u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  const float qx = sub(mul(ty, e1z), mul(tz, e1y));
  const float qy = sub(mul(tz, e1x), mul(tx, e1z));
  const float qz = sub(mul(tx, e1y), mul(ty, e1x));
  v = mul(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv_det);
  const float t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
  const bool ok = fabsf(det) > 1e-12f && u >= 0.f && v >= 0.f &&
                  add(u, v) <= 1.f && t > 0.f;
  return ok ? t : kBig;
}

// Sphere: p0 = centre, e1.x = radius.
__device__ __forceinline__ float sphere_test(const float4& a, const float4& b,
                                             const Ray& r) {
  const float tx = sub(r.ox, a.y), ty = sub(r.oy, a.z), tz = sub(r.oz, a.w);
  const float bb = dot3(tx, ty, tz, r.dx, r.dy, r.dz);
  const float cc = sub(dot3(tx, ty, tz, tx, ty, tz), mul(b.x, b.x));
  const float disc = sub(mul(bb, bb), cc);
  const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
  const float t0 = sub(-bb, sq), t1 = add(-bb, sq);
  const float t = t0 > 1e-7f ? t0 : t1;
  return (disc >= 0.f && t > 1e-7f) ? t : kBig;
}

// Open cylinder: p0 = base, e1 = axis (length = height), e2.x = radius.
__device__ __forceinline__ float cylinder_test(const float4& a, const float4& b,
                                               const Ray& r) {
  const float ax = b.x, ay = b.y, az = b.z, radius = b.w;
  const float length = __fsqrt_rn(fmaxf(dot3(ax, ay, az, ax, ay, az), 1e-24f));
  const float nx = __fdiv_rn(ax, length), ny = __fdiv_rn(ay, length),
              nz = __fdiv_rn(az, length);
  const float tx = sub(r.ox, a.y), ty = sub(r.oy, a.z), tz = sub(r.oz, a.w);
  const float d_par = dot3(r.dx, r.dy, r.dz, nx, ny, nz);
  const float oc_par = dot3(tx, ty, tz, nx, ny, nz);
  const float ddx = sub(r.dx, mul(d_par, nx)), ddy = sub(r.dy, mul(d_par, ny)),
              ddz = sub(r.dz, mul(d_par, nz));
  const float oox = sub(tx, mul(oc_par, nx)), ooy = sub(ty, mul(oc_par, ny)),
              ooz = sub(tz, mul(oc_par, nz));
  const float qa = dot3(ddx, ddy, ddz, ddx, ddy, ddz);
  const float qb = dot3(ddx, ddy, ddz, oox, ooy, ooz);
  const float qc = sub(dot3(oox, ooy, ooz, oox, ooy, ooz), mul(radius, radius));
  const float disc = sub(mul(qb, qb), mul(qa, qc));
  const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
  const float inv_a = __fdiv_rn(1.f, qa < 1e-12f ? 1e-12f : qa);
  const float t0 = mul(sub(-qb, sq), inv_a), t1 = mul(add(-qb, sq), inv_a);
  const float s0 = add(oc_par, mul(t0, d_par)), s1 = add(oc_par, mul(t1, d_par));
  const bool ok0 = t0 > 1e-7f && s0 >= 0.f && s0 <= length;
  const bool ok1 = t1 > 1e-7f && s1 >= 0.f && s1 <= length;
  const float t = ok0 ? t0 : (ok1 ? t1 : kBig);
  return (disc >= 0.f && qa > 1e-12f && (ok0 || ok1)) ? t : kBig;
}

// One slot row against a ray: t (kBig on a miss or an empty slot), with
// u, v set for triangles and 0 otherwise. kTriOnly: the cluster holds
// triangles only (cl_meta == 0), so the other tests are not compiled in.
template <bool kTriOnly>
__device__ __forceinline__ float slot_test(const float* row, const Ray& r,
                                           float& u, float& v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float2 c = __ldg(reinterpret_cast<const float2*>(row + 8));
  u = 0.f;
  v = 0.f;
  if (a.x == kTri) return tri_test(a, b, c, r, u, v);
  if (kTriOnly) return kBig;
  if (a.x == kSphere) return sphere_test(a, b, r);
  if (a.x == kCylinder) return cylinder_test(a, b, r);
  return kBig;
}

}  // namespace mct_cluster
