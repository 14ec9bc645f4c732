// K3: closest hit over the two-level cluster structure, one thread per ray.
//
// Replaces the TPU kernel mitsuba_customization_tpu/ops/clusters.py
// `_closest_kernel` (launched by `_closest_impl`, reached through
// `intersect` from `Scene.ray_intersect`). The TPU version walks 4096-lane
// packets: per-tile supercluster entry distances, SMEM box tables, a
// double-buffered DMA of each visited cluster's (32, 128) slab into VMEM,
// and a deferred walk over the tile's winner clusters to fetch their
// fields. Those are answers to a machine without per-lane control flow or
// gathers, and none is carried over.
//
// What bounds it on the H100: per ray, 64 supercluster and a few dozen
// cluster box tests (32 bytes each) and the slot tests of the clusters it
// enters (40 bytes per triangle slot), all reads of a structure that fits
// in L2 (boxes 34 KB and slabs 4 MB at the matpreview mesh's 1,024
// clusters) and mostly in L1, since the render loop hands neighbouring
// threads neighbouring pixels. So it is bound by issue (arithmetic and
// divergence within a warp), not by device memory. The design keeps
// everything per ray in registers: the running best t, the winner's
// (cluster, slot) code and its u, v; a box is tested only against the
// running best (entry < t_best), so once a close hit is found the rest of
// the structure is pruned at one box test per supercluster. The winner's
// 32-float field row is copied once, at the end. Superclusters and
// clusters are visited in index order (the build's DFS order keeps
// neighbours adjacent); visiting them nearest-entry-first is left to
// measurement.
//
// Semantics (ops/clusters.py in the port; see cluster_common.cuh):
//   maxt <= 0 (or NaN)  -> the lane returns a miss at once;
//   maxt = inf          -> clamped to 1e30;
//   t cap               -> root_cap; a hit counts when t < the running best;
//   ties                -> the lowest (cluster, slot) wins;
//   miss                -> t = +inf, u = v = 0, fields = the miss row
//                          (type, emitter, shape and prim -1, others 0).
#include "cluster_common.cuh"

namespace {

using namespace mct_cluster;

template <bool kTriOnly>
__device__ __forceinline__ void test_cluster(const float* slab, int c,
                                             const Ray& r, float& t_best,
                                             int& code, float& u_best,
                                             float& v_best) {
  for (int i = 0; i < kL; ++i) {
    const float* row = slab + i * kFields;
    if (__ldg(row) < 0.f) break;  // empty slots only follow the filled ones
    float u, v;
    const float t = slot_test<kTriOnly>(row, r, u, v);
    if (t < t_best) {
      t_best = t;
      code = c * kL + i;
      u_best = u;
      v_best = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    cluster_closest_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ maxt, int64_t n,
                           const float* __restrict__ root,
                           const float* __restrict__ sc_box, int n_super,
                           const float* __restrict__ cl_box,
                           const int32_t* __restrict__ cl_meta, int n_cl,
                           const float* __restrict__ slabs,
                           float* __restrict__ out_t, float* __restrict__ out_u,
                           float* __restrict__ out_v,
                           float* __restrict__ out_fields) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float mt = maxt[lane];
  float t_best = 0.f, u_best = 0.f, v_best = 0.f;
  int code = -1;
  if (mt > 0.f) {
    const Ray r = load_ray(o, d, lane);
    t_best = root_cap(root, r, fminf(mt, kBig));
    for (int s = 0; s < n_super; ++s) {
      if (!box_pass(sc_box + 8 * s, r, t_best)) continue;
      const int c_end = min((s + 1) * kGroup, n_cl);
      for (int c = s * kGroup; c < c_end; ++c) {
        if (!box_pass(cl_box + 8 * c, r, t_best)) continue;
        const float* slab = slabs + (int64_t)c * kL * kFields;
        if (__ldg(cl_meta + c) == 0)
          test_cluster<true>(slab, c, r, t_best, code, u_best, v_best);
        else
          test_cluster<false>(slab, c, r, t_best, code, u_best, v_best);
      }
    }
  }
  const bool hit = code >= 0;
  out_t[lane] = hit ? t_best : __int_as_float(0x7f800000);  // +inf
  out_u[lane] = hit ? u_best : 0.f;
  out_v[lane] = hit ? v_best : 0.f;
  float4* dst = reinterpret_cast<float4*>(out_fields + lane * kFields);
  if (hit) {
    const float4* src =
        reinterpret_cast<const float4*>(slabs + (int64_t)code * kFields);
#pragma unroll
    for (int k = 0; k < kFields / 4; ++k) dst[k] = __ldg(src + k);
  } else {
    // miss row: type (0), emitter (26), shape (27) and prim (28) are -1
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kFields / 4; ++k) dst[k] = z;
    dst[0].x = -1.f;
    dst[6] = make_float4(0.f, 0.f, -1.f, -1.f);
    dst[7].x = -1.f;
  }
}

}  // namespace

// o, d: (n, 3) f32; maxt: (n,) f32; root: (8,) f32; sc_box: (n_super, 8);
// cl_box: (n_cl, 8); cl_meta: (n_cl,) i32; slabs: (n_cl, 32, 32) f32;
// out_t, out_u, out_v: (n,) f32; out_fields: (n, 32) f32.
extern "C" int mct_cluster_closest(const float* o, const float* d,
                                   const float* maxt, int64_t n,
                                   const float* root, const float* sc_box,
                                   int n_super, const float* cl_box,
                                   const int32_t* cl_meta, int n_cl,
                                   const float* slabs, float* out_t,
                                   float* out_u, float* out_v,
                                   float* out_fields, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cluster_closest_kernel<<<blocks, kThreads, 0, stream>>>(
        o, d, maxt, n, root, sc_box, n_super, cl_box, cl_meta, n_cl, slabs,
        out_t, out_u, out_v, out_fields);
  }
  return (int)cudaGetLastError();
}
