// K4: any hit with t < maxt over the two-level cluster structure (shadow
// rays), one thread per ray.
//
// Replaces the TPU kernel mitsuba_customization_tpu/ops/clusters.py
// `_shadow_kernel` (launched by `_shadow_impl`, reached through `occluded`
// from `Scene.ray_test`). The TPU version keeps a 4096-lane packet alive
// until every lane is resolved, visits superclusters nearest-entry-first
// and streams slabs by double-buffered DMA; here each thread stops at its
// own first occluder.
//
// What bounds it on the H100: as K3, box and slot tests over a structure
// that sits in L2 and mostly in L1; a shadow ray ends at its first hit,
// so occluded lanes are cheap and unoccluded ones pay for every box their
// segment crosses. Dead lanes and lanes without an NEE sample (maxt <= 0)
// cost one load and one store. The box tests use the capped distance
// (root_cap); the occlusion compare uses the true maxt (clamped to 1e30),
// as the TPU kernel does.
#include "cluster_common.cuh"

namespace {

using namespace mct_cluster;

template <bool kTriOnly>
__device__ __forceinline__ bool any_hit(const float* slab, const Ray& r,
                                        float mt) {
  for (int i = 0; i < kL; ++i) {
    const float* row = slab + i * kFields;
    if (__ldg(row) < 0.f) break;  // empty slots only follow the filled ones
    float u, v;
    if (slot_test<kTriOnly>(row, r, u, v) < mt) return true;
  }
  return false;
}

__device__ __forceinline__ bool occluded(const Ray& r, float mt,
                                         const float* root,
                                         const float* sc_box, int n_super,
                                         const float* cl_box,
                                         const int32_t* cl_meta, int n_cl,
                                         const float* slabs) {
  const float cap = root_cap(root, r, mt);
  for (int s = 0; s < n_super; ++s) {
    if (!box_pass(sc_box + 8 * s, r, cap)) continue;
    const int c_end = min((s + 1) * kGroup, n_cl);
    for (int c = s * kGroup; c < c_end; ++c) {
      if (!box_pass(cl_box + 8 * c, r, cap)) continue;
      const float* slab = slabs + (int64_t)c * kL * kFields;
      const bool hit = __ldg(cl_meta + c) == 0 ? any_hit<true>(slab, r, mt)
                                               : any_hit<false>(slab, r, mt);
      if (hit) return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
    cluster_shadow_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ maxt, int64_t n,
                          const float* __restrict__ root,
                          const float* __restrict__ sc_box, int n_super,
                          const float* __restrict__ cl_box,
                          const int32_t* __restrict__ cl_meta, int n_cl,
                          const float* __restrict__ slabs,
                          uint8_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float mt = maxt[lane];
  bool occ = false;
  if (mt > 0.f)
    occ = occluded(load_ray(o, d, lane), fminf(mt, kBig), root, sc_box,
                   n_super, cl_box, cl_meta, n_cl, slabs);
  out[lane] = occ ? 1 : 0;
}

}  // namespace

// o, d: (n, 3) f32; maxt: (n,) f32; root: (8,) f32; sc_box: (n_super, 8);
// cl_box: (n_cl, 8); cl_meta: (n_cl,) i32; slabs: (n_cl, 32, 32) f32;
// out: (n,) u8, 1 = occluded.
extern "C" int mct_cluster_shadow(const float* o, const float* d,
                                  const float* maxt, int64_t n,
                                  const float* root, const float* sc_box,
                                  int n_super, const float* cl_box,
                                  const int32_t* cl_meta, int n_cl,
                                  const float* slabs, uint8_t* out,
                                  cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cluster_shadow_kernel<<<blocks, kThreads, 0, stream>>>(
        o, d, maxt, n, root, sc_box, n_super, cl_box, cl_meta, n_cl, slabs,
        out);
  }
  return (int)cudaGetLastError();
}
