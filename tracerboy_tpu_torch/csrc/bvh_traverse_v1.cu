// The first-generation ("v1") closest-hit traversal of the packed 8-wide
// BVH, one thread per ray, for Hopper (sm_90a).
//
// Replaces: tracerboy_tpu/trace/pallas_traverse.py: traverse_packets
// (_traverse_kernel, _traverse_one). The TPU kernel walks 1024-ray packets
// that share one 96-entry stack in scalar memory, 16 packets per program,
// with the tables resident in vector memory (or the cluster rows fetched
// by DMA); a node is entered if any ray of the packet wants it. None of
// that is the contract. The contract is the outputs: the same tables
// (node rows as in bvh_traverse.cu; cluster rows of 8 triangles x 9 raw
// floats v0, v1, v2), the same slab and Moller-Trumbore arithmetic, the
// same acceptance rules. Here each ray has its own stack.
//
// What differs from the second-generation kernel (bvh_traverse.cu):
//   - no child ordering: the inner children a ray enters are pushed in slot
//     order 0..7 and popped last first; the stack holds ids only, so a
//     popped node is always expanded (there is no entry distance to cull
//     by);
//   - a leaf child is tested when its parent is expanded, in slot order;
//   - the triangle test is Moller-Trumbore on the raw vertices, accepted
//     iff |det| > 1e-9, u >= 0, v >= 0, u + v <= 1, t > 1e-5 and t < best
//     (strictly, so the first triangle found wins a tie in t). |det| > 1e-9
//     depends on the triangle's scale and the ray's angle: small or grazing
//     triangles that the Baldwin-Weber test accepts are rejected here.
//
// Culling: the TPU kernel tests a popped node's children against the best
// hit as it stood at the pop; this kernel uses the best hit as it stands at
// each child, which a leaf of an earlier slot may just have improved.
// Entering more boxes changes no result, so the outputs are the same.
//
// Stack: unordered pushes need up to 7 entries per level of the tree plus
// one; kStackDepthV1 = 96 is the TPU kernel's depth and covers 13 levels.
// A push past it is dropped, as on the TPU, but counted in *overflow, and
// the callers require 0.
//
// Arithmetic: built with --fmad=false; the cross and dot products are
// written out term by term in the order of the plain PyTorch version
// (trace/traverse_v1.py: closest_hit_v1_plain), so both round alike.

#include "bvh_common.cuh"

using namespace tb;

namespace {

constexpr int kStackDepthV1 = 96;
constexpr int kTriFloats = 9;
constexpr float kMtDetEps = 1e-9f;

// Moller-Trumbore of one raw triangle row (v0, v1, v2) against the ray.
__device__ __forceinline__ bool mt_test(const float* __restrict__ r,
                                        const Ray& ray, float& t, float& u,
                                        float& v) {
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  const float e1x = r[3] - v0x, e1y = r[4] - v0y, e1z = r[5] - v0z;
  const float e2x = r[6] - v0x, e2y = r[7] - v0y, e2z = r[8] - v0z;
  const float px = ray.dy * e2z - ray.dz * e2y;
  const float py = ray.dz * e2x - ray.dx * e2z;
  const float pz = ray.dx * e2y - ray.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool good = fabsf(det) > kMtDetEps;
  const float inv_det = good ? 1.0f / det : 0.0f;
  const float tvx = ray.ox - v0x, tvy = ray.oy - v0y, tvz = ray.oz - v0z;
  u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return good && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin;
}

__global__ void __launch_bounds__(kThreads)
traverse_v1_kernel(const float* __restrict__ orig,
                   const float* __restrict__ dir,
                   const float* __restrict__ t_max,
                   const int32_t* __restrict__ nodes,
                   const float* __restrict__ tris, int n_rays,
                   float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray ray = load_ray(orig, dir, t_max, i);

  float best = ray.t_max;
  int32_t best_tri = -1;
  float best_u = 0.f, best_v = 0.f;

  int32_t stack[kStackDepthV1];
  int sp = 0;
  // Dead lanes (t_max <= 0, or NaN) return a miss at once.
  if (ray.t_max > 0.f) {
    stack[0] = 0;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    const int32_t* __restrict__ row =
        nodes + static_cast<size_t>(stack[sp]) * kRow;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int32_t cid = row[48 + c];
      if (cid == kInvalid) continue;
      float t_near, t_far;
      child_slab(row, c, ray, t_near, t_far);
      if (!(t_far >= fmaxf(t_near, 0.f) && t_near < best)) continue;
      if (cid >= 0) {
        if (sp < kStackDepthV1) {
          stack[sp++] = cid;
        } else {
          atomicAdd(overflow, 1u);
        }
        continue;
      }
      const int32_t cluster = -cid - 1;
      const float* __restrict__ trow =
          tris + static_cast<size_t>(cluster) * kRow;
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        float t, u, v;
        if (mt_test(trow + kTriFloats * k, ray, t, u, v) && t < best) {
          best = t;
          best_tri = cluster * kLeaf + k;
          best_u = u;
          best_v = v;
        }
      }
    }
  }

  t_out[i] = best_tri < 0 ? kBig : best;
  tri_out[i] = best_tri;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

extern "C" int tb_closest_hit_v1(const float* orig, const float* dir,
                                 const float* t_max, const int32_t* nodes,
                                 const float* tris, int n_rays, float* t_out,
                                 int32_t* tri_out, float* u_out, float* v_out,
                                 unsigned int* overflow, void* stream) {
  if (n_rays > 0) {
    traverse_v1_kernel<<<blocks_for(n_rays), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        orig, dir, t_max, nodes, tris, n_rays, t_out, tri_out, u_out, v_out,
        overflow);
  }
  return static_cast<int>(cudaGetLastError());
}
