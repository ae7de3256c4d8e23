// Closest-hit and any-hit traversal of the packed 8-wide BVH, one thread
// per ray, for Hopper (sm_90a).
//
// Replaces: tracerboy_tpu/trace/pallas_traverse2.py: traverse_packets2 and
// anyhit_packets2 (both built by _make_kernel, with _node_children and
// _tri_tests). The TPU kernel walks 2048-ray packets that share one stack
// and enter a node if any ray wants it; here each ray has its own stack.
// The outputs are the contract, not the packet schedule: the same tables
// (trace/traverse.py documents the row layouts), the same slab and
// Baldwin-Weber arithmetic, the same acceptance rules, the same outputs.
//
// What bounds it on the card: every node pop and every leaf is a dependent
// load of a 512-byte row (node rows are int32 x 128, cluster rows float x
// 128) from device memory or L2, and rays of one warp diverge in their
// paths, so the warp serialises over the union of its rays' node visits.
// The design keeps it simple and correct first: rows are read through the
// read-only path (const __restrict__), children are pushed far to near so
// the nearest subtree pops first and tightens the closest-hit bound, and
// a popped node whose entry distance is no longer below the best hit is
// skipped. Node rows in shared memory, 16-byte vector loads, persistent
// threads and ray sorting are later work.
//
// Arithmetic: build with --fmad=false, so no a*b+c is contracted into an
// FMA and every value rounds as in the plain PyTorch twin
// (closest_hit_plain / anyhit_plain), which evaluates the same expressions
// in the same order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStackDepth = 96;
constexpr int kLeaf = 8;
constexpr int kRow = 128;
constexpr int32_t kInvalid = 0x7fffffff;
constexpr float kBig = 1e30f;
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryHi = static_cast<float>(1.0 + 1e-5);
constexpr float kTMin = 1e-5f;
constexpr float kDetEps = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, inv_x, inv_y, inv_z, t_max;
};

// |d| < 1e-12 maps to +-1e-12 (0 and -0 to +1e-12), as the TPU kernel's fix.
__device__ __forceinline__ float fix_dir(float v) {
  return fabsf(v) < kDetEps ? (v < 0.f ? -kDetEps : kDetEps) : v;
}

// Baldwin-Weber test of one triangle row (12 floats). Returns true if the
// hit is accepted geometrically; t, u, v are its parameters.
__device__ __forceinline__ bool bw_test(const float* __restrict__ r,
                                        const Ray& ray, float& t, float& u,
                                        float& v) {
  const float A = r[0] * ray.ox + r[1] * ray.oy + r[2] * ray.oz + r[3];
  const float B = r[0] * ray.dx + r[1] * ray.dy + r[2] * ray.dz;
  const float inv_b = fabsf(B) > kDetEps ? 1.0f / B : 0.0f;
  t = -A * inv_b;
  const float co = r[4] * ray.ox + r[5] * ray.oy + r[6] * ray.oz + r[7];
  const float cd = r[4] * ray.dx + r[5] * ray.dy + r[6] * ray.dz;
  u = co + t * cd;
  const float eo = r[8] * ray.ox + r[9] * ray.oy + r[10] * ray.oz + r[11];
  const float ed = r[8] * ray.dx + r[9] * ray.dy + r[10] * ray.dz;
  v = eo + t * ed;
  // The 1e-5 band turns edge cracks into harmless double acceptance.
  return fabsf(B) > kDetEps && u >= -kBaryEps && v >= -kBaryEps &&
         u + v <= kBaryHi && t > kTMin;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ t_max,
                const int32_t* __restrict__ nodes,
                const float* __restrict__ tris, int n_rays,
                float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                bool* __restrict__ occ_out,
                unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray ray;
  ray.ox = orig[3 * i + 0];
  ray.oy = orig[3 * i + 1];
  ray.oz = orig[3 * i + 2];
  ray.dx = dir[3 * i + 0];
  ray.dy = dir[3 * i + 1];
  ray.dz = dir[3 * i + 2];
  ray.t_max = t_max[i];
  ray.inv_x = 1.0f / fix_dir(ray.dx);
  ray.inv_y = 1.0f / fix_dir(ray.dy);
  ray.inv_z = 1.0f / fix_dir(ray.dz);

  float best = ray.t_max;
  int32_t best_tri = -1;
  float best_u = 0.f, best_v = 0.f;
  bool occluded = false;

  int32_t stack[kStackDepth];
  float stack_t[kStackDepth];
  int sp = 0;
  // Dead lanes (t_max <= 0, or NaN) return a miss at once.
  if (ray.t_max > 0.f) {
    stack[0] = 0;
    stack_t[0] = -kBig;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    if (!kAnyHit && !(stack_t[sp] < best)) continue;
    const int32_t* __restrict__ row = nodes + static_cast<size_t>(stack[sp]) * kRow;
    int32_t push_id[8];
    float push_t[8];
    int n_push = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int32_t cid = row[48 + c];
      if (cid == kInvalid) continue;
      const float t0x = (__int_as_float(row[c]) - ray.ox) * ray.inv_x;
      const float t0y = (__int_as_float(row[8 + c]) - ray.oy) * ray.inv_y;
      const float t0z = (__int_as_float(row[16 + c]) - ray.oz) * ray.inv_z;
      const float t1x = (__int_as_float(row[24 + c]) - ray.ox) * ray.inv_x;
      const float t1y = (__int_as_float(row[32 + c]) - ray.oy) * ray.inv_y;
      const float t1z = (__int_as_float(row[40 + c]) - ray.oz) * ray.inv_z;
      const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fminf(t0z, t1z));
      const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fmaxf(t0z, t1z));
      const float t_cap = kAnyHit ? ray.t_max : best;
      if (!(t_far >= fmaxf(t_near, 0.f) && t_near < t_cap)) continue;
      if (cid >= 0) {
        // Insert sorted by descending t_near: the nearest child is pushed
        // last and pops first.
        int k = n_push++;
        while (k > 0 && push_t[k - 1] < t_near) {
          push_t[k] = push_t[k - 1];
          push_id[k] = push_id[k - 1];
          --k;
        }
        push_t[k] = t_near;
        push_id[k] = cid;
        continue;
      }
      const int32_t cluster = -cid - 1;
      const float* __restrict__ trow = tris + static_cast<size_t>(cluster) * kRow;
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        float t, u, v;
        const bool ok = bw_test(trow + 12 * k, ray, t, u, v);
        if (kAnyHit) {
          if (ok && t < ray.t_max) occluded = true;
        } else if (ok && t < best) {
          best = t;
          best_tri = cluster * kLeaf + k;
          best_u = u;
          best_v = v;
        }
      }
      if (kAnyHit && occluded) break;
    }
    if (kAnyHit && occluded) break;
    for (int k = 0; k < n_push; ++k) {
      if (sp < kStackDepth) {
        stack[sp] = push_id[k];
        stack_t[sp] = push_t[k];
        ++sp;
      } else {
        atomicAdd(overflow, 1u);
      }
    }
  }

  if (kAnyHit) {
    occ_out[i] = occluded;
  } else {
    t_out[i] = best_tri < 0 ? kBig : best;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

constexpr int kThreads = 128;

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tb_closest_hit(const float* orig, const float* dir,
                              const float* t_max, const int32_t* nodes,
                              const float* tris, int n_rays, float* t_out,
                              int32_t* tri_out, float* u_out, float* v_out,
                              unsigned int* overflow, void* stream) {
  if (n_rays > 0) {
    traverse_kernel<false>
        <<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            orig, dir, t_max, nodes, tris, n_rays, t_out, tri_out, u_out,
            v_out, nullptr, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tb_any_hit(const float* orig, const float* dir,
                          const float* t_max, const int32_t* nodes,
                          const float* tris, int n_rays, bool* occ_out,
                          unsigned int* overflow, void* stream) {
  if (n_rays > 0) {
    traverse_kernel<true>
        <<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            orig, dir, t_max, nodes, tris, n_rays, nullptr, nullptr, nullptr,
            nullptr, occ_out, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}
