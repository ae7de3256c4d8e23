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
// Per-ray roots (the TPU kernels' packet_roots option, which the
// binned-subtree path of trace/cut.py uses for its phase 2): with a roots
// array, ray i starts at roots[i] instead of node 0. A root >= 0 is a node
// whose children are tested as usual; a root < 0 is leaf cluster -root-1,
// whose 8 triangles are tested with no box test, as the TPU kernel queues
// such a cluster directly. Per-packet roots are the special case of equal
// roots in a run of rays, and the cut path sorts its rays by root, so the
// warps stay coherent.
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
//
// Traversal cost (the TPU kernel's stats=True variant, which feeds the
// heatmap AOV): traverse_kernel<false, true>, launched by
// tb_closest_hit_stats, also writes two int32 counts per ray. The TPU
// counters are per 2048-ray packet and count batched leaf drains; here
// they are per ray, as the reference's TraverseFunction.hlsli:46-47 keeps
// them:
//   pops     = nodes the ray pops and expands (a node root counts; a
//              popped node that the pop-time cull skips does not);
//   clusters = leaf clusters whose 8 triangles the ray tests (a leaf root
//              counts).
// A dead lane (t_max <= 0) gives 0 and 0. The counters live in registers
// and change nothing of the walk, so (t, tri, u, v) equal the stats-free
// kernel's bit for bit; the stats-free instantiation compiles as before.

#include "bvh_common.cuh"

using namespace tb;

namespace {

// The 8 triangles of one cluster against the ray: updates the closest hit
// (t < best) or the occlusion flag (t < t_max).
template <bool kAnyHit>
__device__ __forceinline__ void test_cluster(const float* __restrict__ tris,
                                             int32_t cluster, const Ray& ray,
                                             float& best, int32_t& best_tri,
                                             float& best_u, float& best_v,
                                             bool& occluded) {
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
}

template <bool kAnyHit, bool kStats = false>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ t_max,
                const int32_t* __restrict__ nodes,
                const float* __restrict__ tris,
                const int32_t* __restrict__ roots, int n_rays,
                float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                bool* __restrict__ occ_out,
                unsigned int* __restrict__ overflow,
                int32_t* __restrict__ pops_out,
                int32_t* __restrict__ clusters_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray ray = load_ray(orig, dir, t_max, i);

  float best = ray.t_max;
  int32_t best_tri = -1;
  float best_u = 0.f, best_v = 0.f;
  bool occluded = false;
  int32_t pops = 0, clusters = 0;

  int32_t stack[kStackDepth];
  float stack_t[kStackDepth];
  int sp = 0;
  // Dead lanes (t_max <= 0, or NaN) return a miss at once.
  if (ray.t_max > 0.f) {
    const int32_t root = roots != nullptr ? roots[i] : 0;
    if (root >= 0) {
      stack[0] = root;
      stack_t[0] = -kBig;
      sp = 1;
    } else {
      test_cluster<kAnyHit>(tris, -root - 1, ray, best, best_tri, best_u,
                            best_v, occluded);
      if (kStats) ++clusters;
    }
  }
  while (sp > 0 && !(kAnyHit && occluded)) {
    --sp;
    if (!kAnyHit && !(stack_t[sp] < best)) continue;
    if (kStats) ++pops;
    const int32_t* __restrict__ row = nodes + static_cast<size_t>(stack[sp]) * kRow;
    int32_t push_id[8];
    float push_t[8];
    int n_push = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int32_t cid = row[48 + c];
      if (cid == kInvalid) continue;
      float t_near, t_far;
      child_slab(row, c, ray, t_near, t_far);
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
      test_cluster<kAnyHit>(tris, -cid - 1, ray, best, best_tri, best_u,
                            best_v, occluded);
      if (kStats) ++clusters;
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
  if (kStats) {
    pops_out[i] = pops;
    clusters_out[i] = clusters;
  }
}

}  // namespace

// roots may be null (every ray starts at node 0).
extern "C" int tb_closest_hit(const float* orig, const float* dir,
                              const float* t_max, const int32_t* nodes,
                              const float* tris, const int32_t* roots,
                              int n_rays, float* t_out, int32_t* tri_out,
                              float* u_out, float* v_out,
                              unsigned int* overflow, void* stream) {
  if (n_rays > 0) {
    traverse_kernel<false>
        <<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            orig, dir, t_max, nodes, tris, roots, n_rays, t_out, tri_out,
            u_out, v_out, nullptr, overflow, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Closest hit from node 0 with the per-ray traversal cost (pops_out,
// clusters_out: int32 per ray).
extern "C" int tb_closest_hit_stats(const float* orig, const float* dir,
                                    const float* t_max, const int32_t* nodes,
                                    const float* tris, int n_rays,
                                    float* t_out, int32_t* tri_out,
                                    float* u_out, float* v_out,
                                    int32_t* pops_out, int32_t* clusters_out,
                                    unsigned int* overflow, void* stream) {
  if (n_rays > 0) {
    traverse_kernel<false, true>
        <<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            orig, dir, t_max, nodes, tris, nullptr, n_rays, t_out, tri_out,
            u_out, v_out, nullptr, overflow, pops_out, clusters_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tb_any_hit(const float* orig, const float* dir,
                          const float* t_max, const int32_t* nodes,
                          const float* tris, const int32_t* roots, int n_rays,
                          bool* occ_out, unsigned int* overflow,
                          void* stream) {
  if (n_rays > 0) {
    traverse_kernel<true>
        <<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            orig, dir, t_max, nodes, tris, roots, n_rays, nullptr, nullptr,
            nullptr, nullptr, occ_out, overflow, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
