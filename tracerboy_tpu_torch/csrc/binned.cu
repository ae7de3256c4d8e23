// The binned-cluster backend's two kernels, for Hopper (sm_90a):
// selection of the K nearest 128-triangle clusters of each ray, and the
// dense test of (ray, cluster) pairs sorted by cluster.
//
// Replaces: tracerboy_tpu/trace/binned.py: select_clusters (body
// _make_select_kernel) and dense_pairs (body _make_dense_kernel). The TPU
// kernels walk 2048-ray packets (selection) and 256-pair tiles that span
// at most DSEG cluster runs (dense); that is TPU scheduling. Here each
// thread owns one ray (selection) or one pair (dense); trace/binned.py
// documents the tables and the contracts.
//
// Selection. A ray walks the coarse BVH (bn_nodes, whose leaf children are
// clusters) nearest child first and keeps K slots of (entry t, cluster).
// A child's entry t is max(t_near, 0); it is entered iff t_far >= entry
// and entry < t_max. While all K slots are full, `worst` is the largest
// slot t, and a child (or a popped node) whose entry t is not below worst
// is pruned. The TPU kernel folds into `dropped` only the slots it evicts
// and the leaf children rejected within the node being popped; a child
// pruned by worst is never folded, which a 2048-ray packet rarely notices
// (some lane usually descends) but a per-ray walk hits all the time: a ray
// that enters K+1 clusters nearest first fills K slots, prunes the last
// and would report dropped = 1e30. So this kernel also folds the entry t
// of every child and node pruned by worst (not by t_max), and holds:
//   - the slot set is the K nearest clusters (ties aside);
//   - K-th nearest entry t <= dropped <= the entry t of every entered
//     cluster outside the set (the boxes nest, so a pruned node's entry t
//     bounds every cluster under it).
//
// Dense. A pair's thread tests its cluster's 128 triangles, rows of the
// (3*128, 4) Baldwin-Weber table [n|-d ; g1|h1 ; g2|h2]: A = n.o - d and
// B = n.dir as 4-term dot products summed x, y, z, w (the TPU's (3C,4) x
// (4,P) product at HIGHEST precision), t = -A / B with |B| < 1e-12
// replaced by 1e-12 (a division, where the traversal kernels multiply by
// 1/B: each keeps its TPU kernel's form), u = (g1.o + h1) + t (g1.dir),
// v likewise; accepted iff t > 1e-5, u, v >= -1e-5, u + v <= 1 + 1e-5,
// |B| >= 1e-12 and t < cap. The pair keeps its nearest accepted row,
// the lowest row at a tie, as packed id base[cluster] + row.
//
// What bounds them on the card: selection is a per-ray tree walk like the
// traversal kernels (dependent 512-byte node rows, warp divergence) with
// K = 16 slots in registers/local memory; dense reads 6 KB of table per
// pair, but the pairs are sorted by cluster, so the threads of a warp read
// the same rows at the same time (one broadcast transaction per float4,
// served from L1) and the kernel is bound by its 128 x ~40 flops per pair.
// Shared-memory cluster tiles and wgmma-free register blocking are later
// work.
//
// Arithmetic: built with --fmad=false, in the twins' order of operations
// (trace/binned.py: select_clusters_plain, dense_pairs_plain).

#include "bvh_common.cuh"

using namespace tb;

namespace {

constexpr int kSelectK = 16;   // trace/binned.py KSEL
constexpr int kCluster = 128;  // triangles per cluster

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
              const float* __restrict__ t_max,
              const int32_t* __restrict__ nodes, int n_rays,
              float* __restrict__ slot_t_out, int32_t* __restrict__ slot_c_out,
              float* __restrict__ dropped_out,
              unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray ray = load_ray(orig, dir, t_max, i);

  float slot_t[kSelectK];
  int32_t slot_c[kSelectK];
#pragma unroll
  for (int k = 0; k < kSelectK; ++k) {
    slot_t[k] = kBig;
    slot_c[k] = -1;
  }
  float worst = kBig;
  float dropped = kBig;

  int32_t stack[kStackDepth];
  float stack_t[kStackDepth];
  int sp = 0;
  if (ray.t_max > 0.f) {
    stack[0] = 0;
    stack_t[0] = 0.f;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    if (!(stack_t[sp] < worst)) {
      dropped = fminf(dropped, stack_t[sp]);
      continue;
    }
    const int32_t* __restrict__ row = nodes + static_cast<size_t>(stack[sp]) * kRow;
    int32_t push_id[8];
    float push_t[8];
    int n_push = 0;
    for (int c = 0; c < 8; ++c) {
      const int32_t cid = row[48 + c];
      if (cid == kInvalid) continue;
      float t_near, t_far;
      child_slab(row, c, ray, t_near, t_far);
      t_near = fmaxf(t_near, 0.f);
      if (!(t_far >= t_near && t_near < ray.t_max)) continue;
      if (!(t_near < worst)) {
        dropped = fminf(dropped, t_near);
        continue;
      }
      if (cid >= 0) {
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
      // Replace the worst slot (the first of equal maxima); an evicted
      // cluster's entry t is folded into dropped.
      int w = 0;
#pragma unroll
      for (int k = 1; k < kSelectK; ++k) {
        if (slot_t[k] > slot_t[w]) w = k;
      }
      dropped = fminf(dropped, slot_t[w]);
      slot_t[w] = t_near;
      slot_c[w] = -cid - 1;
      float m = slot_t[0];
#pragma unroll
      for (int k = 1; k < kSelectK; ++k) m = fmaxf(m, slot_t[k]);
      worst = m;
    }
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
  float* __restrict__ st = slot_t_out + static_cast<size_t>(i) * kSelectK;
  int32_t* __restrict__ sc = slot_c_out + static_cast<size_t>(i) * kSelectK;
#pragma unroll
  for (int k = 0; k < kSelectK; ++k) {
    st[k] = slot_t[k];
    sc[k] = slot_c[k];
  }
  dropped_out[i] = dropped;
}

__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
             const float* __restrict__ cap, const int32_t* __restrict__ cluster,
             const float4* __restrict__ mot, const int32_t* __restrict__ base,
             int n_pairs, float* __restrict__ t_out,
             int32_t* __restrict__ tri_out, float* __restrict__ u_out,
             float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const float ox = orig[3 * i + 0], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float t_cap = cap[i];
  const int32_t c = cluster[i];
  const float4* __restrict__ m = mot + static_cast<size_t>(c) * 3 * kCluster;
  float best = kBig, best_u = 0.f, best_v = 0.f;
  int best_row = -1;
  for (int r = 0; r < kCluster; ++r) {
    const float4 a = m[r];
    const float4 g = m[kCluster + r];
    const float4 h = m[2 * kCluster + r];
    const float A = a.x * ox + a.y * oy + a.z * oz + a.w;
    const float B = a.x * dx + a.y * dy + a.z * dz;
    const float t = -A / (fabsf(B) < kDetEps ? kDetEps : B);
    const float u = (g.x * ox + g.y * oy + g.z * oz + g.w) +
                    t * (g.x * dx + g.y * dy + g.z * dz);
    const float v = (h.x * ox + h.y * oy + h.z * oz + h.w) +
                    t * (h.x * dx + h.y * dy + h.z * dz);
    const bool ok = t > kTMin && u >= -kBaryEps && v >= -kBaryEps &&
                    u + v <= kBaryHi && fabsf(B) >= kDetEps && t < t_cap;
    if (ok && t < best) {
      best = t;
      best_row = r;
      best_u = u;
      best_v = v;
    }
  }
  t_out[i] = best;
  tri_out[i] = best_row < 0 ? -1 : base[c] + best_row;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

extern "C" int tb_select_clusters(const float* orig, const float* dir,
                                  const float* t_max, const int32_t* nodes,
                                  int n_rays, float* slot_t, int32_t* slot_c,
                                  float* dropped, unsigned int* overflow,
                                  void* stream) {
  if (n_rays > 0) {
    select_kernel<<<blocks_for(n_rays), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        orig, dir, t_max, nodes, n_rays, slot_t, slot_c, dropped, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tb_dense_pairs(const float* orig, const float* dir,
                              const float* cap, const int32_t* cluster,
                              const float* mot, const int32_t* base,
                              int n_pairs, float* t_out, int32_t* tri_out,
                              float* u_out, float* v_out, void* stream) {
  if (n_pairs > 0) {
    dense_kernel<<<blocks_for(n_pairs), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        orig, dir, cap, cluster, reinterpret_cast<const float4*>(mot), base,
        n_pairs, t_out, tri_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
