// The binned-cluster backend's two kernels, for Hopper (sm_90a):
// selection of the K nearest 128-triangle clusters of each ray, and the
// dense test of (ray, cluster) pairs sorted by cluster.
//
// Replaces: tracerboy_tpu/trace/binned.py: select_clusters (body
// _make_select_kernel) and dense_pairs (body _make_dense_kernel). The TPU
// kernels walk 2048-ray packets (selection) and 256-pair tiles that span
// at most DSEG cluster runs (dense); that is TPU scheduling. Here a thread
// owns one ray (selection) or one pair (dense); trace/binned.py documents
// the tables and the contracts.
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
// Dense. A pair tests its cluster's 128 triangles, rows of the (3*128, 4)
// Baldwin-Weber table [n|-d ; g1|h1 ; g2|h2]: A = n.o - d and B = n.dir as
// 4-term dot products summed x, y, z, w (the TPU's (3C,4) x (4,P) product
// at HIGHEST precision), t = -A / B with |B| < 1e-12 replaced by 1e-12 (a
// division, where the traversal kernels multiply by 1/B: each keeps its
// TPU kernel's form), u = (g1.o + h1) + t (g1.dir), v likewise; accepted
// iff t > 1e-5, u, v >= -1e-5, u + v <= 1 + 1e-5, |B| >= 1e-12 and t <
// cap. The pair keeps its nearest accepted row, the lowest row at a tie,
// as packed id base[cluster] + row.
//
// What bounded the first kernels of this file (a thread per ray, a thread
// per pair), on an NVIDIA H100 80GB HBM3 at 700 W, "shadertoy" 1280x720
// (PERF.md):
// - Selection: 0.538 ms on the 921,600-ray primary wave against a bound of
//   0.044 ms set by bytes, and 19.9 ms over the five bounce launches of an
//   8-sample wave (7,372,800 lanes each, 4.10M down to 0.04M live) against
//   1.76 ms. The slots, the push list and the 96-entry stack were indexed
//   at run time, so they lived in local memory (960 B of stack frame), each
//   insertion scanned the 16 slots twice, and every lane, dead or alive,
//   wrote its 16 + 16 outputs with 4-byte stores 64 bytes apart: a launch
//   with 0.5% of its lanes live still took 3.4 ms.
// - Dense: 1.485 ms on the 4.9M primary pairs and 11.3 ms over the ten
//   bounce launches (36.9M pairs) against 0.461 and 3.46 ms set by
//   operations (49 a pair-row at the float32 peak; with --fmad=false the
//   card runs them as 49 instructions, so half the bound is the most any
//   design that does every row's arithmetic can reach). It was bound by its
//   instruction count: about 79 a pair-row, the division, u and v of every
//   row computed before any test.
//
// What this design does about it:
// - Selection, with the layout of bvh_traverse.cu's octet_kernel: a ray per
//   8 lanes (an octet), the four octets of a warp in one lock-step loop
//   whose shuffles and ballots all name the full warp, persistent blocks
//   whose octets draw tickets of 8 rays from a device counter. Lane c
//   tests child c of the popped node, so the 7 loads of a node step read
//   one 32-byte sector per octet whatever the other rays do. The K = 16
//   slots live in registers, nearest first (the plain version's order):
//   lane j holds slots j and j + 8, the worst slot is lane 7's second,
//   and an insertion counts the slots at or below its t with two ballots
//   and moves the farther ones up one slot by shuffles, folding the
//   evicted slot 15 into dropped; no slot array is indexed at run time.
//   Entered inner children are pushed ranked by entry t (one width-8
//   shuffle per entered child: nearest on top, at equal t the higher
//   slot), entered leaf children inserted in slot order, each against the
//   worst slot as it stands. The stack of (node, entry t) pairs, one int2
//   array of stack_entries per octet, lies in shared memory, sized from
//   the tree (traverse.stack_need); a push past it is dropped and counted
//   in *overflow. Each lane of a drawn ticket looks at its ray: the dead
//   ones (t_max <= 0 or NaN) get their empty outputs (1e30, -1; dropped
//   1e30) at once, 16 bytes a lane, and are never walked. Measured on the
//   bounce launches of an 8-sample wave, this layout beat a thread per ray
//   (the slots in registers with an unrolled insertion, a 19-exchange
//   sorting network over the children, the stack in shared memory, dead
//   rays retired a warp at a time, with or without the live rays queued
//   per warp) by 10-16%, and lost to it by 2x on the coherent primary wave,
//   which the binned path never selects for (PERF.md).
// - Dense, a pair per thread, 128 a block. The pairs are sorted by
//   cluster, so the 32 pairs of a warp mostly read the same row at the same
//   time: one broadcast from L1. (Copying each run's 6 KB of rows into
//   shared memory, with cp.async into two buffers of persistent blocks or
//   once a block, measured slower: PERF.md.) Each row computes A and B
//   first, in the plain version's order, and goes no further unless -A and
//   B have opposite signs and |B| >= 1e-12 (otherwise t <= 0 < 1e-5 or the
//   row is rejected by |B|: the full test rejects it too; A * B < 0 is
//   exact here, since a product that underflows to 0 needs t < 1e-21);
//   then t = -A / B, and no further unless 1e-5 < t < min(best, cap) (a row
//   at or beyond the nearest accepted hit cannot win: strictly nearer wins
//   and rows go in order, so the lowest row keeps a tie); then u, and v
//   only if u >= -1e-5. Every row that gets that far computes t, u and v
//   by the plain version's expressions. The 32 pairs of a warp test the
//   same row at the same time, so a stage costs a warp-row whenever one of
//   its pairs needs it: on the bounce launches 85% of the warp-rows pass
//   the sign test, 84% the t test and 69% the u test, against 62%, 59% and
//   28% of the pair-rows; on the primary pairs 89%, 87% and 53%. That,
//   not bytes, bounds it: the arithmetic a surviving row needs is the
//   plain version's, about 70 instructions without FMA.
// - Not here: a TF32 or 3xTF32 tensor-core product for A, B and the u, v
//   terms. It rounds otherwise than the plain version exactly where the
//   cancellation in A = n.o - d decides t > 1e-5 for a ray leaving a
//   surface, and the binned path sees only such rays (ROADMAP.md).
//
// Arithmetic: built with --fmad=false, in the plain versions' order of
// operations (trace/binned.py: select_clusters_plain, dense_pairs_plain).

#include "bvh_common.cuh"

using namespace tb;

namespace {

constexpr int kSelectK = 16;     // trace/binned.py KSEL
constexpr int kCluster = 128;    // triangles per cluster
constexpr int kClusterRows = 3 * kCluster;
constexpr int kSelThreads = 128;   // 16 rays in flight a block
constexpr int kSelOctets = kSelThreads / kOctet;
constexpr int kDenseThreads = 128;

// The selection (see the file's header): a ray per octet; ticket b is the
// rays 8 b .. 8 b + 7.
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
              const float* __restrict__ t_max,
              const int32_t* __restrict__ nodes, int n_rays,
              int stack_entries, float* __restrict__ slot_t_out,
              int32_t* __restrict__ slot_c_out,
              float* __restrict__ dropped_out,
              unsigned int* __restrict__ next_ray,
              unsigned int* __restrict__ overflow) {
  extern __shared__ int2 select_stack[];
  const int sub = threadIdx.x & (kOctet - 1);
  const int shift = threadIdx.x & 24;
  int2* stack = select_stack + (threadIdx.x / kOctet) * stack_entries;
  const unsigned int n = static_cast<unsigned int>(n_rays);
  unsigned int first = 0u, todo = 0u;
  bool drained = false, walking = false;
  Ray ray;
  int i = 0, sp = 0;
  float st_lo = kBig, st_hi = kBig, dropped = kBig;
  int32_t sc_lo = -1, sc_hi = -1;
  for (;;) {
    // 1. Draw a ticket; its dead rays are retired here.
    const bool idle = !walking && todo == 0u && !drained;
    if (__any_sync(kFull, idle)) {
      unsigned int ticket = 0u;
      if (idle && sub == 0) ticket = atomicAdd(next_ray, 1u);
      ticket = __shfl_sync(kFull, ticket, 0, kOctet);
      bool live = false;
      if (idle) {
        first = ticket * kOctet;
        drained = ticket >= (n + kOctet - 1) / kOctet;
        if (!drained && first + sub < n) live = t_max[first + sub] > 0.f;
      }
      const unsigned int lives = octet_bits(__ballot_sync(kFull, live), shift);
      if (idle && !drained) {
        todo = lives;
        float4* st = reinterpret_cast<float4*>(
            slot_t_out + static_cast<size_t>(first) * kSelectK);
        int4* sc = reinterpret_cast<int4*>(
            slot_c_out + static_cast<size_t>(first) * kSelectK);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int f = sub + kOctet * q;   // float4 f is ray f / 4's
          const unsigned int r = first + f / 4;
          if (r < n && !((lives >> (f / 4)) & 1u)) {
            st[f] = make_float4(kBig, kBig, kBig, kBig);
            sc[f] = make_int4(-1, -1, -1, -1);
          }
        }
        if (first + sub < n && !live) dropped_out[first + sub] = kBig;
      }
    }
    if (__all_sync(kFull, drained && !walking && todo == 0u)) return;

    // 2. Start the next live ray of the ticket.
    if (!walking && todo != 0u) {
      i = static_cast<int>(first) + __ffs(todo) - 1;
      todo &= todo - 1u;
      ray = load_ray(orig, dir, t_max, i);
      st_lo = st_hi = dropped = kBig;
      sc_lo = sc_hi = -1;
      sp = 1;
      if (sub == 0) stack[0] = make_int2(0, __float_as_int(0.f));
      walking = true;
    }
    __syncwarp();

    // 3. Node step: pop; lane c tests child c against worst (slot 15).
    const float worst = __shfl_sync(kFull, st_hi, kOctet - 1, kOctet);
    int32_t cid = kInvalid;
    float t_near = 0.f;
    bool enter = false, pruned = false;
    if (walking && sp > 0) {
      --sp;
      const int2 top = stack[sp];
      const float top_t = __int_as_float(top.y);
      if (top_t < worst) {
        const int32_t* __restrict__ row =
            nodes + static_cast<size_t>(top.x) * kRow;
        cid = row[48 + sub];
        float t_far;
        child_slab(row, sub, ray, t_near, t_far);
        t_near = fmaxf(t_near, 0.f);
        const bool entered =
            cid != kInvalid && t_far >= t_near && t_near < ray.t_max;
        pruned = entered && !(t_near < worst);
        enter = entered && !pruned;
      } else {
        dropped = fminf(dropped, top_t);
      }
    }
    __syncwarp();   // every popped entry is read before a push lands on it
    float fold = pruned ? t_near : kBig;
#pragma unroll
    for (int s = kOctet / 2; s > 0; s >>= 1) {
      fold = fminf(fold, __shfl_xor_sync(kFull, fold, s, kOctet));
    }
    dropped = fminf(dropped, fold);
    const unsigned int inner =
        octet_bits(__ballot_sync(kFull, enter && cid >= 0), shift);
    unsigned int leaf =
        octet_bits(__ballot_sync(kFull, enter && cid < 0), shift);

    // Push the entered inner children: rank = those with a larger entry t,
    // or an equal one and a lower slot (they go below this one).
    int rank = 0;
    unsigned int rest = inner;
    if (!(rest & (rest - 1u))) rest = 0u;
    while (__any_sync(kFull, rest != 0u)) {
      const int j = rest != 0u ? __ffs(rest) - 1 : 0;
      const float tj = __shfl_sync(kFull, t_near, j, kOctet);
      if (rest != 0u) {
        rank += tj > t_near || (tj == t_near && j < sub);
        rest &= rest - 1u;
      }
    }
    if ((inner >> sub) & 1u) {
      const int slot = sp + rank;
      if (slot < stack_entries) {
        stack[slot] = make_int2(cid, __float_as_int(t_near));
      } else {
        atomicAdd(overflow, 1u);
      }
    }
    sp = min(sp + __popc(inner), stack_entries);
    __syncwarp();

    // 4. Leaf children in slot order, each against the current worst.
    while (__any_sync(kFull, leaf != 0u)) {
      const bool has = leaf != 0u;
      const int c = has ? __ffs(leaf) - 1 : 0;
      leaf &= leaf - 1u;
      const float lt = __shfl_sync(kFull, t_near, c, kOctet);
      const int32_t lid = -__shfl_sync(kFull, cid, c, kOctet) - 1;
      const float w = __shfl_sync(kFull, st_hi, kOctet - 1, kOctet);
      const bool insert = has && lt < w;
      const int pos =
          __popc(octet_bits(__ballot_sync(kFull, st_lo <= lt), shift)) +
          __popc(octet_bits(__ballot_sync(kFull, st_hi <= lt), shift));
      const float up_lo = __shfl_up_sync(kFull, st_lo, 1, kOctet);
      const int32_t up_lo_c = __shfl_up_sync(kFull, sc_lo, 1, kOctet);
      const float up_hi = __shfl_up_sync(kFull, st_hi, 1, kOctet);
      const int32_t up_hi_c = __shfl_up_sync(kFull, sc_hi, 1, kOctet);
      const float lo7 = __shfl_sync(kFull, st_lo, kOctet - 1, kOctet);
      const int32_t lo7_c = __shfl_sync(kFull, sc_lo, kOctet - 1, kOctet);
      if (has && !insert) dropped = fminf(dropped, lt);
      if (insert) {
        // Slot 15 falls out; slots above pos take the slot below them.
        dropped = fminf(dropped, w);
        if (sub > pos) {
          st_lo = up_lo;
          sc_lo = up_lo_c;
        } else if (sub == pos) {
          st_lo = lt;
          sc_lo = lid;
        }
        if (sub + kOctet > pos) {
          st_hi = sub == 0 ? lo7 : up_hi;
          sc_hi = sub == 0 ? lo7_c : up_hi_c;
        } else if (sub + kOctet == pos) {
          st_hi = lt;
          sc_hi = lid;
        }
      }
    }

    // 5. The ray ends with an empty stack.
    if (walking && sp == 0) {
      float* st = slot_t_out + static_cast<size_t>(i) * kSelectK;
      int32_t* sc = slot_c_out + static_cast<size_t>(i) * kSelectK;
      st[sub] = st_lo;
      st[sub + kOctet] = st_hi;
      sc[sub] = sc_lo;
      sc[sub + kOctet] = sc_hi;
      if (sub == 0) dropped_out[i] = dropped;
      walking = false;
    }
  }
}

// The nearest accepted row of one pair against its cluster's 384 rows, in
// the stages of the file's header.
__device__ __forceinline__ void dense_pair(const float4* __restrict__ rows,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float t_cap, float& best,
                                           int& best_row, float& best_u,
                                           float& best_v) {
  // min(best, cap); a NaN cap accepts nothing, as t < NaN never holds.
  float lim = t_cap > kBig ? kBig : t_cap;
  for (int r = 0; r < kCluster; ++r) {
    const float4 a = rows[r];
    const float A = a.x * ox + a.y * oy + a.z * oz + a.w;
    const float B = a.x * dx + a.y * dy + a.z * dz;
    if (!(A * B < 0.f) || fabsf(B) < kDetEps) continue;
    const float t = -A / B;
    if (!(t > kTMin && t < lim)) continue;
    const float4 g = rows[kCluster + r];
    const float u = (g.x * ox + g.y * oy + g.z * oz + g.w) +
                    t * (g.x * dx + g.y * dy + g.z * dz);
    if (!(u >= -kBaryEps)) continue;
    const float4 h = rows[2 * kCluster + r];
    const float v = (h.x * ox + h.y * oy + h.z * oz + h.w) +
                    t * (h.x * dx + h.y * dy + h.z * dz);
    if (v >= -kBaryEps && u + v <= kBaryHi) {
      lim = t;
      best = t;
      best_row = r;
      best_u = u;
      best_v = v;
    }
  }
}

// A pair per thread, 128 a block; its cluster's rows read from global
// memory through L1 (the 32 pairs of a warp mostly share the cluster, so
// a row read is one broadcast).
__global__ void __launch_bounds__(kDenseThreads)
dense_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
             const float* __restrict__ cap, const int32_t* __restrict__ cluster,
             const float4* __restrict__ mot, const int32_t* __restrict__ base,
             int n_pairs, float* __restrict__ t_out,
             int32_t* __restrict__ tri_out, float* __restrict__ u_out,
             float* __restrict__ v_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int32_t c = cluster[p];
  float best = kBig, best_u = 0.f, best_v = 0.f;
  int best_row = -1;
  dense_pair(mot + static_cast<size_t>(c) * kClusterRows, orig[3 * p + 0],
             orig[3 * p + 1], orig[3 * p + 2], dir[3 * p + 0],
             dir[3 * p + 1], dir[3 * p + 2], cap[p], best, best_row, best_u,
             best_v);
  t_out[p] = best;
  tri_out[p] = best_row < 0 ? -1 : base[c] + best_row;
  u_out[p] = best_u;
  v_out[p] = best_v;
}

}  // namespace

// The host side needs nvcc's launch syntax; a host compiler (the test that
// runs the kernels above on host threads) stops here.
#ifdef __CUDACC__

// stack_entries: the entries of each octet's stack (what the tree can ask
// for, traverse.stack_need); next_ray: one zeroed counter.
extern "C" int tb_select_clusters(
    const float* orig, const float* dir, const float* t_max,
    const int32_t* nodes, int n_rays, int stack_entries, float* slot_t,
    int32_t* slot_c, float* dropped, unsigned int* next_ray,
    unsigned int* overflow, void* stream) {
  return launch_persistent(
      select_kernel, kSelThreads,
      static_cast<size_t>(stack_entries) * kSelOctets * sizeof(int2), n_rays,
      kSelOctets * kOctet, stream, orig, dir, t_max, nodes, n_rays,
      stack_entries, slot_t, slot_c, dropped, next_ray, overflow);
}

extern "C" int tb_dense_pairs(const float* orig, const float* dir,
                              const float* cap, const int32_t* cluster,
                              const float* mot, const int32_t* base,
                              int n_pairs, float* t_out, int32_t* tri_out,
                              float* u_out, float* v_out, void* stream) {
  if (n_pairs > 0) {
    dense_kernel<<<blocks_for(n_pairs), kDenseThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        orig, dir, cap, cluster, reinterpret_cast<const float4*>(mot), base,
        n_pairs, t_out, tri_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
