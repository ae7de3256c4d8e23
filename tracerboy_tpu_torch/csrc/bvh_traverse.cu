// Closest-hit and any-hit traversal of the packed 8-wide BVH for Hopper
// (sm_90a): one ray per group of 8 lanes (an octet), four rays a warp,
// persistent blocks. Beside them, the traversal-cost (stats) kernel, one
// thread per ray.
//
// Replaces: tracerboy_tpu/trace/pallas_traverse2.py: traverse_packets2 and
// anyhit_packets2 (both built by _make_kernel, with _node_children and
// _tri_tests). The TPU kernel walks 2048-ray packets that share one stack
// and enter a node if any ray wants it; here each ray has its own stack.
// The outputs are the contract, not the schedule: the same tables
// (trace/traverse.py documents the row layouts), the same slab and
// Baldwin-Weber arithmetic, the same acceptance rules, the same outputs.
//
// What bounds the walk on this card: the chain of dependent loads and warp
// collectives of each step, not bytes or operations. Every pop is a
// dependent load of a 512-byte row, and rays in no order want different
// rows. The kernel this one replaced ran one thread per ray: 56 scalar
// loads a node and 96 a cluster on one dependent chain, each load
// instruction touching up to 32 rows where the lanes of a warp sat on
// different nodes, a lane that met a leaf holding the other 31, a
// 768-byte stack a thread in local memory, and a block of 128 rays
// retiring with its slowest ray. On an NVIDIA H100 80GB HBM3 at 700 W,
// 921,600 rays of the "shadertoy" scene: closest hit 0.338 ms on the
// raster-ordered primary wave and 3.893 ms on surface rays in no order
// (2.390 sorted by origin), any hit 0.667 ms on the primary's shadow wave
// and 2.473 ms in no order (0.527 sorted), with 40 registers / 832 B of
// stack and 32 / 464 B (40 B spilled); 1.5-3.8% of the bound the bytes and
// operations set; 12.0 + 6.2 ms for the six closest-hit and six any-hit
// launches of one 8-sample 1280x720 wave. The walks did the same pops and
// cluster tests in either order, so the loss
// was warp efficiency and cache locality. What each element of this
// design does about it:
//
// - Node step. The tree is 8 wide, so lane c of the octet reads child c
//   of the popped node (the six box floats row[c], row[8 + c], ..
//   row[40 + c] and the id row[48 + c]) and runs its slab test. Each of
//   the 7 load instructions reads one 32-byte sector per octet whatever
//   the other octets of the warp do, so the reads are coalesced at any
//   ray order, and octets on the same node share the sector. The enter
//   test is taken against the best hit as it stands at the pop (t_max for
//   any hit).
// - Order. Entered inner children are ranked by descending entry t from
//   one width-8 shuffle per entered child: a child's rank is the number
//   of entered inner children with a larger entry t, or an equal one and
//   a lower slot. Lane c writes (id, t) to stack[sp + rank], so the
//   nearest child is on top and, at equal t, the higher slot pops first
//   (the order the thread-per-ray walk's sorted insertion gave). No
//   insertion loop.
// - Leaves. A leaf holds 8 triangles. After the pushes the entered leaf
//   children are taken one at a time, nearest first (at equal t the
//   lower slot first), each culled again by entry t < best (closest
//   hit). Lane k tests triangle k from three 16-byte loads. The octet
//   reduces the bits of t to the least by three xor shuffles and takes
//   the lowest k at that t from a ballot; every lane keeps the same best
//   hit. Any hit: a ballot ends the ray. Every child of a node is tested
//   against the pop-time best, so the walk enters a few boxes the serial
//   one, whose earlier leaf slots already shrank best, does not; they are
//   culled at their pop, and the nearest-first leaves test fewer clusters
//   (trace/traverse.py octet_walk counts both).
// - Stack in shared memory, one per octet, stack_entries entries: an
//   (int32 id, float t) pair, or the id alone for any hit. The wrapper
//   sizes it from the tree: 7 entries a level plus one
//   (traverse.stack_need). A push past it is dropped and counted in
//   *overflow. At 12 blocks of 16 octets an SM and the 50 entries the
//   "shadertoy" tree needs that is 76.8 KB an SM for closest hit (the 100
//   KB carve-out, 156 KB of the SM's 256 KB left to L1) and 38.4 KB for
//   any hit (the 64 KB carve-out, 192 KB left to L1).
// - Persistent blocks. The grid is SMs x resident blocks an SM
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor). An octet whose rays
//   are done draws the next ticket from a device counter (one lane's
//   atomicAdd, broadcast by shuffle), in index order, so the coherence a
//   wave has is kept and no octet waits for a block's slowest ray. The
//   wrapper zeroes the counter; the kernel allocates nothing. A ticket is
//   8 rays: one atomic a ray on one address costs 0.22 ns, 1.6 ms for the
//   7,372,800 lanes of a wave's launch whatever its work, and lane j can
//   look at the ticket's ray j, so the dead lanes of a wave's late
//   bounces (most of their lanes) get their miss 8 at a time and cost no
//   walk. Four tickets in a row interleave over 32 rays in a row (ticket
//   b: rays 32 (b / 4) + b % 4 + 4 j), so the four octets of a warp,
//   which mostly draw together, walk neighbouring rays.
// - The four octets of a warp step through one loop together (draw, start
//   a ray, node step, leaves, end of ray), each doing in a phase what its
//   own state asks for. So every shuffle, ballot and __syncwarp is reached
//   by all 32 lanes and names the full warp: a shuffle of width 8 stays
//   inside its octet and a ballot is cut to the octet's 8 bits. An octet
//   waits for a warp-mate only inside one step, never for its ray to end.
//   (Octets that ran free of each other, each collective naming its own
//   8-lane mask, took the same time and 40% more instructions: a
//   run-time mask costs a MATCH, a REDUX and a divergent-path branch
//   around every shuffle and ballot, and octets out of step issue one at
//   a time anyway.) Outputs are written by lane 0 of the octet.
//
// Where a step's time goes (a copy of this kernel that read clock() between
// its phases, 921,600 surface rays in no order on the card above): of
// 6,490 cycles a lock-step iteration of a warp, the leaves take 2,280, the
// rank loop 1,447 (632 a turn of its 34 instructions), the node step
// 1,075, ray starts 776, the draw 466. Plain arithmetic runs at about 3
// cycles an instruction there, so the warps wait on loads, shuffles and
// votes, and a ray-step costs 0.10 ns whether the rays are in raster
// order or in none. Variants that issued fewer instructions, fewer
// shuffles or fewer cache lines a step, or held 8 or 10 blocks an SM, all
// ran within 3% of this one; see PERF.md for each.
//
// Per-ray roots (the TPU kernels' packet_roots option, which the
// binned-subtree path of trace/cut.py uses for its phase 2): with a roots
// array, ray i starts at roots[i] instead of node 0. A root >= 0 is a node
// whose children are tested as usual; a root < 0 is leaf cluster -root-1,
// whose 8 triangles are tested with no box test, as the TPU kernel queues
// such a cluster directly.
//
// Arithmetic: build with --fmad=false, so no a*b+c is contracted into an
// FMA and every value rounds as in the plain PyTorch twin
// (closest_hit_plain / anyhit_plain), which evaluates the same expressions
// in the same order. At equal t the octet walk and the twin may keep
// different triangles (the first found against the lowest id).
//
// Traversal cost (the TPU kernel's stats=True variant, which feeds the
// heatmap AOV): traverse_stats_kernel, launched by tb_closest_hit_stats,
// keeps the thread-per-ray walk, whose steps define its two int32 counts
// per ray (its twin closest_hit_stats_plain repeats that walk). The TPU
// counters are per 2048-ray packet and count batched leaf drains; here
// they are per ray, as the reference's TraverseFunction.hlsli:46-47 keeps
// them:
//   pops     = nodes the ray pops and expands (a node root counts; a
//              popped node that the pop-time cull skips does not);
//   clusters = leaf clusters whose 8 triangles the ray tests (a leaf root
//              counts).
// A dead lane (t_max <= 0) gives 0 and 0. Its hits equal the octet
// kernel's in t; at equal t the two walk orders may keep different
// triangles.

#include "bvh_common.cuh"

#include <algorithm>

using namespace tb;

namespace {

constexpr int kOctet = 8;          // lanes a ray
constexpr int kOctThreads = 128;   // 4 warps: 16 rays in flight a block
constexpr int kOctets = kOctThreads / kOctet;
constexpr int kBlocksPerSM = 12;   // 1,536 resident threads an SM
constexpr unsigned int kFull = 0xffffffffu;
constexpr unsigned int kNoHit = 0x7f800000u;   // +infinity's bits

// The 8 bits of a warp ballot that belong to the octet whose first lane is
// `shift`.
__device__ __forceinline__ unsigned int octet_bits(unsigned int ballot,
                                                   int shift) {
  return (ballot >> shift) & 0xffu;
}

// Shared memory: kOctets stacks of stack_entries entries, an int32 id (any
// hit) or an (id, entry t) pair (closest hit) each.
//
// The four octets of a warp run one loop in step: every shuffle, ballot and
// __syncwarp below is reached by all 32 lanes and names the full warp (a
// shuffle of width 8 stays inside its octet; a ballot is cut to the
// octet's 8 bits). What an octet does in a phase of the loop depends only on
// its own state, which is the same on its 8 lanes.
template <bool kAnyHit>
__global__ void __launch_bounds__(kOctThreads, kBlocksPerSM)
octet_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
             const float* __restrict__ t_max,
             const int32_t* __restrict__ nodes,
             const float* __restrict__ tris,
             const int32_t* __restrict__ roots, int n_rays, int stack_entries,
             float* __restrict__ t_out, int32_t* __restrict__ tri_out,
             float* __restrict__ u_out, float* __restrict__ v_out,
             bool* __restrict__ occ_out, unsigned int* __restrict__ next_ray,
             unsigned int* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  const int sub = threadIdx.x & (kOctet - 1);   // the lane in its octet
  const int shift = threadIdx.x & 24;           // the octet's first lane
  const int oct = threadIdx.x / kOctet;
  // The octet's stack: ids (any hit), or (id, entry t's bits) pairs.
  int32_t* stack_id = smem + oct * stack_entries;
  int2* stack = reinterpret_cast<int2*>(smem) + oct * stack_entries;
  const unsigned int n = static_cast<unsigned int>(n_rays);

  // The octet's ticket (ray j of it is first + 4 j; todo: its live rays
  // not yet walked) and the ray it walks.
  unsigned int first = 0u, todo = 0u;
  bool drained = false;      // the counter is past the rays
  bool walking = false;
  Ray ray;
  int i = 0, sp = 0;
  int32_t root_leaf = 0;     // a leaf root (negative) still to be tested
  float best = 0.f, best_u = 0.f, best_v = 0.f;
  int32_t best_tri = -1;
  bool occluded = false;

  for (;;) {
    // 1. An octet whose ticket is used up draws the next one. Ticket b
    // stands for the 8 rays 32 (b / 4) + b % 4 + 4 j, j = 0..7: four
    // tickets in a row interleave over 32 rays in a row, so the octets of a
    // warp, which mostly draw together, walk neighbouring rays. Lane j looks
    // at the ticket's ray j: dead lanes (t_max <= 0, or NaN) get their miss
    // here, 8 at a time, and are never walked.
    const bool idle = !walking && todo == 0u && !drained;
    if (__any_sync(kFull, idle)) {
      unsigned int ticket = 0u;
      if (idle && sub == 0) ticket = atomicAdd(next_ray, 1u);
      ticket = __shfl_sync(kFull, ticket, 0, kOctet);
      bool live = false;
      if (idle) {
        first = (ticket >> 2) * 32u + (ticket & 3u);
        drained = (ticket >> 2) * 32u >= n;
        const unsigned int mine = first + 4u * sub;
        if (!drained && mine < n) {
          live = t_max[mine] > 0.f;
          if (!live) {
            if (kAnyHit) {
              occ_out[mine] = false;
            } else {
              t_out[mine] = kBig;
              tri_out[mine] = -1;
              u_out[mine] = 0.f;
              v_out[mine] = 0.f;
            }
          }
        }
      }
      const unsigned int lives = octet_bits(__ballot_sync(kFull, live), shift);
      if (idle) todo = lives;
    }
    // The counter only grows: once a draw is past the rays, so is every
    // later one.
    if (__all_sync(kFull, drained && !walking && todo == 0u)) return;

    // 2. An octet without a ray starts the next live ray of its ticket.
    if (!walking && todo != 0u) {
      i = static_cast<int>(first) + 4 * (__ffs(todo) - 1);
      todo &= todo - 1u;
      ray = load_ray(orig, dir, t_max, i);
      best = ray.t_max;
      best_tri = -1;
      best_u = 0.f;
      best_v = 0.f;
      occluded = false;
      const int32_t root = roots != nullptr ? roots[i] : 0;
      root_leaf = root < 0 ? root : 0;
      sp = root >= 0 ? 1 : 0;
      if (root >= 0 && sub == 0) {
        if (kAnyHit) {
          stack_id[0] = root;
        } else {
          stack[0] = make_int2(root, __float_as_int(-kBig));
        }
      }
      walking = true;
    }
    __syncwarp();

    // 3. Node step: pop one node; lane c tests child c against the best hit
    // as it stands now (t_max for any hit). A leaf root takes the place of
    // the pop once: lane 0 holds it as an entered leaf child.
    int32_t cid = kInvalid;
    float t_near = 0.f;
    bool enter = false;
    if (walking) {
      if (root_leaf < 0) {
        if (sub == 0) {
          cid = root_leaf;
          t_near = -kBig;
          enter = true;
        }
        root_leaf = 0;
      } else if (sp > 0) {
        --sp;
        int2 top;
        if (kAnyHit) {
          top = make_int2(stack_id[sp], 0);
        } else {
          top = stack[sp];
        }
        if (kAnyHit || __int_as_float(top.y) < best) {   // the pop-time cull
          const int32_t* __restrict__ row =
              nodes + static_cast<size_t>(top.x) * kRow;
          cid = row[48 + sub];
          float t_far;
          child_slab(row, sub, ray, t_near, t_far);
          const float t_cap = kAnyHit ? ray.t_max : best;
          enter = cid != kInvalid && t_far >= fmaxf(t_near, 0.f) &&
                  t_near < t_cap;
        }
      }
    }
    __syncwarp();   // every popped slot is read before a push lands on it
    const unsigned int inner =
        octet_bits(__ballot_sync(kFull, enter && cid >= 0), shift);
    unsigned int leaf =
        octet_bits(__ballot_sync(kFull, enter && cid < 0), shift);

    // Order. rank: the entered inner children that go below this one on
    // the stack (a larger entry t, or an equal one and a lower slot).
    // leaf_rank: the entered leaf children tested before this one (a
    // smaller entry t, or an equal one and a lower slot). One shuffle per
    // entered child; fewer than two need no order.
    int rank = 0, leaf_rank = 0;
    unsigned int rest = inner | leaf;
    if (!(rest & (rest - 1u))) rest = 0u;
    while (__any_sync(kFull, rest != 0u)) {
      const int j = rest != 0u ? __ffs(rest) - 1 : 0;
      const float tj = __shfl_sync(kFull, t_near, j, kOctet);
      if (rest != 0u) {
        const bool tie_low = tj == t_near && j < sub;
        if ((inner >> j) & 1u) {
          rank += tj > t_near || tie_low;
        } else {
          leaf_rank += tj < t_near || tie_low;
        }
        rest &= rest - 1u;
      }
    }
    if ((inner >> sub) & 1u) {
      const int slot = sp + rank;
      if (slot < stack_entries) {
        if (kAnyHit) {
          stack_id[slot] = cid;
        } else {
          stack[slot] = make_int2(cid, __float_as_int(t_near));
        }
      } else {
        atomicAdd(overflow, 1u);
      }
    }
    sp = min(sp + __popc(inner), stack_entries);
    __syncwarp();

    // 4. Leaves, nearest first, lane k testing triangle k.
    for (int q = 0; __any_sync(kFull, leaf != 0u); ++q) {
      const unsigned int pick = octet_bits(
          __ballot_sync(kFull, ((leaf >> sub) & 1u) && leaf_rank == q), shift);
      const int src = pick != 0u ? __ffs(pick) - 1 : 0;
      const float leaf_t = __shfl_sync(kFull, t_near, src, kOctet);
      const int32_t cluster = -__shfl_sync(kFull, cid, src, kOctet) - 1;
      leaf &= ~pick;
      bool test = pick != 0u;
      if (!kAnyHit && test && !(leaf_t < best)) {
        // Once a leaf's box starts at or beyond the best hit, so do the
        // rest of this node's.
        test = false;
        leaf = 0u;
      }
      float t = 0.f, u = 0.f, v = 0.f;
      bool ok = false;
      if (test) {
        const float4* __restrict__ p = reinterpret_cast<const float4*>(
            tris + static_cast<size_t>(cluster) * kRow + 12 * sub);
        const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
        const float r[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                             b.z, b.w, c.x, c.y, c.z, c.w};
        ok = bw_test(r, ray, t, u, v);
      }
      if (kAnyHit) {
        if (octet_bits(__ballot_sync(kFull, ok && t < ray.t_max), shift)) {
          occluded = true;
          leaf = 0u;
        }
      } else {
        // The least t below best, the lowest k at equal t. An accepted t is
        // above 1e-5, and the bits of positive floats order as the floats.
        const unsigned int key =
            (ok && t < best) ? __float_as_uint(t) : kNoHit;
        unsigned int least = key;
#pragma unroll
        for (int s = kOctet / 2; s > 0; s >>= 1) {
          least = min(least, __shfl_xor_sync(kFull, least, s, kOctet));
        }
        const int k = __ffs(octet_bits(
            __ballot_sync(kFull, key == least), shift)) - 1;
        const float hit_u = __shfl_sync(kFull, u, k, kOctet);
        const float hit_v = __shfl_sync(kFull, v, k, kOctet);
        if (least != kNoHit) {
          best = __uint_as_float(least);
          best_tri = cluster * kLeaf + k;
          best_u = hit_u;
          best_v = hit_v;
        }
      }
    }

    // 5. The ray ends with an empty stack, or occluded.
    if (walking && (sp == 0 || occluded)) {
      if (sub == 0) {
        if (kAnyHit) {
          occ_out[i] = occluded;
        } else {
          t_out[i] = best_tri < 0 ? kBig : best;
          tri_out[i] = best_tri;
          u_out[i] = best_u;
          v_out[i] = best_v;
        }
      }
      walking = false;
    }
  }
}

// The 8 triangles of one cluster against the ray, in order: the first
// triangle at the least t below best wins.
__device__ __forceinline__ void test_cluster(const float* __restrict__ tris,
                                             int32_t cluster, const Ray& ray,
                                             float& best, int32_t& best_tri,
                                             float& best_u, float& best_v) {
  const float* __restrict__ trow = tris + static_cast<size_t>(cluster) * kRow;
#pragma unroll
  for (int k = 0; k < kLeaf; ++k) {
    float t, u, v;
    if (bw_test(trow + 12 * k, ray, t, u, v) && t < best) {
      best = t;
      best_tri = cluster * kLeaf + k;
      best_u = u;
      best_v = v;
    }
  }
}

// Closest hit from node 0 with the per-ray traversal cost: one thread per
// ray, a kStackDepth-entry stack in local memory, children pushed sorted
// by descending entry t (a later child above an equal one), the cull
// !(entry t < best) at the pop, leaf clusters tested as they are met.
__global__ void __launch_bounds__(kThreads)
traverse_stats_kernel(const float* __restrict__ orig,
                      const float* __restrict__ dir,
                      const float* __restrict__ t_max,
                      const int32_t* __restrict__ nodes,
                      const float* __restrict__ tris, int n_rays,
                      float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      unsigned int* __restrict__ overflow,
                      int32_t* __restrict__ pops_out,
                      int32_t* __restrict__ clusters_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray ray = load_ray(orig, dir, t_max, i);

  float best = ray.t_max;
  int32_t best_tri = -1;
  float best_u = 0.f, best_v = 0.f;
  int32_t pops = 0, clusters = 0;

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
    if (!(stack_t[sp] < best)) continue;
    ++pops;
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
      if (!(t_far >= fmaxf(t_near, 0.f) && t_near < best)) continue;
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
      test_cluster(tris, -cid - 1, ray, best, best_tri, best_u, best_v);
      ++clusters;
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

  t_out[i] = best_tri < 0 ? kBig : best;
  tri_out[i] = best_tri;
  u_out[i] = best_u;
  v_out[i] = best_v;
  pops_out[i] = pops;
  clusters_out[i] = clusters;
}

}  // namespace

// The host side needs nvcc's launch syntax; a host compiler (the test that
// runs the kernels above on host threads) stops here.
#ifdef __CUDACC__

namespace {

// Launch octet_kernel<kAnyHit> on as many blocks as the card holds at
// once (fewer where the rays do not fill them).
template <bool kAnyHit>
int launch_octets(const float* orig, const float* dir, const float* t_max,
                  const int32_t* nodes, const float* tris,
                  const int32_t* roots, int n_rays, int stack_entries,
                  float* t_out, int32_t* tri_out, float* u_out, float* v_out,
                  bool* occ_out, unsigned int* next_ray,
                  unsigned int* overflow, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const size_t shared = static_cast<size_t>(kOctets) * stack_entries *
                        (kAnyHit ? sizeof(int32_t)
                                 : sizeof(int32_t) + sizeof(float));
  int device = 0, sms = 0, blocks_per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, octet_kernel<kAnyHit>, kOctThreads, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rays_per_block = kOctets * kOctet;
  const int blocks = std::min(sms * blocks_per_sm,
                              (n_rays + rays_per_block - 1) / rays_per_block);
  octet_kernel<kAnyHit>
      <<<blocks, kOctThreads, shared, static_cast<cudaStream_t>(stream)>>>(
          orig, dir, t_max, nodes, tris, roots, n_rays, stack_entries, t_out,
          tri_out, u_out, v_out, occ_out, next_ray, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// roots may be null (every ray starts at node 0). stack_entries: the
// entries of each ray's stack (what the tree can ask for); next_ray: one
// zeroed counter.
extern "C" int tb_closest_hit(const float* orig, const float* dir,
                              const float* t_max, const int32_t* nodes,
                              const float* tris, const int32_t* roots,
                              int n_rays, int stack_entries, float* t_out,
                              int32_t* tri_out, float* u_out, float* v_out,
                              unsigned int* next_ray, unsigned int* overflow,
                              void* stream) {
  return launch_octets<false>(orig, dir, t_max, nodes, tris, roots, n_rays,
                              stack_entries, t_out, tri_out, u_out, v_out,
                              nullptr, next_ray, overflow, stream);
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
    traverse_stats_kernel
        <<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            orig, dir, t_max, nodes, tris, n_rays, t_out, tri_out, u_out,
            v_out, overflow, pops_out, clusters_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tb_any_hit(const float* orig, const float* dir,
                          const float* t_max, const int32_t* nodes,
                          const float* tris, const int32_t* roots, int n_rays,
                          int stack_entries, bool* occ_out,
                          unsigned int* next_ray, unsigned int* overflow,
                          void* stream) {
  return launch_octets<true>(orig, dir, t_max, nodes, tris, roots, n_rays,
                             stack_entries, nullptr, nullptr, nullptr, nullptr,
                             occ_out, next_ray, overflow, stream);
}

#endif  // __CUDACC__
