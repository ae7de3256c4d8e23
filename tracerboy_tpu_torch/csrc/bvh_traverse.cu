// Closest-hit and any-hit traversal of the packed 8-wide BVH for Hopper
// (sm_90a): one ray per group of 8 lanes (an octet), four rays a warp,
// persistent blocks. Beside them, the traversal-cost (stats) kernel, one
// thread per ray in persistent warps.
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
// heatmap AOV): the closest hit from node 0 with two int32 counts per ray.
// The TPU counters are per 2048-ray packet and count batched leaf drains;
// here they are per ray, as the reference's TraverseFunction.hlsli:46-47
// keeps them, and they are the counts of the serial walk (its twin
// closest_hit_stats_plain repeats that walk step for step): a per-ray
// stack of (id, entry t), children pushed sorted by descending entry t (a
// later slot above an equal one), the cull !(entry t < best) at the pop,
// leaf clusters tested as they are met, in slot order, each child culled
// against the best hit as it stands at its slot:
//   pops     = nodes the ray pops and expands (a popped node that the
//              pop-time cull skips does not count);
//   clusters = leaf clusters whose 8 triangles the ray tests.
// A dead lane (t_max <= 0) gives 0 and 0. Its hits equal the octet
// kernel's in t; at equal t the two walk orders may keep different
// triangles.
//
// The one launch a render gives it is the HEATMAP view's primary wave
// (trace/wavefront.py), in raster order, where a thread per ray walks
// faster than octets (0.07 against 0.10 ns a ray-step, PERF.md). So
// traverse_stats_kernel (tb_closest_hit_stats) keeps a thread per ray and
// drops what held the first one back:
// - Persistent warps. A warp draws 32 rays in a row (one lane's atomicAdd,
//   broadcast), in index order, so the raster coherence of the wave is
//   kept, and draws again when its 32 are done: no block waits for its
//   slowest warp. A dead lane writes its miss at once.
// - The stack, (id, entry t) in one int2 array: its top kTop = 8 entries
//   in shared memory (a window of the stack, entry k in slot k % kTop of
//   the thread's column, so the lanes of a warp hit distinct banks), the
//   entries below it in local memory, moved there only when a push would
//   overflow the window. The wrapper sizes the stack by
//   traverse.stack_need, at most kStackDepth (the twin's STACK_DEPTH); a
//   push past it is dropped and counted in *overflow.
// - Inner children are inserted into the window as they come, sorted by
//   entry t: no staging arrays, which the first kernel kept in local
//   memory (they were indexed at run time). Ranking them in registers
//   instead took 100 registers a thread.
// - 16-byte loads: a node's children four at a time (7 int4 a group), a
//   cluster's triangle rows three float4 each.
// - 10 blocks of 128 an SM, at most 48 registers a thread. Occupancy is
//   what this walk lives on: on the card above, the two launches of a
//   HEATMAP render_sample(1) and render_sample(8) took 2.269 ms at 10
//   blocks an SM against the first kernel's 2.527 ms, 2.368 at 12 (40
//   registers, 200 B spilled) and 2.593 at 8 (64 registers); a 16-entry
//   window 1.6% more than an 8-entry one (less L1 left).
// The same serial walk on octets (octet_kernel with leaves in slot order,
// each culled again at its turn; it pushes children the serial walk culls
// at their slot, which are culled at their pop and not counted, so the
// outputs and counts were the same) took 4.09 ms on those two launches,
// and 1.27 ms against the thread per ray's 3.27 on 921,600 bounce rays in
// no order, which no render gives this kernel.

#include "bvh_common.cuh"

using namespace tb;

namespace {

constexpr int kStatsThreads = 128;   // 4 persistent warps a block
constexpr int kTop = 8;   // stack entries a ray keeps in shared memory
constexpr int kStatsBlocksPerSM = 10;   // at most 48 registers a thread

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

  Ticket tk;                 // the octet's rays
  bool walking = false;
  Ray ray;
  int i = 0, sp = 0;
  int32_t root_leaf = 0;     // a leaf root (negative) still to be tested
  float best = 0.f, best_u = 0.f, best_v = 0.f;
  int32_t best_tri = -1;
  bool occluded = false;

  for (;;) {
    // 1. An octet whose ticket is used up draws the next one; its dead
    // rays get their miss here, 8 at a time, and are never walked.
    const bool idle = !walking && tk.todo == 0u && !tk.drained;
    draw_ticket(tk, idle, sub, shift, t_max, n, next_ray,
                [&](unsigned int mine) {
                  if (kAnyHit) {
                    occ_out[mine] = false;
                  } else {
                    t_out[mine] = kBig;
                    tri_out[mine] = -1;
                    u_out[mine] = 0.f;
                    v_out[mine] = 0.f;
                  }
                });
    // The counter only grows: once a draw is past the rays, so is every
    // later one.
    if (__all_sync(kFull, tk.drained && !walking && tk.todo == 0u)) return;

    // 2. An octet without a ray starts the next live ray of its ticket.
    if (!walking && tk.todo != 0u) {
      i = static_cast<int>(tk.first) + 4 * (__ffs(tk.todo) - 1);
      tk.todo &= tk.todo - 1u;
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

// The 8 triangles of one cluster against the ray, in order (three 16-byte
// loads each): the first triangle at the least t below best wins.
__device__ __forceinline__ void test_cluster(const float* __restrict__ tris,
                                             int32_t cluster, const Ray& ray,
                                             float& best, int32_t& best_tri,
                                             float& best_u, float& best_v) {
  const float4* __restrict__ trow = reinterpret_cast<const float4*>(
      tris + static_cast<size_t>(cluster) * kRow);
#pragma unroll
  for (int k = 0; k < kLeaf; ++k) {
    const float4 a = __ldg(trow + 3 * k), b = __ldg(trow + 3 * k + 1),
                 c = __ldg(trow + 3 * k + 2);
    const float r[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
    float t, u, v;
    if (bw_test(r, ray, t, u, v) && t < best) {
      best = t;
      best_tri = cluster * kLeaf + k;
      best_u = u;
      best_v = v;
    }
  }
}

// Component j (a compile-time constant once unrolled) of an int4.
__device__ __forceinline__ int32_t part(const int4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// The stats walk, one thread per ray, in persistent warps (see the
// header). Warps draw 32 rays in a row from *next_ray.
__global__ void __launch_bounds__(kStatsThreads, kStatsBlocksPerSM)
traverse_stats_kernel(const float* __restrict__ orig,
                      const float* __restrict__ dir,
                      const float* __restrict__ t_max,
                      const int32_t* __restrict__ nodes,
                      const float* __restrict__ tris, int n_rays,
                      int stack_entries, float* __restrict__ t_out,
                      int32_t* __restrict__ tri_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int32_t* __restrict__ pops_out,
                      int32_t* __restrict__ clusters_out,
                      unsigned int* __restrict__ next_ray,
                      unsigned int* __restrict__ overflow) {
  // The stack's window: entry k of thread x in top[k % kTop][x], so the
  // lanes of a warp hit distinct banks whatever their depths.
  __shared__ int2 top[kTop][kStatsThreads];
  int2 deep[kStackDepth];    // the entries below the window
  const int x = threadIdx.x;
  const unsigned int n = static_cast<unsigned int>(n_rays);
  for (;;) {
    unsigned int ticket = 0u;
    if ((x & 31) == 0) ticket = atomicAdd(next_ray, 1u);
    ticket = __shfl_sync(kFull, ticket, 0);
    if (ticket * 32u >= n) return;
    const unsigned int i = ticket * 32u + (x & 31);
    if (i >= n) continue;
    const Ray ray = load_ray(orig, dir, t_max, static_cast<int>(i));
    float best = ray.t_max, best_u = 0.f, best_v = 0.f;
    int32_t best_tri = -1, pops = 0, clusters = 0;
    // The stack holds entries [0, sp): [low, sp) in the window, [0, low)
    // in deep. A dead lane (t_max <= 0, or NaN) starts empty: a miss.
    int sp = 0, low = 0;
    if (ray.t_max > 0.f) {
      top[0][x] = make_int2(0, __float_as_int(-kBig));
      sp = 1;
    }
    while (sp > 0) {
      --sp;
      int2 e;
      if (sp < low) {
        e = deep[sp];
        low = sp;
      } else {
        e = top[sp & (kTop - 1)][x];
      }
      if (!(__int_as_float(e.y) < best)) continue;   // the pop-time cull
      ++pops;
      const int4* __restrict__ row =
          reinterpret_cast<const int4*>(nodes + static_cast<size_t>(e.x) * kRow);
      // The node's entered inner children go to entries sp .. end - 1,
      // sorted by descending entry t as they come (a later child above
      // an equal one), so the nearest pops first. Children four at a
      // time: lox of children 4g..4g+3 is int4 g of the row, loy int4
      // 2 + g, .. hiz 10 + g, the ids 12 + g.
      int end = sp;
#pragma unroll
      for (int c = 0; c < kLeaf; ++c) {
        const int g = c / 4, j = c % 4;
        const int32_t cid = part(__ldg(row + 12 + g), j);
        if (cid == kInvalid) continue;
        float t_near, t_far;
        box_slab(part(__ldg(row + g), j), part(__ldg(row + 2 + g), j),
                 part(__ldg(row + 4 + g), j), part(__ldg(row + 6 + g), j),
                 part(__ldg(row + 8 + g), j), part(__ldg(row + 10 + g), j),
                 ray, t_near, t_far);
        if (!(t_far >= fmaxf(t_near, 0.f) && t_near < best)) continue;
        if (cid < 0) {
          test_cluster(tris, -cid - 1, ray, best, best_tri, best_u, best_v);
          ++clusters;
          continue;
        }
        if (end + 1 - low > kTop) {   // make room in the window
          deep[low] = top[low & (kTop - 1)][x];
          ++low;
        }
        int k = end++;
        for (; k > sp; --k) {
          const int2 below = top[(k - 1) & (kTop - 1)][x];
          if (!(__int_as_float(below.y) < t_near)) break;
          top[k & (kTop - 1)][x] = below;
        }
        top[k & (kTop - 1)][x] = make_int2(cid, __float_as_int(t_near));
      }
      // Entries past the stack are dropped (the nearest: the serial walk
      // pushes farthest first) and counted.
      if (end > stack_entries) {
        atomicAdd(overflow, static_cast<unsigned int>(end - stack_entries));
        end = stack_entries;
      }
      sp = end;
    }
    t_out[i] = best_tri < 0 ? kBig : best;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
    pops_out[i] = pops;
    clusters_out[i] = clusters;
  }
}

}  // namespace

// The host side needs nvcc's launch syntax; a host compiler (the test that
// runs the kernels above on host threads) stops here.
#ifdef __CUDACC__

namespace {

size_t octet_shared(int stack_entries, size_t entry) {
  return static_cast<size_t>(kOctets) * stack_entries * entry;
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
  return launch_persistent(
      octet_kernel<false>, kOctThreads,
      octet_shared(stack_entries, sizeof(int2)), n_rays, kOctThreads, stream,
      orig, dir, t_max, nodes, tris, roots, n_rays, stack_entries, t_out,
      tri_out, u_out, v_out, nullptr, next_ray, overflow);
}

// Closest hit from node 0 with the per-ray traversal cost (pops_out,
// clusters_out: int32 per ray), a thread per ray. stack_entries: at most
// kStackDepth.
extern "C" int tb_closest_hit_stats(const float* orig, const float* dir,
                                    const float* t_max, const int32_t* nodes,
                                    const float* tris, int n_rays,
                                    int stack_entries, float* t_out,
                                    int32_t* tri_out, float* u_out,
                                    float* v_out, int32_t* pops_out,
                                    int32_t* clusters_out,
                                    unsigned int* next_ray,
                                    unsigned int* overflow, void* stream) {
  if (stack_entries > kStackDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(traverse_stats_kernel, kStatsThreads, 0, n_rays,
                           kStatsThreads, stream, orig, dir, t_max, nodes,
                           tris, n_rays, stack_entries, t_out, tri_out, u_out,
                           v_out, pops_out, clusters_out, next_ray, overflow);
}

extern "C" int tb_any_hit(const float* orig, const float* dir,
                          const float* t_max, const int32_t* nodes,
                          const float* tris, const int32_t* roots, int n_rays,
                          int stack_entries, bool* occ_out,
                          unsigned int* next_ray, unsigned int* overflow,
                          void* stream) {
  return launch_persistent(
      octet_kernel<true>, kOctThreads,
      octet_shared(stack_entries, sizeof(int32_t)), n_rays, kOctThreads,
      stream, orig, dir, t_max, nodes, tris, roots, n_rays, stack_entries,
      nullptr, nullptr, nullptr, nullptr, occ_out, next_ray, overflow);
}

#endif  // __CUDACC__
