// The first-generation ("v1") closest-hit traversal of the packed 8-wide
// BVH for Hopper (sm_90a): one ray per group of 8 lanes (an octet), four
// rays a warp, persistent blocks, as octet_kernel of bvh_traverse.cu.
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
// hit as it stood at the pop; this kernel, like its plain version
// (trace/traverse_v1.py), tests each child against the best hit as it
// stands at that child's slot, which a leaf of a lower slot may just have
// improved. Entering more boxes changes no result, so the outputs are the
// same.
//
// The walk is the serial one, step for step; only the schedule is the
// octet's (the header of bvh_traverse.cu says what each element of it
// does on this card, and why a thread per ray lost to it on rays in no
// order, which are four of the traversal study's six sets):
// - Node step. Lane c reads child c of the popped node (row[c], row[8 + c]
//   .. row[40 + c], the id row[48 + c]: 7 coalesced loads an octet) and
//   runs its slab test against the best hit at the pop.
// - Leaves. The entered leaf children are taken in slot order; each is
//   culled again against the best hit as it stands (the serial walk's
//   rule), then lane k tests triangle k from its 9 floats. The octet takes
//   the least t below best by three xor shuffles of its bits and the
//   lowest k at that t from a ballot (the serial walk's first triangle at
//   the least t).
// - Inner children. As the leaf loop passes an inner child's slot, its
//   lane keeps the best hit as it stands then (cap): the best the serial
//   walk tests that child against. After the leaves the children with
//   entry t < cap are pushed in slot order, each at sp plus the count of
//   pushed children of lower slots (a popcount of a ballot), so the
//   highest slot pops first. Culling them against the best after all the
//   node's leaves instead would enter fewer boxes, but a box whose slab
//   entry rounds a few ulps beyond the hit inside it (a flat box in the
//   plane of its triangles) could then lose a hit the serial walk keeps.
// - Stack: ids only, one per octet in shared memory, stack_entries
//   entries (traverse.stack_need of the tree, at most kStackDepthV1 = 96,
//   the TPU kernel's depth). A push past it is dropped, as on the TPU and
//   in the plain version, and counted in *overflow; the callers require 0.
// - Persistent blocks draw 8-ray tickets from a counter the wrapper
//   zeroes (draw_ticket of bvh_common.cuh); dead rays get their miss at
//   the draw.
// On an NVIDIA H100 80GB HBM3 at 700 W, the traversal study's six sets of
// 921,600 "shadertoy" rays (primary, bounce, shadow; unsorted and sorted
// by octant and origin) took 4.632 ms against 13.922 ms for the thread
// per ray this kernel replaced: bounce 1.193 against 5.053 ms unsorted,
// shadow 0.899 against 3.616, the raster-ordered primary rays 0.219
// against 0.227 (40 registers, 32 B of stack).
//
// Arithmetic: built with --fmad=false; the cross and dot products are
// written out term by term in the order of the plain PyTorch version
// (trace/traverse_v1.py: closest_hit_v1_plain), so both round alike and
// the outputs are equal bit for bit.

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

// Shared memory: kOctets stacks of stack_entries node ids. Every shuffle,
// ballot and __syncwarp below is reached by all 32 lanes of the warp (the
// octet schedule of bvh_common.cuh).
__global__ void __launch_bounds__(kOctThreads, kBlocksPerSM)
traverse_v1_octets(const float* __restrict__ orig,
                   const float* __restrict__ dir,
                   const float* __restrict__ t_max,
                   const int32_t* __restrict__ nodes,
                   const float* __restrict__ tris, int n_rays,
                   int stack_entries, float* __restrict__ t_out,
                   int32_t* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out,
                   unsigned int* __restrict__ next_ray,
                   unsigned int* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  const int sub = threadIdx.x & (kOctet - 1);   // the lane in its octet
  const int shift = threadIdx.x & 24;           // the octet's first lane
  int32_t* stack = smem + (threadIdx.x / kOctet) * stack_entries;
  const unsigned int n = static_cast<unsigned int>(n_rays);

  Ticket tk;
  bool walking = false;
  Ray ray;
  int i = 0, sp = 0;
  float best = 0.f, best_u = 0.f, best_v = 0.f;
  int32_t best_tri = -1;

  for (;;) {
    // 1. Draw; dead rays get their miss here.
    const bool idle = !walking && tk.todo == 0u && !tk.drained;
    draw_ticket(tk, idle, sub, shift, t_max, n, next_ray,
                [&](unsigned int mine) {
                  t_out[mine] = kBig;
                  tri_out[mine] = -1;
                  u_out[mine] = 0.f;
                  v_out[mine] = 0.f;
                });
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
      sp = 1;
      if (sub == 0) stack[0] = 0;
      walking = true;
    }
    __syncwarp();

    // 3. Node step: pop; lane c tests child c against the best at the pop.
    int32_t cid = kInvalid;
    float t_near = 0.f;
    bool enter = false;
    if (walking) {
      --sp;
      const int32_t* __restrict__ row =
          nodes + static_cast<size_t>(stack[sp]) * kRow;
      cid = row[48 + sub];
      float t_far;
      child_slab(row, sub, ray, t_near, t_far);
      enter = cid != kInvalid && t_far >= fmaxf(t_near, 0.f) &&
              t_near < best;
    }
    __syncwarp();   // the popped slot is read before a push lands on it
    const unsigned int inner =
        octet_bits(__ballot_sync(kFull, enter && cid >= 0), shift);
    unsigned int leaf =
        octet_bits(__ballot_sync(kFull, enter && cid < 0), shift);

    // 4. Leaves in slot order, lane k testing triangle k. cap: the best
    // hit as the loop passes this lane's slot.
    float cap = best;
    bool capped = false;
    while (__any_sync(kFull, leaf != 0u)) {
      const int s = leaf != 0u ? __ffs(leaf) - 1 : kOctet;
      if (!capped && sub < s) {
        cap = best;
        capped = true;
      }
      const float leaf_t = __shfl_sync(kFull, t_near, s & (kOctet - 1),
                                       kOctet);
      const int32_t cluster =
          -__shfl_sync(kFull, cid, s & (kOctet - 1), kOctet) - 1;
      const bool test = leaf != 0u && leaf_t < best;
      leaf &= leaf - 1u;
      float t = 0.f, u = 0.f, v = 0.f;
      bool ok = false;
      if (test) {
        ok = mt_test(tris + static_cast<size_t>(cluster) * kRow +
                         kTriFloats * sub,
                     ray, t, u, v);
      }
      // The least t below best, the lowest k at equal t. An accepted t is
      // above 1e-5, and the bits of positive floats order as the floats.
      const unsigned int key = (ok && t < best) ? __float_as_uint(t) : kNoHit;
      unsigned int least = key;
#pragma unroll
      for (int d = kOctet / 2; d > 0; d >>= 1) {
        least = min(least, __shfl_xor_sync(kFull, least, d, kOctet));
      }
      const int k =
          __ffs(octet_bits(__ballot_sync(kFull, key == least), shift)) - 1;
      const float hit_u = __shfl_sync(kFull, u, k, kOctet);
      const float hit_v = __shfl_sync(kFull, v, k, kOctet);
      if (least != kNoHit) {
        best = __uint_as_float(least);
        best_tri = cluster * kLeaf + k;
        best_u = hit_u;
        best_v = hit_v;
      }
    }
    if (!capped) cap = best;

    // 5. Push the inner children that pass their slot's cull, slot order.
    const bool push = ((inner >> sub) & 1u) && t_near < cap;
    const unsigned int pushed = octet_bits(__ballot_sync(kFull, push), shift);
    if (push) {
      const int slot = sp + __popc(pushed & ((1u << sub) - 1u));
      if (slot < stack_entries) {
        stack[slot] = cid;
      } else {
        atomicAdd(overflow, 1u);
      }
    }
    sp = min(sp + __popc(pushed), stack_entries);
    __syncwarp();

    // 6. The ray ends with an empty stack.
    if (walking && sp == 0) {
      if (sub == 0) {
        t_out[i] = best_tri < 0 ? kBig : best;
        tri_out[i] = best_tri;
        u_out[i] = best_u;
        v_out[i] = best_v;
      }
      walking = false;
    }
  }
}

}  // namespace

// The host side needs nvcc's launch syntax; a host compiler (the test that
// runs the kernel above on host threads) stops here.
#ifdef __CUDACC__

// stack_entries: the entries of each ray's stack (what the tree can ask
// for, at most kStackDepthV1); next_ray: one zeroed counter.
extern "C" int tb_closest_hit_v1(const float* orig, const float* dir,
                                 const float* t_max, const int32_t* nodes,
                                 const float* tris, int n_rays,
                                 int stack_entries, float* t_out,
                                 int32_t* tri_out, float* u_out, float* v_out,
                                 unsigned int* next_ray,
                                 unsigned int* overflow, void* stream) {
  if (stack_entries > kStackDepthV1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(
      traverse_v1_octets, kOctThreads,
      static_cast<size_t>(kOctets) * stack_entries * sizeof(int32_t), n_rays,
      kOctThreads, stream, orig, dir, t_max, nodes, tris, n_rays,
      stack_entries, t_out, tri_out, u_out, v_out, next_ray, overflow);
}

#endif  // __CUDACC__
