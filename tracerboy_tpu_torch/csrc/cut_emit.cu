// Phase 1 of the binned-subtree ("cut") traversal: the cut subtrees each
// ray enters, one thread per ray, for Hopper (sm_90a).
//
// Replaces: tracerboy_tpu/trace/pallas_traverse2.py: emit_packets2 (body
// _make_emit_kernel). The walk runs over the cut's top table
// (trace/cut.py::build_cut), where every child whose subtree holds at most
// cut_tris triangles is an EMIT: a negative id -cut-1. A ray appends the
// cut index of every emit child whose box it enters within (0, t_max); it
// descends only the internal children it enters itself (the TPU kernel
// descends a node if any ray of its 2048-ray packet enters it; the boxes
// nest, so the emitted sets agree but for slab rounding at a shared face).
//   - Dead rays (t_max <= 0 or NaN) emit nothing.
//   - Slots the ray does not fill hold -1.
//   - A ray with more than K emits holds n_cuts in slot K-1: the
//     whole-tree root, so phase 2 traverses the whole tree for it.
// Nothing tightens t here, so the emitted set does not depend on the visit
// order; the slot order does. Children are pushed in slot order and the
// last pushed pops first, as in the TPU kernel, and emits are appended in
// slot order when their node pops, which the plain twin
// (trace/cut.py::emit_cuts_plain) reproduces.
//
// The design. A render gives this kernel two launches a bounce, 921,600
// or 7,372,800 lanes each at 1280x720, most of them dead after the first
// bounce; a live ray walks 3-7 nodes of a table of a few dozen reachable
// rows (PERF.md, `bench_traverse --sets cut-wave`).
// - The table is the compact one of trace/cut.py::compact_rows: only the
//   rows the walk can reach from the root (62 of 2,380 on "shadertoy"),
//   each cut to the 56 words the walk reads (48 box words, then 8 child
//   ids), inner children renumbered. A table of at most kStagedBytes is
//   copied into shared memory by every block at its start
//   (emit_kernel<true>), the counterpart of the TPU kernel's top table
//   resident in VMEM; a larger one is read from global memory by the same
//   walk (emit_kernel<false>). The host entry picks by the table's size
//   and nothing else.
// - A thread per ray; a node's children four at a time: lox of children
//   4g..4g+3 is int4 g of the row, loy int4 2 + g, .. hiz int4 10 + g, the
//   ids int4 12 + g (7 16-byte loads a group, one broadcast where a warp's
//   rays share the node).
// - Persistent blocks, as many as the card holds, each staging the table
//   once. A warp draws a span of 96-1,024 rays in a row (about eight spans
//   a warp where the launch has the rays) from counters[0], and the last
//   block out zeroes the counters for the next launch.
// - The warp takes its span 32 rays at a time. The dead rays' rows of -1
//   are written at once, 32 words a store (the 32 rows lie in a row of
//   ids); the live rays join a queue of the warp in shared memory, and
//   the warp walks 32 queued rays at a time, so no lane waits through a
//   walk for a dead ray.
// - A walked ray's first K ids gather in shared memory (slot s of thread x
//   at s * kEmitThreads + x) and its row is written once, four ids a store
//   where K allows.
// - The stack holds node ids in local memory, stack_entries entries
//   (traverse.stack_need of the compact table, at most kStackDepth). A
//   push past it is dropped and counted in *overflow; the callers require
//   0.
// On an NVIDIA H100 80GB HBM3 at 700 W, the octet schedule of kernels 1,
// 2, 4 and 6 (a ray per 8 lanes) took 8.15 ms on the 24 launches of a
// TB_CUT=1 render_sample(1) and render_sample(8) at 1280x720 against 5.34
// for the thread per ray this kernel replaces: a live ray walks too few nodes to repay an octet's step, and
// its 8-ray draws cost 921,600 atomics a 7,372,800-lane launch.
//
// Arithmetic: built with --fmad=false; the slab test is the traversal
// kernels' (bvh_common.cuh box_slab), so each box test rounds as the
// twin's.

#include "bvh_common.cuh"

using namespace tb;

namespace {

constexpr int kCutRow = 56;              // words of a compact row
constexpr int kCutRow4 = kCutRow / 4;    // its int4
constexpr int kEmitThreads = 256;        // 8 warps a block
constexpr int kEmitBlocksPerSM = 6;      // 1,536 threads an SM
constexpr int kMaxK = 64;                // trace/cut.py MAX_K
constexpr int kQueue = 64;               // a warp's queue of live rays
constexpr int kSpans = 8;                // spans a resident warp draws
// The fewest rays a draw takes: a 921,600-lane launch of mostly dead rays
// waits on its draws from one counter below three warps of rays a draw.
constexpr int kMinSpan = 96;
// The largest table a block copies into shared memory (146 rows).
constexpr size_t kStagedBytes = 32 * 1024;

__device__ __forceinline__ int32_t part(const int4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// Whether a table of n_rows compact rows is copied into shared memory.
inline bool stages_table(int n_rows) {
  return static_cast<size_t>(n_rows) * kCutRow * sizeof(int32_t) <=
         kStagedBytes;
}

// Words of shared memory before the id rows: the staged table, if any.
__host__ __device__ inline int ids_offset(bool staged, int n_rows) {
  return staged ? n_rows * kCutRow : 0;
}

// Id s of a walked ray's row: its emits in the block's id rows (slot s of
// thread x at s * kEmitThreads + x), n_cuts in slot K-1 past K emits, -1
// past its emits.
__device__ __forceinline__ int32_t row_id(const int32_t* found, int x,
                                          int s, int cnt, int K,
                                          int n_cuts) {
  return s == K - 1 && cnt > K
             ? n_cuts
             : (s < cnt ? found[s * kEmitThreads + x] : -1);
}

// Shared memory: [the table (kStaged)] [K rows of kEmitThreads ids] [a
// queue of kQueue live rays a warp]. counters: [0] the next span's first
// ray, [1] the blocks done; both zero at the launch, and zeroed again by
// the last block out.
template <bool kStaged>
__global__ void __launch_bounds__(kEmitThreads, kEmitBlocksPerSM)
emit_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
            const float* __restrict__ t_max,
            const int4* __restrict__ table, int n_rows, int stack_entries,
            int n_rays, int span, int K, int n_cuts,
            int32_t* __restrict__ ids, unsigned int* __restrict__ counters,
            unsigned int* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  const int x = threadIdx.x;
  if (kStaged) {
    int4* staged = reinterpret_cast<int4*>(smem);
    for (int q = x; q < n_rows * kCutRow4; q += kEmitThreads) {
      staged[q] = __ldg(table + q);
    }
  }
  __syncthreads();
  const int4* rows = kStaged ? reinterpret_cast<const int4*>(smem) : table;
  int32_t* found = smem + ids_offset(kStaged, n_rows);
  const int lane = x & 31;
  int32_t* queue = found + K * kEmitThreads + (x >> 5) * kQueue;
  const unsigned int n = static_cast<unsigned int>(n_rays);
  // The ray of word w of a 32-row group of ids, and the step of 32 words.
  const unsigned int w_ray = lane / K, w_slot = lane % K;
  const unsigned int step_ray = 32u / K, step_slot = 32u % K;

  int queued = 0;            // live rays in the warp's queue
  bool drained = false;      // every span is drawn
  unsigned int base = 0u, span_end = 0u;
  for (;;) {
    // 1. The next 32 rays in a row of the warp's span, drawing a new span
    // from counters[0] when it is used up. The dead rays' rows of -1 are
    // written at once, 32 words a store; the live ones join the queue.
    if (!drained && base >= span_end) {
      unsigned int first = 0u;
      if (lane == 0) {
        first = atomicAdd(counters, static_cast<unsigned int>(span));
      }
      first = __shfl_sync(kFull, first, 0);
      drained = first >= n;
      base = first;
      span_end = min(first + static_cast<unsigned int>(span), n);
    }
    if (!drained) {
      const unsigned int i = base + lane;
      const bool live = i < span_end && t_max[i] > 0.f;
      const unsigned int mask = __ballot_sync(kFull, live);
      const unsigned int n_words = min(32u, span_end - base) * K;
      int32_t* out = ids + static_cast<size_t>(base) * K;
      unsigned int r = w_ray, slot = w_slot;
      for (unsigned int w = lane; w < n_words; w += 32u) {
        if (!((mask >> r) & 1u)) out[w] = -1;
        r += step_ray;
        slot += step_slot;
        if (slot >= static_cast<unsigned int>(K)) {
          slot -= K;
          ++r;
        }
      }
      if (live) queue[queued + __popc(mask & ((1u << lane) - 1u))] = i;
      queued += __popc(mask);
      base += 32u;
    }
    if (queued < 32 && !(drained && queued > 0)) {
      if (drained) break;
      continue;
    }
    __syncwarp();

    // 2. Walk 32 queued rays, a lane each (fewer at the end).
    const int take = min(queued, 32);
    if (lane < take) {
      const int i = queue[lane];
      const Ray ray = load_ray(orig, dir, t_max, i);
      int cnt = 0;
      int32_t stack[kStackDepth];
      int sp = 1;
      stack[0] = 0;
      while (sp > 0) {
        const int4* row = rows + stack[--sp] * kCutRow4;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int g = c / 4, j = c % 4;
          const int32_t cid = part(row[12 + g], j);
          if (cid == kInvalid) continue;
          float t_near, t_far;
          box_slab(part(row[g], j), part(row[2 + g], j), part(row[4 + g], j),
                   part(row[6 + g], j), part(row[8 + g], j),
                   part(row[10 + g], j), ray, t_near, t_far);
          if (!(t_far >= fmaxf(t_near, 0.f) && t_near < ray.t_max)) continue;
          if (cid >= 0) {
            if (sp < stack_entries) {
              stack[sp++] = cid;
            } else {
              atomicAdd(overflow, 1u);
            }
          } else {
            if (cnt < K) found[cnt * kEmitThreads + x] = -cid - 1;
            ++cnt;
          }
        }
      }
      // The ray's row, written once, four ids a store where K allows.
      int32_t* out = ids + static_cast<size_t>(i) * K;
      if ((K & 3) == 0) {
        for (int s = 0; s < K; s += 4) {
          reinterpret_cast<int4*>(out)[s / 4] = make_int4(
              row_id(found, x, s, cnt, K, n_cuts),
              row_id(found, x, s + 1, cnt, K, n_cuts),
              row_id(found, x, s + 2, cnt, K, n_cuts),
              row_id(found, x, s + 3, cnt, K, n_cuts));
        }
      } else {
        for (int s = 0; s < K; ++s) out[s] = row_id(found, x, s, cnt, K,
                                                    n_cuts);
      }
    }
    __syncwarp();   // the queue is read before it moves down
    if (lane < queued - take) queue[lane] = queue[take + lane];
    queued -= take;
    __syncwarp();
  }
  // The last block out zeroes the counters for the next launch.
  __syncthreads();
  if (x == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1u) == gridDim.x - 1u) {
      atomicExch(counters, 0u);
      atomicExch(counters + 1, 0u);
    }
  }
}

// Rays a warp draws at once: about kSpans spans a resident warp, in whole
// warps of rays, at least kMinSpan and at most 1,024 of them.
inline int span_rays(int n_rays, int warps) {
  const long long spans = static_cast<long long>(kSpans) * warps;
  long long per = (static_cast<long long>(n_rays) + spans - 1) / spans;
  per = (per + 31) / 32 * 32;
  return static_cast<int>(per < kMinSpan ? kMinSpan
                                         : per > 1024 ? 1024 : per);
}

}  // namespace

// The host side needs nvcc's launch syntax; a host compiler (the test that
// runs the kernel above on host threads) stops here.
#ifdef __CUDACC__

// rows: the compact table (n_rows x 56 int32, 16-byte aligned);
// stack_entries: each ray's stack (what the table can ask for, at most
// kStackDepth).
extern "C" int tb_emit_cut_rows(const float* orig, const float* dir,
                                const float* t_max, const int32_t* rows,
                                int n_rows, int stack_entries, int n_rays,
                                int K, int n_cuts, int32_t* ids,
                                unsigned int* counters,
                                unsigned int* overflow, void* stream) {
  if (n_rows < 1 || stack_entries < 1 || stack_entries > kStackDepth ||
      K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const bool staged = stages_table(n_rows);
  void (*kernel)(const float*, const float*, const float*, const int4*, int,
                 int, int, int, int, int, int32_t*, unsigned int*,
                 unsigned int*) = staged ? emit_kernel<true>
                                         : emit_kernel<false>;
  const size_t shared =
      (static_cast<size_t>(ids_offset(staged, n_rows)) +
       static_cast<size_t>(K) * kEmitThreads +
       static_cast<size_t>(kEmitThreads / 32) * kQueue) * sizeof(int32_t);
  // The card's resident blocks for this shared-memory size, kept from the
  // last launch of the same kernel and size on the same device: the
  // queries cost host time that a launch of 921,600 rays notices.
  struct Resident {
    int device = -1;
    size_t shared = 0;
    int blocks = 0;
  };
  static Resident known[2];
  Resident& res = known[staged ? 1 : 0];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res.device != device || res.shared != shared) {
    int sms = 0, blocks_per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess && shared > 48 * 1024)   // past the default
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_per_sm, kernel, kEmitThreads, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm < 1)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    res = Resident{device, shared, sms * blocks_per_sm};
  }
  const int wanted = (n_rays + kEmitThreads - 1) / kEmitThreads;
  const int blocks = res.blocks < wanted ? res.blocks : wanted;
  kernel<<<blocks, kEmitThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      orig, dir, t_max, reinterpret_cast<const int4*>(rows), n_rows,
      stack_entries, n_rays, span_rays(n_rays, blocks * (kEmitThreads / 32)),
      K, n_cuts, ids, counters, overflow);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
