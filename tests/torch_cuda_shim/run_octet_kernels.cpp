// Runs the kernels of csrc/bvh_traverse.cu on host threads (see
// cuda_runtime.h beside this file): one block at a time, `blocks` blocks
// one after the other, which the persistent kernels allow since every
// block draws its rays from the same counter.
#include "cuda_runtime.h"

#include <thread>
#include <vector>

thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local WarpSlots* shim_warp;
thread_local int shim_lane;

namespace {
int32_t smem[1 << 16];   // the block's dynamic shared memory
}

#include "bvh_traverse.cu"

namespace {

template <typename Kernel>
void run_blocks(int blocks, int threads, Kernel kernel) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<WarpSlots> warps(threads / 32);
    std::vector<std::thread> pool;
    for (int x = 0; x < threads; ++x) {
      pool.emplace_back([&, x] {
        threadIdx = {static_cast<unsigned>(x), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        blockDim = {static_cast<unsigned>(threads), 1, 1};
        shim_warp = &warps[x / 32];
        shim_lane = x % 32;
        kernel();
      });
    }
    for (auto& th : pool) th.join();
  }
}

}  // namespace

extern "C" void shim_closest_hit(const float* o, const float* d,
                                 const float* t_max, const int32_t* nodes,
                                 const float* tris, const int32_t* roots,
                                 int n, int stack_entries, float* t,
                                 int32_t* tri, float* u, float* v,
                                 unsigned* next_ray, unsigned* overflow,
                                 int blocks) {
  run_blocks(blocks, kOctThreads, [&] {
    octet_kernel<false>(o, d, t_max, nodes, tris, roots, n, stack_entries, t,
                        tri, u, v, nullptr, next_ray, overflow);
  });
}

extern "C" void shim_any_hit(const float* o, const float* d,
                             const float* t_max, const int32_t* nodes,
                             const float* tris, const int32_t* roots, int n,
                             int stack_entries, bool* occ, unsigned* next_ray,
                             unsigned* overflow, int blocks) {
  run_blocks(blocks, kOctThreads, [&] {
    octet_kernel<true>(o, d, t_max, nodes, tris, roots, n, stack_entries,
                       nullptr, nullptr, nullptr, nullptr, occ, next_ray,
                       overflow);
  });
}

// The stats kernel, traverse_stats_kernel.
extern "C" void shim_closest_hit_stats(const float* o, const float* d,
                                       const float* t_max,
                                       const int32_t* nodes,
                                       const float* tris, int n,
                                       int stack_entries, float* t,
                                       int32_t* tri, float* u, float* v,
                                       int32_t* pops, int32_t* clusters,
                                       unsigned* next_ray, unsigned* overflow,
                                       int blocks) {
  run_blocks(blocks, kStatsThreads, [&] {
    traverse_stats_kernel(o, d, t_max, nodes, tris, n, stack_entries, t, tri,
                          u, v, pops, clusters, next_ray, overflow);
  });
}
