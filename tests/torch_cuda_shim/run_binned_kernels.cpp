// Runs the selection and dense kernels of csrc/binned.cu on host threads
// (see cuda_runtime.h beside this file): one block at a time, each block's
// threads host threads, the blocks one after the other, which both kernels
// allow (the selection's blocks draw their rays from one counter, a dense
// block owns its 128 pairs).
#include "cuda_runtime.h"

#include <thread>
#include <vector>

thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local WarpSlots* shim_warp;
thread_local int shim_lane;

namespace {
// The block's dynamic shared memory, under the kernel's extern name: the
// 48 KB of traverse.MAX_STACK_ENTRIES entries for each of 16 rays.
int2 select_stack[384 * 16];
}  // namespace

#include "binned.cu"

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
        gridDim = {static_cast<unsigned>(blocks), 1, 1};
        shim_warp = &warps[x / 32];
        shim_lane = x % 32;
        kernel();
      });
    }
    for (auto& th : pool) th.join();
  }
}

}  // namespace

extern "C" void shim_select_clusters(const float* o, const float* d,
                                     const float* t_max, const int32_t* nodes,
                                     int n, int stack_entries, float* slot_t,
                                     int32_t* slot_c, float* dropped,
                                     unsigned* next_ray, unsigned* overflow,
                                     int blocks) {
  run_blocks(blocks, kSelThreads, [&] {
    select_kernel(o, d, t_max, nodes, n, stack_entries, slot_t, slot_c,
                  dropped, next_ray, overflow);
  });
}

extern "C" void shim_dense_pairs(const float* o, const float* d,
                                 const float* cap, const int32_t* cluster,
                                 const float* mot, const int32_t* base,
                                 int n_pairs, float* t, int32_t* tri,
                                 float* u, float* v) {
  run_blocks((n_pairs + kDenseThreads - 1) / kDenseThreads, kDenseThreads,
             [&] {
               dense_kernel(o, d, cap, cluster,
                            reinterpret_cast<const float4*>(mot), base,
                            n_pairs, t, tri, u, v);
             });
}
