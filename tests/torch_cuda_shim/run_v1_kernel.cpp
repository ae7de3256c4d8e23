// Runs the v1 closest-hit kernel of csrc/bvh_traverse_v1.cu on host
// threads (see cuda_runtime.h beside this file): one block at a time,
// `blocks` blocks one after the other, which the persistent kernel allows
// since every block draws its rays from the same counter.
#include "cuda_runtime.h"

#include <thread>
#include <vector>

thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local WarpSlots* shim_warp;
thread_local int shim_lane;

namespace {
int32_t smem[1 << 14];   // the block's dynamic shared memory
}

#include "bvh_traverse_v1.cu"

extern "C" void shim_closest_hit_v1(const float* o, const float* d,
                                    const float* t_max, const int32_t* nodes,
                                    const float* tris, int n,
                                    int stack_entries, float* t, int32_t* tri,
                                    float* u, float* v, unsigned* next_ray,
                                    unsigned* overflow, int blocks) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<WarpSlots> warps(kOctThreads / 32);
    std::vector<std::thread> pool;
    for (int x = 0; x < kOctThreads; ++x) {
      pool.emplace_back([&, x, b] {
        threadIdx = {static_cast<unsigned>(x), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        blockDim = {static_cast<unsigned>(kOctThreads), 1, 1};
        shim_warp = &warps[x / 32];
        shim_lane = x % 32;
        traverse_v1_octets(o, d, t_max, nodes, tris, n, stack_entries, t, tri,
                           u, v, next_ray, overflow);
      });
    }
    for (auto& th : pool) th.join();
  }
}
