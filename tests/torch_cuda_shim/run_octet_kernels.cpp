// Runs the octet kernels of csrc/bvh_traverse.cu on host threads (see
// cuda_runtime.h beside this file): one block of kOctThreads threads at a
// time, `blocks` blocks one after the other, which the persistent kernels
// allow since every block draws its rays from the same counter.
#include "cuda_runtime.h"

#include <thread>
#include <vector>

thread_local Dim3 threadIdx, blockIdx, blockDim;
thread_local WarpSlots* shim_warp;
thread_local int shim_lane;

namespace {
int32_t smem[1 << 16];   // the block's dynamic shared memory
}

#include "bvh_traverse.cu"

namespace {

template <bool kAnyHit>
void run(const float* o, const float* d, const float* t_max,
         const int32_t* nodes, const float* tris, const int32_t* roots, int n,
         int stack_entries, float* t, int32_t* tri, float* u, float* v,
         bool* occ, unsigned* next_ray, unsigned* overflow, int blocks) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<WarpSlots> warps(kOctThreads / 32);
    for (auto& w : warps) pthread_barrier_init(&w.barrier, nullptr, 32);
    std::vector<std::thread> threads;
    for (int x = 0; x < kOctThreads; ++x) {
      threads.emplace_back([&, x] {
        threadIdx = {static_cast<unsigned>(x), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        blockDim = {static_cast<unsigned>(kOctThreads), 1, 1};
        shim_warp = &warps[x / 32];
        shim_lane = x % 32;
        octet_kernel<kAnyHit>(o, d, t_max, nodes, tris, roots, n,
                              stack_entries, t, tri, u, v, occ, next_ray,
                              overflow);
      });
    }
    for (auto& th : threads) th.join();
    for (auto& w : warps) pthread_barrier_destroy(&w.barrier);
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
  run<false>(o, d, t_max, nodes, tris, roots, n, stack_entries, t, tri, u, v,
             nullptr, next_ray, overflow, blocks);
}

extern "C" void shim_any_hit(const float* o, const float* d,
                             const float* t_max, const int32_t* nodes,
                             const float* tris, const int32_t* roots, int n,
                             int stack_entries, bool* occ, unsigned* next_ray,
                             unsigned* overflow, int blocks) {
  run<true>(o, d, t_max, nodes, tris, roots, n, stack_entries, nullptr,
            nullptr, nullptr, nullptr, occ, next_ray, overflow, blocks);
}
