// Runs the emit kernel of csrc/cut_emit.cu on host threads (see
// cuda_runtime.h beside this file): the grid of the card's host entry for
// `resident` resident blocks, one block after the other, which the
// persistent kernel allows since every warp draws its rays from the same
// counter. The table is staged in the block's shared memory or read in
// place by the rule of the card's host entry (stages_table).
#include "cuda_runtime.h"

#include <thread>
#include <vector>

thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local WarpSlots* shim_warp;
thread_local int shim_lane;
thread_local ShimBarrier* shim_block;

namespace {
int32_t smem[1 << 15];   // the block's dynamic shared memory
}

#include "cut_emit.cu"

// counters: two zeroed words, zero again when the kernel is done. Returns
// 1 if the table was staged in shared memory, 0 if it was read in place.
extern "C" int shim_emit_cut_rows(const float* o, const float* d,
                                  const float* t_max, const int32_t* rows,
                                  int n_rows, int stack_entries, int n,
                                  int K, int n_cuts, int32_t* ids,
                                  unsigned* counters, unsigned* overflow,
                                  int resident) {
  const bool staged = stages_table(n_rows);
  const int wanted = (n + kEmitThreads - 1) / kEmitThreads;
  const int blocks = resident < wanted ? resident : wanted;
  const int span = span_rays(n, blocks * (kEmitThreads / 32));
  const int4* table = reinterpret_cast<const int4*>(rows);
  for (int b = 0; b < blocks; ++b) {
    std::vector<WarpSlots> warps(kEmitThreads / 32);
    ShimBarrier block(kEmitThreads);
    std::vector<std::thread> pool;
    for (int x = 0; x < kEmitThreads; ++x) {
      pool.emplace_back([&, x, b] {
        threadIdx = {static_cast<unsigned>(x), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        blockDim = {static_cast<unsigned>(kEmitThreads), 1, 1};
        gridDim = {static_cast<unsigned>(blocks), 1, 1};
        shim_warp = &warps[x / 32];
        shim_lane = x % 32;
        shim_block = &block;
        if (staged) {
          emit_kernel<true>(o, d, t_max, table, n_rows, stack_entries, n,
                            span, K, n_cuts, ids, counters, overflow);
        } else {
          emit_kernel<false>(o, d, t_max, table, n_rows, stack_entries, n,
                             span, K, n_cuts, ids, counters, overflow);
        }
      });
    }
    for (auto& th : pool) th.join();
  }
  return staged ? 1 : 0;
}
