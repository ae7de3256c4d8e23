// A host stand-in for the CUDA device API that the port's kernel sources
// use (csrc/bvh_traverse.cu, bvh_traverse_v1.cu, binned.cu, cut_emit.cu),
// so that g++ can compile a kernel source and a test can run it without a
// card. Every thread of a block is a host thread; every warp collective (shuffle,
// ballot, vote, __syncwarp) is a barrier of the warp's 32 threads around an
// exchange through the warp's 32 slots. That is a faithful model of a
// kernel whose collectives are all reached by all 32 lanes and name the
// full warp, which is how those kernels are written. The barrier sleeps on
// a condition variable: a waiting thread takes no CPU. Dynamic shared
// memory is whatever array the runner defines under the kernel's extern
// __shared__ name (one block runs at a time); a static __shared__ array
// becomes an array of each host thread, a faithful model only where each
// thread touches its own part of it (the stats kernel's stack window).
// __syncthreads is a barrier of the block's threads (shim_block, which a
// runner that needs it sets for each thread).
// Host launch code (guarded by __CUDACC__ in the sources) is not compiled.
#pragma once

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct Dim3 {
  unsigned x, y, z;
};
struct float4 {
  float x, y, z, w;
};
struct int2 {
  int x, y;
};
struct int4 {
  int x, y, z, w;
};

// A barrier of `count` threads that sleeps while it waits.
class ShimBarrier {
 public:
  explicit ShimBarrier(int count) : count_(count) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mutex_);
    const unsigned generation = generation_;
    if (++waiting_ == count_) {
      waiting_ = 0;
      ++generation_;
      cv_.notify_all();
    } else {
      cv_.wait(lock, [&] { return generation_ != generation; });
    }
  }

 private:
  std::mutex mutex_;
  std::condition_variable cv_;
  const int count_;
  int waiting_ = 0;
  unsigned generation_ = 0;
};

struct WarpSlots {
  ShimBarrier barrier{32};
  uint32_t slot[32];
};

extern thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
extern thread_local WarpSlots* shim_warp;
extern thread_local int shim_lane;
extern thread_local ShimBarrier* shim_block;

template <typename To, typename From>
inline To shim_bits(From v) {
  static_assert(sizeof(To) == sizeof(From), "same size");
  To out;
  memcpy(&out, &v, sizeof(To));
  return out;
}

inline int2 make_int2(int x, int y) { return int2{x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline float4 __ldg(const float4* p) { return *p; }
inline int4 __ldg(const int4* p) { return *p; }
inline float __int_as_float(int v) { return shim_bits<float>(v); }
inline int __float_as_int(float v) { return shim_bits<int>(v); }
inline unsigned __float_as_uint(float v) { return shim_bits<unsigned>(v); }
inline float __uint_as_float(unsigned v) { return shim_bits<float>(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int min(int a, int b) { return a < b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }

inline void shim_barrier() { shim_warp->barrier.wait(); }

// Every lane posts `mine`, then reads lane `from`'s word.
inline uint32_t shim_exchange(uint32_t mine, int from) {
  shim_warp->slot[shim_lane] = mine;
  shim_barrier();
  const uint32_t got = shim_warp->slot[from];
  shim_barrier();
  return got;
}

inline unsigned __ballot_sync(unsigned, bool p) {
  shim_warp->slot[shim_lane] = p ? 1u : 0u;
  shim_barrier();
  unsigned bits = 0u;
  for (int lane = 0; lane < 32; ++lane) bits |= shim_warp->slot[lane] << lane;
  shim_barrier();
  return bits;
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0u; }
inline bool __all_sync(unsigned m, bool p) { return __ballot_sync(m, p) == ~0u; }
inline void __syncwarp(unsigned = ~0u) { shim_barrier(); }
inline void __syncthreads() { shim_block->wait(); }

template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int from = (shim_lane & ~(width - 1)) | (src & (width - 1));
  return shim_bits<T>(shim_exchange(shim_bits<uint32_t>(v), from));
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask, int width = 32) {
  const int from =
      (shim_lane & ~(width - 1)) | ((shim_lane ^ lane_mask) & (width - 1));
  return shim_bits<T>(shim_exchange(shim_bits<uint32_t>(v), from));
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int from = (shim_lane & (width - 1)) >= static_cast<int>(delta)
                       ? shim_lane - static_cast<int>(delta)
                       : shim_lane;
  return shim_bits<T>(shim_exchange(shim_bits<uint32_t>(v), from));
}
