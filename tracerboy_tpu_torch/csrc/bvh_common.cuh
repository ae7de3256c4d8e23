// Device helpers shared by the port's kernels: the packed-table layout
// constants, the per-ray slab test of one wide-node child, the
// Baldwin-Weber test of one 12-float triangle row (trace/traverse.py
// documents the tables), and the pieces of the octet schedule (a ray per
// 8 lanes, persistent blocks drawing tickets of rays from a counter) that
// the octet kernels of bvh_traverse.cu, bvh_traverse_v1.cu and binned.cu
// share. Every kernel that includes this file is built with --fmad=false,
// so each expression rounds as in the plain PyTorch twins, which evaluate
// the same expressions in the same order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tb {

constexpr int kStackDepth = 96;
constexpr int kLeaf = 8;
constexpr int kRow = 128;
constexpr int kThreads = 128;
constexpr int32_t kInvalid = 0x7fffffff;
constexpr float kBig = 1e30f;
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryHi = static_cast<float>(1.0 + 1e-5);
constexpr float kTMin = 1e-5f;
constexpr float kDetEps = 1e-12f;
constexpr unsigned int kFull = 0xffffffffu;   // a full-warp mask

struct Ray {
  float ox, oy, oz, dx, dy, dz, inv_x, inv_y, inv_z, t_max;
};

// |d| < 1e-12 maps to +-1e-12 (0 and -0 to +1e-12), as the TPU kernel's fix.
__device__ __forceinline__ float fix_dir(float v) {
  return fabsf(v) < kDetEps ? (v < 0.f ? -kDetEps : kDetEps) : v;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dir,
                                        const float* __restrict__ t_max,
                                        int i) {
  Ray ray;
  ray.ox = orig[3 * i + 0];
  ray.oy = orig[3 * i + 1];
  ray.oz = orig[3 * i + 2];
  ray.dx = dir[3 * i + 0];
  ray.dy = dir[3 * i + 1];
  ray.dz = dir[3 * i + 2];
  ray.t_max = t_max[i];
  ray.inv_x = 1.0f / fix_dir(ray.dx);
  ray.inv_y = 1.0f / fix_dir(ray.dy);
  ray.inv_z = 1.0f / fix_dir(ray.dz);
  return ray;
}

// Entry and exit distance of a box (lo, hi as f32 bits; raw, unclamped).
__device__ __forceinline__ void box_slab(int32_t lox, int32_t loy,
                                         int32_t loz, int32_t hix,
                                         int32_t hiy, int32_t hiz,
                                         const Ray& ray, float& t_near,
                                         float& t_far) {
  const float t0x = (__int_as_float(lox) - ray.ox) * ray.inv_x;
  const float t0y = (__int_as_float(loy) - ray.oy) * ray.inv_y;
  const float t0z = (__int_as_float(loz) - ray.oz) * ray.inv_z;
  const float t1x = (__int_as_float(hix) - ray.ox) * ray.inv_x;
  const float t1y = (__int_as_float(hiy) - ray.oy) * ray.inv_y;
  const float t1z = (__int_as_float(hiz) - ray.oz) * ray.inv_z;
  t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Entry and exit distance of child slot c of a node row (raw, unclamped).
__device__ __forceinline__ void child_slab(const int32_t* __restrict__ row,
                                           int c, const Ray& ray,
                                           float& t_near, float& t_far) {
  box_slab(row[c], row[8 + c], row[16 + c], row[24 + c], row[32 + c],
           row[40 + c], ray, t_near, t_far);
}

// Baldwin-Weber test of one triangle row (12 floats). Returns true if the
// hit is accepted geometrically; t, u, v are its parameters.
__device__ __forceinline__ bool bw_test(const float* __restrict__ r,
                                        const Ray& ray, float& t, float& u,
                                        float& v) {
  const float A = r[0] * ray.ox + r[1] * ray.oy + r[2] * ray.oz + r[3];
  const float B = r[0] * ray.dx + r[1] * ray.dy + r[2] * ray.dz;
  const float inv_b = fabsf(B) > kDetEps ? 1.0f / B : 0.0f;
  t = -A * inv_b;
  const float co = r[4] * ray.ox + r[5] * ray.oy + r[6] * ray.oz + r[7];
  const float cd = r[4] * ray.dx + r[5] * ray.dy + r[6] * ray.dz;
  u = co + t * cd;
  const float eo = r[8] * ray.ox + r[9] * ray.oy + r[10] * ray.oz + r[11];
  const float ed = r[8] * ray.dx + r[9] * ray.dy + r[10] * ray.dz;
  v = eo + t * ed;
  // The 1e-5 band turns edge cracks into harmless double acceptance.
  return fabsf(B) > kDetEps && u >= -kBaryEps && v >= -kBaryEps &&
         u + v <= kBaryHi && t > kTMin;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// --- The octet schedule ------------------------------------------------
//
// One ray per group of 8 lanes (an octet), four octets a warp. The four
// octets of a warp step through one loop together, so every shuffle,
// ballot and __syncwarp of an octet kernel is reached by all 32 lanes and
// names the full warp: a shuffle of width 8 stays inside its octet and a
// ballot is cut to the octet's 8 bits (octet_bits).

constexpr int kOctet = 8;          // lanes a ray
constexpr int kOctThreads = 128;   // 4 warps: 16 rays in flight a block
constexpr int kOctets = kOctThreads / kOctet;
constexpr int kBlocksPerSM = 12;   // 1,536 resident threads an SM
constexpr unsigned int kNoHit = 0x7f800000u;   // +infinity's bits

// The 8 bits of a warp ballot that belong to the octet whose first lane is
// `shift`.
__device__ __forceinline__ unsigned int octet_bits(unsigned int ballot,
                                                   int shift) {
  return (ballot >> shift) & 0xffu;
}

// An octet's ticket: ray j of it is first + 4 j; todo holds its live rays
// not yet walked; drained, that the counter is past the rays.
struct Ticket {
  unsigned int first = 0u, todo = 0u;
  bool drained = false;
};

// Step 1 of an octet loop: every octet that is idle (no ray, its ticket
// used up, the counter not drained) draws the next ticket from *next_ray.
// Ticket b stands for the 8 rays 32 (b / 4) + b % 4 + 4 j, j = 0..7: four
// tickets in a row interleave over 32 rays in a row, so the octets of a
// warp, which mostly draw together, walk neighbouring rays. Lane j looks
// at the ticket's ray j: a dead ray (t_max <= 0, or NaN) gets miss(ray)
// from its lane here, and is never walked. Reached by the whole warp.
template <typename Miss>
__device__ __forceinline__ void draw_ticket(Ticket& tk, bool idle, int sub,
                                            int shift,
                                            const float* __restrict__ t_max,
                                            unsigned int n,
                                            unsigned int* __restrict__ next_ray,
                                            Miss miss) {
  if (!__any_sync(kFull, idle)) return;
  unsigned int ticket = 0u;
  if (idle && sub == 0) ticket = atomicAdd(next_ray, 1u);
  ticket = __shfl_sync(kFull, ticket, 0, kOctet);
  bool live = false;
  if (idle) {
    tk.first = (ticket >> 2) * 32u + (ticket & 3u);
    tk.drained = (ticket >> 2) * 32u >= n;
    const unsigned int mine = tk.first + 4u * sub;
    if (!tk.drained && mine < n) {
      live = t_max[mine] > 0.f;
      if (!live) miss(mine);
    }
  }
  const unsigned int lives = octet_bits(__ballot_sync(kFull, live), shift);
  if (idle) tk.todo = lives;
}

// The host side needs nvcc's launch syntax; a host compiler (the tests
// that run the kernels on host threads) skips it.
#ifdef __CUDACC__

// Launch a persistent kernel of `threads` threads a block on as many
// blocks as the card holds at once (fewer where n_rays at rays_per_block
// do not fill them). Returns the CUDA error code.
template <typename... Params, typename... Args>
int launch_persistent(void (*kernel)(Params...), int threads, size_t shared,
                      int n_rays, int rays_per_block, void* stream,
                      Args... args) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0, blocks_per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                        threads, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int wanted = (n_rays + rays_per_block - 1) / rays_per_block;
  const int blocks = sms * blocks_per_sm < wanted ? sms * blocks_per_sm
                                                  : wanted;
  kernel<<<blocks, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Params>(args)...);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace tb
