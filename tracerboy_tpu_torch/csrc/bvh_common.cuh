// Device helpers shared by the port's kernels: the packed-table layout
// constants, the per-ray slab test of one wide-node child and the
// Baldwin-Weber test of one 12-float triangle row (trace/traverse.py
// documents the tables). Every kernel that includes this file is built
// with --fmad=false, so each expression rounds as in the plain PyTorch
// twins, which evaluate the same expressions in the same order.

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

// Entry and exit distance of child slot c of a node row (raw, unclamped).
__device__ __forceinline__ void child_slab(const int32_t* __restrict__ row,
                                           int c, const Ray& ray,
                                           float& t_near, float& t_far) {
  const float t0x = (__int_as_float(row[c]) - ray.ox) * ray.inv_x;
  const float t0y = (__int_as_float(row[8 + c]) - ray.oy) * ray.inv_y;
  const float t0z = (__int_as_float(row[16 + c]) - ray.oz) * ray.inv_z;
  const float t1x = (__int_as_float(row[24 + c]) - ray.ox) * ray.inv_x;
  const float t1y = (__int_as_float(row[32 + c]) - ray.oy) * ray.inv_y;
  const float t1z = (__int_as_float(row[40 + c]) - ray.oz) * ray.inv_z;
  t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
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

}  // namespace tb
