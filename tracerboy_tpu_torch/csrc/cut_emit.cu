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
// What bounds it on the card: the top table is small (a few hundred rows
// for 10^5 triangles) and stays in L1/L2; each pop is one dependent
// 512-byte row read and 8 slab tests, and the writes are K int32 per ray.
// One thread per ray with a private stack is enough here; the emit pass is
// a small part of the cut path next to phase 2.
//
// Arithmetic: built with --fmad=false; the slab test is the traversal
// kernels' (bvh_common.cuh).

#include "bvh_common.cuh"

using namespace tb;

namespace {

__global__ void __launch_bounds__(kThreads)
emit_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
            const float* __restrict__ t_max, const int32_t* __restrict__ top,
            int n_rays, int K, int n_cuts, int32_t* __restrict__ ids,
            unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int32_t* __restrict__ out = ids + static_cast<size_t>(i) * K;
  for (int s = 0; s < K; ++s) out[s] = -1;
  const Ray ray = load_ray(orig, dir, t_max, i);
  if (!(ray.t_max > 0.f)) return;

  int32_t stack[kStackDepth];
  int sp = 1;
  stack[0] = 0;
  int cnt = 0;
  while (sp > 0) {
    const int32_t* __restrict__ row = top + static_cast<size_t>(stack[--sp]) * kRow;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int32_t cid = row[48 + c];
      if (cid == kInvalid) continue;
      float t_near, t_far;
      child_slab(row, c, ray, t_near, t_far);
      if (!(t_far >= fmaxf(t_near, 0.f) && t_near < ray.t_max)) continue;
      if (cid >= 0) {
        if (sp < kStackDepth) {
          stack[sp++] = cid;
        } else {
          atomicAdd(overflow, 1u);
        }
        continue;
      }
      const int32_t emit = -cid - 1;
      if (cnt < K - 1) {
        out[cnt] = emit;
      } else {
        out[K - 1] = cnt == K - 1 ? emit : n_cuts;
      }
      ++cnt;
    }
  }
}

}  // namespace

extern "C" int tb_emit_cuts(const float* orig, const float* dir,
                            const float* t_max, const int32_t* top,
                            int n_rays, int K, int n_cuts, int32_t* ids,
                            unsigned int* overflow, void* stream) {
  if (n_rays > 0) {
    emit_kernel<<<blocks_for(n_rays), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        orig, dir, t_max, top, n_rays, K, n_cuts, ids, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}
