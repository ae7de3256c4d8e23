"""Closest-hit and any-hit traversal of the packed BVH: CUDA kernels and
their plain PyTorch twins.

The counterpart of tracerboy_tpu/trace/pallas_traverse2.py
(traverse_packets2, anyhit_packets2). The kernels live in
csrc/bvh_traverse.cu, one thread per ray; they are built with nvcc for
sm_90a at first use (utils/build.py) and called through ctypes.

Tables (accel/pack.py):
- nodes (W, 128) int32: lanes 0-47 the 8 child boxes as f32 bits,
  [lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]; lanes 48-55 the child
  ids (INVALID = empty, negative = leaf cluster -id-1). Node 0 is the
  root.
- tris_bw (C, 128) float32: 8 triangles of 12 Baldwin-Weber floats.

Contract (both kernels and both twins):
- a lane with t_max <= 0 is dead: a miss, not occluded;
- a child box is entered iff t_far >= max(t_near, 0) and t_near < t_cap
  (the best hit so far for closest hit, t_max for any hit), with
  inv = 1 / d and |d| < 1e-12 replaced by +-1e-12;
- a triangle hit is accepted iff |B| > 1e-12, u >= -1e-5, v >= -1e-5,
  u + v <= 1 + 1e-5, t > 1e-5 and t < best (closest hit, strictly) or
  t < t_max (any hit);
- closest hit returns t (1e30 on a miss), the packed triangle id
  cluster*8 + k (-1 on a miss) and u, v (0 on a miss). At equal t the
  kernel keeps the first triangle it found and the twin the lowest id,
  so ids are compared only where t differs; at a tie, hit_attributes
  re-tests the kernel's pick.

The wrappers take the twin only for CPU tensors; on a CUDA tensor they
launch the kernel or raise. LAUNCHES counts kernel launches and
TWIN_CALLS counts calls that went to the twins.
"""

from __future__ import annotations

import ctypes

import torch

from tracerboy_tpu_torch.utils.build import (
    REPO_ROOT,
    build_shared_library,
    nvcc_path,
)

LEAF = 8
BIG = 1e30
_SOURCE = REPO_ROOT / "tracerboy_tpu_torch" / "csrc" / "bvh_traverse.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = {"closest": 0, "anyhit": 0}
TWIN_CALLS = {"closest": 0, "anyhit": 0}
_overflow: dict = {}
_lib = None


def reset_counters():
    """Zero the launch and twin-call counts and every overflow counter."""
    for d in (LAUNCHES, TWIN_CALLS):
        for k in d:
            d[k] = 0
    for buf in _overflow.values():
        buf.zero_()


def stack_overflows() -> int:
    """Pushes dropped because a ray's stack was full, summed over the
    devices that ran a kernel since the last reset (should be 0)."""
    return sum(int(buf.item()) for buf in _overflow.values())


def build_kernels():
    """Build (or reuse) and load the traversal kernels' library."""
    global _lib
    if _lib is None:
        path = build_shared_library("tbtraverse", [_SOURCE],
                                    [nvcc_path(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        lib.tb_closest_hit.restype = ctypes.c_int
        lib.tb_closest_hit.argtypes = [p, p, p, p, p, ctypes.c_int,
                                       p, p, p, p, p, p]
        lib.tb_any_hit.restype = ctypes.c_int
        lib.tb_any_hit.argtypes = [p, p, p, p, p, ctypes.c_int, p, p, p]
        _lib = lib
    return _lib


def _check(o, d, t_max, nodes, tris_bw):
    n = o.shape[0]
    for name, x, shape, dtype in (
        ("o", o, (n, 3), torch.float32),
        ("d", d, (n, 3), torch.float32),
        ("t_max", t_max, (n,), torch.float32),
        ("nodes", nodes, (nodes.shape[0], 128), torch.int32),
        ("tris_bw", tris_bw, (tris_bw.shape[0], 128), torch.float32),
    ):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")
    if n >= 2**31:
        raise ValueError("too many rays for one launch")


def _overflow_buffer(device):
    buf = _overflow.get(device)
    if buf is None:
        buf = torch.zeros((), dtype=torch.int32, device=device)
        _overflow[device] = buf
    return buf


def _launch(fn_name, device, *args):
    lib = build_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args],
            _overflow_buffer(device).data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {rc}")


def closest_hit(o, d, t_max, nodes, tris_bw):
    """Closest hit in (1e-5, t_max). o, d: (N, 3) f32; t_max: (N,) f32.
    Returns (t, packed tri id int32, u, v)."""
    _check(o, d, t_max, nodes, tris_bw)
    if o.device.type == "cpu":
        TWIN_CALLS["closest"] += 1
        return closest_hit_plain(o, d, t_max, nodes, tris_bw)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    _launch("tb_closest_hit", o.device, o, d, t_max, nodes, tris_bw, n,
            t, tri, u, v)
    LAUNCHES["closest"] += 1
    return t, tri, u, v


def any_hit(o, d, t_max, nodes, tris_bw):
    """Occlusion by any triangle in (1e-5, t_max). Returns (N,) bool."""
    _check(o, d, t_max, nodes, tris_bw)
    if o.device.type == "cpu":
        TWIN_CALLS["anyhit"] += 1
        return anyhit_plain(o, d, t_max, nodes, tris_bw)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    _launch("tb_any_hit", o.device, o, d, t_max, nodes, tris_bw, n, occ)
    LAUNCHES["anyhit"] += 1
    return occ


# ----------------------------------------------------------------------------
# Plain twins: every (ray, cluster) pair whose cluster box the ray enters
# within t_max gets the kernel's Baldwin-Weber test. The cluster boxes are
# the leaf boxes stored in the node rows, so this tests a superset of what
# the kernel's traversal reaches and needs no stack.

PAIR_BUDGET = 1 << 22   # (ray, cluster) slab tests per chunk


def _cluster_boxes(nodes, n_clusters):
    """Per-cluster (lo, hi), each (C, 3), from the leaf slots of the
    node rows; clusters no node references get an empty box."""
    W = nodes.shape[0]
    cid = nodes[:, 48:56].to(torch.int64)
    b = nodes[:, :48].contiguous().view(torch.float32).reshape(W, 6, 8)
    leaf = (cid < 0)
    cl = -cid[leaf] - 1
    lo = torch.full((n_clusters, 3), BIG, dtype=torch.float32,
                    device=nodes.device)
    hi = torch.full((n_clusters, 3), -BIG, dtype=torch.float32,
                    device=nodes.device)
    lo[cl] = b[:, 0:3, :].permute(0, 2, 1)[leaf]
    hi[cl] = b[:, 3:6, :].permute(0, 2, 1)[leaf]
    return lo, hi


def _fix(v):
    eps = 1e-12
    return torch.where(torch.abs(v) < eps,
                       torch.where(v < 0, -eps, eps).to(v.dtype), v)


def _pairs(o, inv, tmax, lo, hi):
    """(ray, cluster) index pairs whose box the ray enters in t_max."""
    t0x = (lo[None, :, 0] - o[:, None, 0]) * inv[:, None, 0]
    t0y = (lo[None, :, 1] - o[:, None, 1]) * inv[:, None, 1]
    t0z = (lo[None, :, 2] - o[:, None, 2]) * inv[:, None, 2]
    t1x = (hi[None, :, 0] - o[:, None, 0]) * inv[:, None, 0]
    t1y = (hi[None, :, 1] - o[:, None, 1]) * inv[:, None, 1]
    t1z = (hi[None, :, 2] - o[:, None, 2]) * inv[:, None, 2]
    t_near = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z))
    t_far = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z))
    hit = (t_far >= torch.clamp_min(t_near, 0.0)) & (t_near < tmax[:, None])
    return hit.nonzero(as_tuple=True)


def _bw_tests(o, d, rows):
    """Baldwin-Weber tests of P rays against the 8 triangles of their
    cluster rows (P, 128): (t, u, v, ok), each (P, 8), in the kernel's
    order of operations."""
    r = rows[:, : LEAF * 12].reshape(-1, LEAF, 12)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    c = [r[:, :, k] for k in range(12)]
    A = c[0] * ox + c[1] * oy + c[2] * oz + c[3]
    B = c[0] * dx + c[1] * dy + c[2] * dz
    good = torch.abs(B) > 1e-12
    inv_b = torch.where(good, 1.0 / B, 0.0)
    t = -A * inv_b
    co = c[4] * ox + c[5] * oy + c[6] * oz + c[7]
    cd = c[4] * dx + c[5] * dy + c[6] * dz
    u = co + t * cd
    eo = c[8] * ox + c[9] * oy + c[10] * oz + c[11]
    ed = c[8] * dx + c[9] * dy + c[10] * dz
    v = eo + t * ed
    ok = (good & (u >= -1e-5) & (v >= -1e-5) & (u + v <= 1.0 + 1e-5)
          & (t > 1e-5))
    return t, u, v, ok


def _chunks(o, d, t_max, nodes, tris_bw):
    """Yield per chunk of live rays: (ray ids, pair ray index into the
    chunk, pair cluster, t, u, v, ok & t < t_max), all pairs (P, 8)."""
    C = tris_bw.shape[0]
    lo, hi = _cluster_boxes(nodes, C)
    live = (t_max > 0).nonzero(as_tuple=True)[0]
    step = max(1, PAIR_BUDGET // max(C, 1))
    for s in range(0, live.shape[0], step):
        ids = live[s:s + step]
        oc, dc, tc = o[ids], d[ids], t_max[ids]
        inv = 1.0 / _fix(dc)
        ri, ci = _pairs(oc, inv, tc, lo, hi)
        if ri.numel() == 0:
            continue
        t, u, v, ok = _bw_tests(oc[ri], dc[ri], tris_bw[ci])
        ok = ok & (t < tc[ri][:, None])
        yield ids, ri, ci, t, u, v, ok


def closest_hit_plain(o, d, t_max, nodes, tris_bw):
    """Plain PyTorch closest hit over the packed tables (same contract as
    closest_hit; ties go to the lowest packed id)."""
    n = o.shape[0]
    dev = o.device
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    k8 = torch.arange(LEAF, device=dev)
    for ids, ri, ci, t, u, v, ok in _chunks(o, d, t_max, nodes, tris_bw):
        pid = (ci[:, None] * LEAF + k8[None, :])[ok]
        rr = ri[:, None].expand_as(ok)[ok]
        tt, uu, vv = t[ok], u[ok], v[ok]
        R = ids.shape[0]
        tmin = torch.full((R,), float("inf"), device=dev).scatter_reduce(
            0, rr, tt, "amin")
        at_min = tt == tmin[rr]
        idmin = torch.full((R,), 2**62, dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, rr[at_min], pid[at_min], "amin")
        sel = at_min & (pid == idmin[rr])
        dst = ids[rr[sel]]
        t_best[dst] = tt[sel]
        tri[dst] = pid[sel].to(torch.int32)
        u_best[dst] = uu[sel]
        v_best[dst] = vv[sel]
    return t_best, tri, u_best, v_best


def hit_attributes(o, d, tri, tris_bw):
    """(t, u, v) of each ray against the one packed triangle id it names
    (all tri >= 0), by the kernels' Baldwin-Weber arithmetic. Where the
    kernel and its twin pick different ids, this shows whether the
    kernel's pick is a real hit at the same t (a tie)."""
    tri = tri.to(torch.int64)
    rows = tris_bw[torch.div(tri, LEAF, rounding_mode="floor")]
    t, u, v, _ = _bw_tests(o, d, rows)
    k = (tri % LEAF)[:, None]
    return tuple(x.gather(1, k)[:, 0] for x in (t, u, v))


def anyhit_plain(o, d, t_max, nodes, tris_bw):
    """Plain PyTorch occlusion over the packed tables."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for ids, ri, _, _, _, _, ok in _chunks(o, d, t_max, nodes, tris_bw):
        occ[ids[ri[ok.any(dim=1)]]] = True
    return occ
