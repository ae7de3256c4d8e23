"""The CUDA source of the port's emit kernel (phase 1 of the cut path,
tracerboy_tpu_torch/csrc/cut_emit.cu, emit_kernel) compiled with g++ and
run on host threads, without a card.

tests/torch_cuda_shim/cuda_runtime.h stands in for the CUDA device API
(every thread of a block a host thread, every warp collective a barrier
of the warp's 32 threads, __syncthreads a barrier of the block);
run_emit_kernel.cpp includes the kernel source itself (its host launch
code is guarded by __CUDACC__), picks the staged or the in-place table by
the host entry's own rule (stages_table), makes the grid and the warps'
spans as the host entry does for a given number of resident blocks, and
runs one block after the other. The build uses -ffp-contract=off as the
card's build uses --fmad=false.

Checked: the kernel's (N, K) id table equals trace/cut.py emit_cuts_plain
bit for bit, on the cut tables of the procedural "shadertoy" scene
(scene/compile.py with TB_CUT=1, build_cut at 512 triangles: the main and
the shadow table) through the compact table of cut.compact_rows, with
primary, bounce and shadow rays of the traversal study; dead lanes (t_max
0 and NaN); K = 2 and K = 5, where rays overflow K and slot K-1 holds
n_cuts (K = 5 also writes its rows a word at a time); one ray and ray
counts that fill no warp; grids of one to three blocks; spans of two and
more warps of rays, whose live rays fill a warp's queue past 32; and a
table above the shared-memory budget (20,000 random triangles cut at
16), which the same walk reads in place. No stack overflow, and the
counters are zero again after every launch. The plain version is held to
the JAX package's emit kernel in tests/test_torch_cut.py, and to the
kernel on the card by that file's `cuda` test and by chip_smoke.py.

This says nothing of what nvcc makes of the source, nor of time.
"""

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cut import make_scene
from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.trace import cut, kernels
from tracerboy_tpu_torch.utils import bench_traverse as study

torch.set_num_threads(2)

SHIM = Path(__file__).resolve().parent / "torch_cuda_shim"
STAGED_ROWS = cut.STAGED_BYTES // (4 * cut.CUT_ROW)


@pytest.fixture(scope="module")
def emulated():
    """The kernel's host build: emit(o, d, tm, top, n_cuts, K, resident)
    over torch CPU tensors (the grid the card's host entry makes for
    `resident` resident blocks), returning the ids, the overflow count and
    whether the table was staged in shared memory."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    source = kernels.CSRC / "cut_emit.cu"
    path = build_shared_library_for_host(gxx, source)
    lib = ctypes.CDLL(str(path))
    lib.shim_emit_cut_rows.restype = ctypes.c_int

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    def emit(o, d, tm, top, n_cuts, K, resident=1):
        rows, entries = cut.compact_rows(top)
        o, d, tm, rows = (np.ascontiguousarray(x.numpy())
                          for x in (o, d, tm, rows))
        n = o.shape[0]
        ids = np.full((n, K), -7, np.int32)     # every slot must be written
        state = np.zeros(3, np.uint32)     # ray counter, blocks done, overflow
        staged = lib.shim_emit_cut_rows(
            ptr(o), ptr(d), ptr(tm), ptr(rows), rows.shape[0], entries, n,
            K, n_cuts, ptr(ids), ptr(state[:2]), ptr(state[2:]), resident)
        assert (state[:2] == 0).all()      # zeroed again for the next launch
        return torch.from_numpy(ids), int(state[2]), bool(staged)

    return emit


def build_shared_library_for_host(gxx, source):
    from tracerboy_tpu_torch.utils.build import build_shared_library

    return build_shared_library(
        "tbcut_emit_host", [SHIM / "run_emit_kernel.cpp"],
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off", f"-I{SHIM}", f"-I{kernels.CSRC}"],
        headers=[source, *kernels.HEADERS, SHIM / "cuda_runtime.h"])


@pytest.fixture(scope="module")
def tables():
    """The procedural scene's cut tables (main, shadow) and the study's
    rays on it; a table above the budget with rays inside its cloud."""
    saved = {k: os.environ.get(k) for k in ("TB_CUT", "TB_CUT_TRIS")}
    os.environ["TB_CUT"] = "1"
    os.environ.pop("TB_CUT_TRIS", None)
    try:
        cs = load_scene("shadertoy", film_size=(16, 12))
        scene = cs.as_tensors("cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sets = study.make_ray_sets(cs, 3000, np.random.default_rng(11))
    out = {"main": (scene["pk_cut_top"], scene["pk_cut_roots"]),
           "shadow": (scene["pk_sh_cut_top"], scene["pk_sh_cut_roots"])}
    rays = {k: tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in v)
            for k, v in sets.items()}
    v0, v1, v2 = make_scene(20_000)
    pk, bvh = pack_scene(v0, v1, v2)
    big = cut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size, 16)
    out["big"] = (torch.from_numpy(big["top_nodes"]),
                  torch.from_numpy(big["roots"]))
    rng = np.random.default_rng(4)
    o = (rng.random((300, 3), np.float32) * 20.0)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays["inside"] = (torch.from_numpy(o), torch.from_numpy(d),
                      torch.full((300,), 1e30))
    return out, rays


CASES = {
    # name: (table, ray set, rays, K, dead lanes, resident blocks)
    "main_primary": ("main", "primary", 400, 8, False, 1),
    "main_bounce_dead_nan": ("main", "bounce", 333, 8, True, 2),
    "three_blocks": ("main", "bounce", 400, 8, True, 3),
    "shadow_table": ("shadow", "shadow", 400, 8, True, 1),
    "k2_overflow": ("main", "bounce", 400, 2, False, 1),
    "k5_overflow": ("shadow", "shadow", 211, 5, True, 1),
    "one_ray": ("main", "primary", 1, 8, False, 1),
    "partial_warps": ("main", "bounce", 37, 8, True, 3),
    "long_ranges": ("main", "bounce", 3000, 8, True, 1),
    "above_budget": ("big", "inside", 300, 8, True, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emit_kernel_source_equals_its_plain_version(emulated, tables, case):
    table, ray_set, n, K, dead, resident = CASES[case]
    tops, rays = tables
    top, roots = tops[table]
    S = roots.shape[0] - 1
    o, d, tm = (x[:n].clone() for x in rays[ray_set])
    if dead:
        tm[::3] = 0.0
        tm[1::7] = float("nan")
    got, overflow, staged = emulated(o, d, tm, top, S, K, resident)
    want = cut.emit_cuts_plain(o, d, tm, top, S, K)
    assert torch.equal(got, want)
    assert overflow == 0
    rows, _ = cut.compact_rows(top)
    assert staged == (rows.shape[0] <= STAGED_ROWS)
    assert staged == (table != "big")
    live = tm > 0
    assert (got[~live] == -1).all()
    if n >= 37:
        assert (got[live] >= 0).any()
    if case.startswith("k"):
        assert (got[:, K - 1] == S).any()     # rays with more than K emits
