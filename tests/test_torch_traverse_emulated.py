"""The CUDA source of the port's closest-hit, any-hit and traversal-cost
(stats) kernels (tracerboy_tpu_torch/csrc/bvh_traverse.cu: octet_kernel,
traverse_stats_kernel) compiled with g++ and run on host threads, without
a card.

tests/torch_cuda_shim/cuda_runtime.h stands in for the CUDA device API:
every thread of a block is a host thread and every warp collective a
barrier of the warp's 32 threads, which is a faithful model of kernels
whose collectives are all reached by all 32 lanes and name the full warp.
run_octet_kernels.cpp includes the kernel source itself (its host launch
code is guarded by __CUDACC__) and runs one block after the other; the
build uses -ffp-contract=off as the card's build uses --fmad=false.

Checked: the kernels' outputs equal trace/traverse.py octet_walk, the
same walk in plain PyTorch, bit for bit (t, id, u, v; occlusion), on
whole-tree rays, per-ray node and leaf roots, dead lanes (0 and NaN) and
ray counts that fill no ticket, octet, warp or block, from one block and
from several; no stack overflows; every ray gets an output. The twins
closest_hit_plain / anyhit_plain are held to the walk elsewhere
(tests/test_torch_traverse_octet.py), and to the kernels on the card
(the `cuda` tests of tests/test_torch_traverse.py). The stats kernel
(traverse_stats_kernel: a thread per ray in persistent warps) equals
closest_hit_stats_plain bit for bit in all six outputs (t, id, u, v,
pops, clusters) on the same cases without roots, and on rays whose
stacks outgrow its shared-memory window (kTop = 8 entries), so its spill
to local memory runs.

This says nothing of what nvcc makes of the source, nor of time.
"""

import ctypes
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_traverse import (
    _mixed_tmax,
    _t,
    make_rays,
    make_scene,
    mixed_roots,
)
from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import kernels, traverse
from tracerboy_tpu_torch.utils.build import build_shared_library

torch.set_num_threads(2)

SHIM = Path(__file__).resolve().parent / "torch_cuda_shim"


@pytest.fixture(scope="module")
def emulated():
    """The kernels' host build: (closest(o, d, tm, nodes, tris, roots,
    blocks), anyhit(...)) over numpy arrays, returning the outputs and
    the overflow count."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    source = kernels.CSRC / "bvh_traverse.cu"
    path = build_shared_library(
        "tbtraverse_host", [SHIM / "run_octet_kernels.cpp"],
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off", f"-I{SHIM}", f"-I{kernels.CSRC}"],
        headers=[source, *kernels.HEADERS, SHIM / "cuda_runtime.h"])
    lib = ctypes.CDLL(str(path))

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    def common(o, d, tm, nodes, tris, roots):
        return (ptr(o), ptr(d), ptr(tm), ptr(nodes), ptr(tris), ptr(roots),
                o.shape[0], traverse.stack_need(_t(nodes)))

    def closest(o, d, tm, nodes, tris, roots=None, blocks=1):
        n = o.shape[0]
        t = np.full(n, np.nan, np.float32)      # every ray must be written
        tri = np.full(n, -7, np.int32)
        u, v = t.copy(), t.copy()
        state = np.zeros(2, np.uint32)          # ray counter, overflow
        lib.shim_closest_hit(*common(o, d, tm, nodes, tris, roots), ptr(t),
                             ptr(tri), ptr(u), ptr(v), ptr(state[:1]),
                             ptr(state[1:]), blocks)
        return (t, tri, u, v), int(state[1])

    def anyhit(o, d, tm, nodes, tris, roots=None, blocks=1):
        occ = np.full(o.shape[0], 7, np.uint8)
        state = np.zeros(2, np.uint32)
        lib.shim_any_hit(*common(o, d, tm, nodes, tris, roots), ptr(occ),
                         ptr(state[:1]), ptr(state[1:]), blocks)
        return occ, int(state[1])

    def stats(o, d, tm, nodes, tris, blocks=1):
        n = o.shape[0]
        t = np.full(n, np.nan, np.float32)
        u, v = t.copy(), t.copy()
        tri, pops, clusters = (np.full(n, -7, np.int32) for _ in range(3))
        state = np.zeros(2, np.uint32)
        depth = min(traverse.stack_need(_t(nodes)), traverse.STACK_DEPTH)
        lib.shim_closest_hit_stats(
            ptr(o), ptr(d), ptr(tm), ptr(nodes), ptr(tris), n, depth,
            ptr(t), ptr(tri), ptr(u), ptr(v), ptr(pops), ptr(clusters),
            ptr(state[:1]), ptr(state[1:]), blocks)
        return (t, tri, u, v, pops, clusters), int(state[1])

    return closest, anyhit, stats


CASES = {
    # name: (triangles, rays, per-ray roots, dead lanes, blocks)
    "one_node_tree": (37, 64, False, False, 1),
    "one_ray": (300, 1, False, False, 1),
    "one_ticket": (300, 8, False, False, 1),
    "partial_tickets": (300, 33, False, True, 1),
    "roots_and_dead_lanes": (300, 333, True, True, 1),
    "three_blocks": (2000, 203, False, True, 3),
    "roots_three_blocks": (2000, 259, True, True, 3),
    "deep_tree": (20_000, 150, False, True, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_equals_the_octet_walk(emulated, case):
    n_tris, n, rooted, dead, blocks = CASES[case]
    rng = np.random.default_rng(5 + n_tris + n)
    pk, _ = pack_scene(*make_scene(rng, n_tris))
    nodes, tris = pk["nodes"], pk["tris_bw"]
    o, d = make_rays(rng, n)
    tm = _mixed_tmax(rng, n) if dead else np.full(n, 1e30, np.float32)
    if dead and n > 5:
        tm[5] = np.nan
    roots = mixed_roots(rng, _t(nodes), n) if rooted else None
    closest, anyhit, _ = emulated
    (t, tri, u, v), overflow = closest(o, d, tm, nodes, tris, roots, blocks)
    occ, overflow_any = anyhit(o, d, tm, nodes, tris, roots, blocks)
    args = (_t(o), _t(d), _t(tm), _t(nodes), _t(tris),
            None if roots is None else _t(roots))
    want = traverse.octet_walk(*args)
    for got, ref, name in zip((t, tri, u, v), want, "t tri u v".split()):
        np.testing.assert_array_equal(got, ref.numpy(), err_msg=name)
    want_occ = traverse.octet_walk(*args, any_hit=True)[1] >= 0
    assert set(np.unique(occ)) <= {0, 1}, "an occlusion was never written"
    np.testing.assert_array_equal(occ.astype(bool), want_occ.numpy())
    assert overflow == overflow_any == 0
    if n >= 150:
        assert (tri >= 0).any() and not want_occ.all()


# name: (triangles, rays, dead lanes, blocks): the cases above without
# roots, and deep stacks: 20,000 triangles 3 units wide in a 10-unit
# cloud, whose boxes overlap so much that a ray enters most children.
STATS_CASES = {name: (n_tris, n, dead, blocks)
               for name, (n_tris, n, rooted, dead, blocks) in CASES.items()
               if not rooted}
STATS_CASES["deep_stacks"] = (20_000, 64, False, 1)


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_stats_kernel_source_equals_its_twin(emulated, case):
    n_tris, n, dead, blocks = STATS_CASES[case]
    rng = np.random.default_rng(11 + n_tris + n)
    size = 3.0 if case == "deep_stacks" else 0.4
    pk, _ = pack_scene(*make_scene(rng, n_tris, size=size))
    nodes, tris = pk["nodes"], pk["tris_bw"]
    o, d = make_rays(rng, n)
    tm = _mixed_tmax(rng, n) if dead else np.full(n, 1e30, np.float32)
    if dead and n > 5:
        tm[5] = np.nan
    got, overflow = emulated[2](o, d, tm, nodes, tris, blocks)
    want = traverse.closest_hit_stats_plain(_t(o), _t(d), _t(tm), _t(nodes),
                                            _t(tris))
    for a, b, name in zip(got, want, "t tri u v pops clusters".split()):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert overflow == 0
    if case == "deep_stacks":
        # The serial walk's stacks outgrow the kernel's shared-memory
        # window of kTop = 8 entries.
        held = torch.zeros(n, dtype=torch.int64)
        traverse._stack_walk(_t(o), _t(d), _t(tm), _t(nodes), _t(tris),
                             held=held)
        assert int(held.max()) > 8
    if n >= 150:
        assert (got[1] >= 0).any() and (got[4] > 1).any()
