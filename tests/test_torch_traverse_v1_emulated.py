"""The CUDA source of the port's v1 closest-hit kernel
(tracerboy_tpu_torch/csrc/bvh_traverse_v1.cu, traverse_v1_octets)
compiled with g++ and run on host threads, without a card.

tests/torch_cuda_shim/cuda_runtime.h stands in for the CUDA device API
(every thread of a block a host thread, every warp collective a barrier
of the warp's 32 threads); run_v1_kernel.cpp includes the kernel source
itself (its host launch code is guarded by __CUDACC__) and runs one block
after the other. The build uses -ffp-contract=off as the card's build
uses --fmad=false.

Checked: the kernel's outputs equal trace/traverse_v1.py
closest_hit_v1_plain bit for bit (t, id, u, v) on a one-node tree, one
ray, one ticket, ray counts that fill no ticket, octet, warp or block,
dead lanes (t_max 0 and NaN), several blocks, a deep tree, and a cloud of
large triangles whose boxes overlap so much that the stacks grow deep; no
stack overflow; every ray gets an output. The plain version is held to
the JAX package's TPU kernel in tests/test_torch_traverse_v1.py, and to
the kernel on the card by that file's `cuda` test and by chip_smoke.py.

This says nothing of what nvcc makes of the source, nor of time.
"""

import ctypes
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_traverse import _mixed_tmax, _t, make_rays, make_scene
from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import kernels, traverse, traverse_v1
from tracerboy_tpu_torch.utils.build import build_shared_library

torch.set_num_threads(2)

SHIM = Path(__file__).resolve().parent / "torch_cuda_shim"


@pytest.fixture(scope="module")
def emulated():
    """The kernel's host build: closest(o, d, tm, nodes, tris, blocks)
    over numpy arrays, returning the outputs and the overflow count."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    source = kernels.CSRC / "bvh_traverse_v1.cu"
    path = build_shared_library(
        "tbtraverse_v1_host", [SHIM / "run_v1_kernel.cpp"],
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off", f"-I{SHIM}", f"-I{kernels.CSRC}"],
        headers=[source, *kernels.HEADERS, SHIM / "cuda_runtime.h"])
    lib = ctypes.CDLL(str(path))

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    def closest(o, d, tm, nodes, tris, blocks=1):
        n = o.shape[0]
        t = np.full(n, np.nan, np.float32)      # every ray must be written
        tri = np.full(n, -7, np.int32)
        u, v = t.copy(), t.copy()
        state = np.zeros(2, np.uint32)          # ray counter, overflow
        depth = min(traverse.stack_need(_t(nodes)), traverse_v1.STACK_DEPTH)
        lib.shim_closest_hit_v1(ptr(o), ptr(d), ptr(tm), ptr(nodes),
                                ptr(tris), n, depth, ptr(t), ptr(tri),
                                ptr(u), ptr(v), ptr(state[:1]),
                                ptr(state[1:]), blocks)
        return (t, tri, u, v), int(state[1])

    return closest


CASES = {
    # name: (triangles, triangle size, rays, dead lanes, blocks)
    "one_node_tree": (37, 0.4, 64, False, 1),
    "one_ray": (300, 0.4, 1, False, 1),
    "one_ticket": (300, 0.4, 8, False, 1),
    "partial_tickets": (300, 0.4, 33, True, 1),
    "dead_lanes": (300, 0.4, 333, True, 1),
    "three_blocks": (2000, 0.4, 203, True, 3),
    "deep_tree": (20_000, 0.4, 150, True, 2),
    "deep_stacks": (20_000, 3.0, 64, False, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_v1_kernel_source_equals_its_plain_version(emulated, case):
    n_tris, size, n, dead, blocks = CASES[case]
    rng = np.random.default_rng(23 + n_tris + n)
    pk, _ = pack_scene(*make_scene(rng, n_tris, size=size), raw_rows=True)
    nodes, tris = pk["nodes"], pk["tris"]
    o, d = make_rays(rng, n)
    tm = _mixed_tmax(rng, n) if dead else np.full(n, 1e30, np.float32)
    if dead and n > 5:
        tm[5] = np.nan
    got, overflow = emulated(o, d, tm, nodes, tris, blocks)
    kernels.reset_counters()
    want = traverse_v1.closest_hit_v1_plain(_t(o), _t(d), _t(tm), _t(nodes),
                                            _t(tris))
    for a, b, name in zip(got, want, "t tri u v".split()):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert overflow == 0 and kernels.stack_overflows() == 0
    if case == "one_node_tree":
        assert traverse.stack_need(_t(nodes)) == 8     # one level
    if n >= 64:
        assert (got[1] >= 0).any()
    if dead:
        assert (got[1] < 0).any()
