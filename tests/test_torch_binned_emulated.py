"""The CUDA source of the binned backend's kernels
(tracerboy_tpu_torch/csrc/binned.cu: select_kernel, dense_kernel)
compiled with g++ and run on host threads, without a card.

tests/torch_cuda_shim/cuda_runtime.h stands in for the CUDA device API
(every thread of a block a host thread, every warp collective a barrier
of host threads); run_binned_kernels.cpp includes the kernel source
itself (its host launch code is guarded by __CUDACC__) and runs one block
after the other. The build uses -ffp-contract=off as the card's build uses
--fmad=false.

Checked against the plain versions of trace/binned.py:
- selection: slot_t bit for bit and, per ray, the same clusters at the
  same entry t (clusters at equal entry t may swap slots; where two
  clusters tie at the K-th entry t the set is not unique), the dropped
  bound (K-th nearest entry t <= dropped <= the entry t of every entered
  cluster outside the slots), every output written, no stack overflow; on
  a few hundred rays with dead lanes (t_max 0 and NaN) in counts that fill
  no warp or block, and on the 64-slab scene of
  test_torch_binned_fallback.py where every ray enters 64 clusters;
- dense: t, id, u and v bit for bit on sorted pairs from a selection, and
  on pair lists built to hold runs of one pair, runs longer than a block
  (128 pairs) and blocks that span many runs, with dead and NaN caps.

This says nothing of what nvcc makes of the source, nor of time: the
`cuda` tests of test_torch_binned.py and chip_smoke.py hold the kernels on
the card.
"""

import ctypes
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_binned import _entries, _t, make_rays, make_scene, port_tables
from test_torch_binned_fallback import _ring_tables, ring_rays
from tracerboy_tpu_torch.trace import binned, kernels, traverse
from tracerboy_tpu_torch.trace.kernels import bin_pairs
from tracerboy_tpu_torch.utils.build import build_shared_library

torch.set_num_threads(2)

SHIM = Path(__file__).resolve().parent / "torch_cuda_shim"


@pytest.fixture(scope="module")
def emulated():
    """The kernels' host build: (select(o, d, tm, nodes), dense(o, d, cap,
    cluster, mot, base, blocks)) over tensors, returning numpy outputs
    (and the selection's overflow count)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    source = kernels.CSRC / "binned.cu"
    path = build_shared_library(
        "tbbinned_host", [SHIM / "run_binned_kernels.cpp"],
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off", f"-I{SHIM}", f"-I{kernels.CSRC}"],
        headers=[source, *kernels.HEADERS, SHIM / "cuda_runtime.h"])
    lib = ctypes.CDLL(str(path))

    def arr(x):
        return np.ascontiguousarray(x.numpy())

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    def select(o, d, tm, nodes, blocks=2):
        n = o.shape[0]
        ins = [arr(x) for x in (o, d, tm, nodes)]
        st = np.full((n, binned.KSEL), np.nan, np.float32)
        sc = np.full((n, binned.KSEL), -7, np.int32)
        dr = np.full(n, np.nan, np.float32)
        state = np.zeros(2, np.uint32)          # ray counter, overflow
        lib.shim_select_clusters(*map(ptr, ins), n,
                                 traverse.stack_need(nodes), ptr(st), ptr(sc),
                                 ptr(dr), ptr(state[:1]), ptr(state[1:]),
                                 blocks)
        return (st, sc, dr), int(state[1])

    def dense(o, d, cap, cluster, mot, base):
        m = o.shape[0]
        ins = [arr(x) for x in (o, d, cap, cluster, mot, base)]
        t = np.full(m, np.nan, np.float32)     # every pair must be written
        tri = np.full(m, -7, np.int32)
        u, v = t.copy(), t.copy()
        lib.shim_dense_pairs(*map(ptr, ins), m, ptr(t), ptr(tri), ptr(u),
                             ptr(v))
        return t, tri, u, v

    return select, dense


def _assert_select_matches(got, overflow, o, d, tm, nodes):
    st, sc, dr = got
    pt, pc, _ = binned.select_clusters_plain(o, d, tm, nodes)
    assert overflow == 0
    assert not np.isnan(st).any() and (sc != -7).all()
    np.testing.assert_array_equal(st, pt.numpy())
    # The same (entry t, cluster) pairs per ray, but where clusters tie at
    # the K-th entry t.
    entry = _entries(o, d, tm, nodes)
    kth = torch.where((pc >= 0).all(1), pt.max(1).values, 1e30)
    n_kth = (entry == kth[:, None]).sum(1)
    key_g = np.sort(st.astype(np.float64) * 1e6 + sc, axis=1)
    key_p = np.sort(pt.numpy().astype(np.float64) * 1e6 + pc.numpy(), axis=1)
    same = (key_g == key_p).all(1)
    assert (same | (n_kth.numpy() > 1)).all(), np.flatnonzero(~same)[:10]
    # The dropped bound.
    outside = entry.clone()
    sct = torch.from_numpy(sc)
    rows = torch.arange(o.shape[0])[:, None].expand_as(sct)
    outside[rows[sct >= 0], sct[sct >= 0].long()] = 1e30
    assert (kth.numpy() <= dr).all() and (dr <= outside.min(1).values.numpy()).all()
    return same


SELECT_CASES = {
    # name: (triangles, rays, blocks)
    "one_warp_partial": (300, 21, 1),
    "dead_lanes_three_blocks": (2000, 333, 3),
    "deep_tree": (20_000, 150, 1),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_source_equals_the_plain_version(emulated, case):
    n_tris, n, blocks = SELECT_CASES[case]
    rng = np.random.default_rng(n_tris + n)
    _, scene = port_tables(*make_scene(rng, n_tris))
    o, d, tm = (_t(x) for x in make_rays(rng, n))
    tm[min(5, n - 1)] = float("nan")
    nodes = scene["bn_nodes"]
    select, _ = emulated
    got, overflow = select(o, d, tm, nodes, blocks)
    same = _assert_select_matches(got, overflow, o, d, tm, nodes)
    dead = ~(tm > 0).numpy()
    assert dead.any() and (got[1][dead] == -1).all()
    assert (got[2][dead] == np.float32(1e30)).all()
    assert same.mean() > 0.9 and (got[1] >= 0).any()


def test_select_source_on_rays_through_64_clusters(emulated):
    _, _, scene = _ring_tables()
    o, d, tm = (_t(x[:200]) for x in ring_rays(np.random.default_rng(0)))
    select, _ = emulated
    got, overflow = select(o, d, tm, scene["bn_nodes"])
    _assert_select_matches(got, overflow, o, d, tm, scene["bn_nodes"])
    assert (got[2] == 165.0).all() and (got[1] >= 0).all()


def _dense_equal(got, want):
    for g, w, name in zip(got, want, "t tri u v".split()):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("n_rays", [7, 96])
def test_dense_source_equals_the_plain_version(emulated, n_rays):
    rng = np.random.default_rng(11)
    _, scene = port_tables(*make_scene(rng, 3000))
    o, d, tm = (_t(x) for x in make_rays(rng, n_rays))
    _, slot_c, _ = binned.select_clusters_plain(o, d, tm, scene["bn_nodes"])
    pos, cl = bin_pairs(slot_c)
    ray = torch.div(pos, binned.KSEL, rounding_mode="floor")
    pairs = (o[ray], d[ray], tm[ray], cl, scene["bn_mot"], scene["bn_base"])
    assert cl.shape[0] > 3 * n_rays
    _, dense = emulated
    got = dense(*pairs)
    want = binned.dense_pairs_plain(*pairs)
    _dense_equal(got, want)
    assert (got[1] >= 0).sum() > n_rays // 10


def test_dense_source_on_runs_of_every_length(emulated):
    """Runs of 1 pair, of 300 (longer than a block), many short runs in
    one block, 419 pairs (no whole block at the end); caps of 0 and NaN."""
    rng = np.random.default_rng(12)
    _, scene = port_tables(*make_scene(rng, 3000))
    n_cl = scene["bn_mot"].shape[0]
    lengths = [1, 300, 1, 1, 2, 3, 1, 5, 1, 1, 40, 1, 7, 55]
    cl = np.concatenate([np.full(k, c, np.int32) for c, k in
                         zip(sorted(rng.choice(n_cl, len(lengths),
                                               replace=False)), lengths)])
    m = cl.shape[0]
    o, d, tm = make_rays(rng, m)
    tm[::6] = 1e30
    tm[7] = 0.0
    tm[8] = np.nan
    pairs = (_t(o), _t(d), _t(tm), _t(cl), scene["bn_mot"],
             scene["bn_base"])
    _, dense = emulated
    want = binned.dense_pairs_plain(*pairs)
    _dense_equal(dense(*pairs), want)
    assert want[1][7] == -1 and want[1][8] == -1
    assert (want[1] >= 0).sum() >= 5
