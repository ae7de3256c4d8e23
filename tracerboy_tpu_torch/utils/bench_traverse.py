"""The traversal study: the closest-hit and any-hit kernels timed beside
each other on three ray sets under several ray orders.

    python -m tracerboy_tpu_torch.utils.bench_traverse --scene shadertoy \
        --rays 921600 [--sets primary,bounce,shadow] [--sort none,oct-org]
        [--variants v1,v2,v2any] [--runs 10] [--stats] [--dead-frac 0.3]
        [--wave-film 1280x720] [--wave-spp 8]

The counterpart of the JAX package's scripts/bench_traverse.py. Ray sets
(make_ray_sets, numpy, default_rng(7), the script's own):
- primary: a pinhole camera outside the scene toward a raster grid
  (coherent);
- bounce:  random surface points, random directions in the hemisphere of
  the surface normal (incoherent);
- shadow:  the same points toward one light, t_max capped at the light;
- dead:    the primary rays with t_max = 0 (the fixed cost of a launch);
- wave:    the closest-hit and shadow rays of every bounce of one real
           render_sample(--wave-spp) at --wave-film, dead lanes and all,
           recorded here by wrapping closest_hit and any_hit while a
           Renderer renders (record_wave_rays). Each recorded launch is
           timed again on the tables it was given, through v2 (closest hit)
           or v2any (shadow), in each ray order, with the reorder beside it
           and the sums over the wave last: whether sorting pays inside
           the wave.
- binned-wave: the launches of the binned backend's two kernels in one
           TB_BINNED=1 render_sample(--wave-spp) at --wave-film (its
           bounce waves; record_binned_launches): per selection its lanes,
           live rays, ms and bound; per dense launch its pairs, distinct
           clusters, run lengths, ms, bound and the share of pair-rows that
           pass each stage of the triangle test (dense_row_stages), per
           pair and per group of 32 neighbouring pairs (a warp); the sums
           last. --sort does not apply.
- heatmap-wave: the launches of the stats kernel (closest_hit_stats) in
           one HEATMAP render_sample(1) and one render_sample(--wave-spp)
           at --wave-film (record_stats_launches): the view's primary waves,
           the only launches a render gives that kernel; each timed again
           beside its bound, with its lanes and live rays, and the sum
           last. --sort does not apply.
- cut-wave: the launches of the cut path's emit kernel (trace/cut.py
           emit_cuts) in one TB_CUT=1 render_sample(1) and one
           render_sample(--wave-spp) at --wave-film (record_cut_launches):
           one before every closest-hit wave (the main cut table) and one
           before every shadow wave (the shadow table). Each timed again
           on the card alone (time_runs with ahead: a 921,600-lane launch
           takes the card less time than the host takes to issue it)
           beside its bound (emit_bound), with its lanes, live rays, emits
           per live ray and the rays with more than K emits; sums per
           table and the total last. --sort does not apply.
Ray orders (coherence_sort, numpy, the script's own): none, oct-org,
oct-org-compact, org-oct, org-dir, dir-org.
Variants:
- v1:    the first-generation closest hit (trace/traverse_v1.py);
- v2:    the closest-hit kernel the renderer's waves take
         (trace/traverse.py closest_hit);
- v2any: the any-hit kernel (shadow set only), on the same tables;
- wide:  the lock-step traversal in plain torch (traverse_wide).
The tables are packed here from the scene's triangles (pack_scene with
raw_rows=True), as the script packs its own.

Bounds (bound, walk_ops, select_bound, dense_bound, emit_bound;
chip_smoke.py uses the same): the larger of the bytes a kernel must move
(each ray input read once, each table row its rays need read once, each
output written once) over the H100 SXM's 3.35 TB/s and its float32
operations over 67 TFLOP/s (no tensor cores). The operations per step, counted from
csrc/bvh_common.cuh: a ray's set-up 12 (3 fix_dir, 3 reciprocals), one
child's slab test with its entry test 25, one Baldwin-Weber triangle test
49. The selection counts each live ray's set-up and the root's slab tests
and the coarse rows on the paths from the root to its slots; a dense pair
its set-up and 128 triangle tests, whatever a kernel skips, and the rows of
its pairs' clusters; an emit launch each live ray's set-up, 8 slab tests
a node visit of its walk (emit_walk), the 56 words of each top row the
walk reaches, and of the rays only t_max where a lane is dead.

Each variant is warmed up, then timed --runs times with CUDA events (one
launch per event pair); a line gives the median, the quartiles, Mrays/s at
the median and the hit count, after the card's name and power limit. For
a sorted order the line "reorder" gives what the order costs on the
device beside the kernel: the sort of the keys, the gather of the rays and
the scatter of four outputs back. Where v1 and v2 both ran, a line counts
the rays on which they differ outside ties: the hit sets, and hits of
different triangles at different t (beyond 1e-5 relative). The two use
different triangle tests (Moller-Trumbore with |det| > 1e-9 against
Baldwin-Weber), so a small count is expected and is no fault. The v1
line carries its bound (walk_bound over walk_footprint_v1, MT_OPS a
triangle test). --stats times the stats kernel (closest_hit_stats) on
each set like a variant (a `stats` line: ms, quartiles, Mrays/s, its
bound over walk_footprint) and prints its per-ray pops and leaf clusters
beside the wide traversal's per-ray need (box and triangle tests). The
last line is one JSON object of all results.

On a CPU (--device cpu, small --rays) the wrappers take their plain
versions and the times are host times of those, marked so in the output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SORT_MODES = ("none", "oct-org", "oct-org-compact", "org-oct", "org-dir",
              "dir-org")
TIE_REL = 1e-5
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
RAY_OPS, SLAB_OPS, TRI_OPS = 12, 25, 49
# One Moller-Trumbore test of csrc/bvh_traverse_v1.cu (mt_test and the
# t < best of its caller): two edges 6, d x e2 9, det 5, |det| > eps and
# the reciprocal 3, o - v0 3, u 6, tv x e1 9, v 6, t 6, the five
# acceptance comparisons with u + v 6.
MT_OPS = 59
CLUSTER_TRIS = 128     # triangles a dense pair tests (trace/binned.py)
WARP = 32
# Words of a cut top row that the emit walk reads: 48 box words, 8 ids.
EMIT_ROW_WORDS = 56
# time_runs(ahead=True): clocks the card waits while the host issues the
# timed calls (about 6 ms at the H100's 1.98 GHz).
AHEAD_CYCLES = 12_000_000


def make_ray_sets(cs, n_rays, rng):
    """{primary, bounce, shadow, dead}: (o, d, t_max) numpy triples."""
    v0 = np.asarray(cs.tri_v0)
    v1 = np.asarray(cs.tri_v1)
    v2 = np.asarray(cs.tri_v2)
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2

    # primary: a pinhole outside the scene toward a raster film grid.
    eye = center + np.array([0.0, 0.35, 1.0]) * radius * 2.2
    fw = int(np.sqrt(n_rays * 16 / 9))
    fh = (n_rays + fw - 1) // fw
    ii = np.arange(fw * fh, dtype=np.int64)[:n_rays]
    fx = ((ii % fw) + 0.5) / fw - 0.5
    fy = ((ii // fw) + 0.5) / fh - 0.5
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    span = 1.1 * radius
    target = (center + right * (fx * span * 16 / 9)[:, None]
              + up * (fy * span)[:, None])
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    primary = (np.broadcast_to(eye, (n_rays, 3)).astype(np.float32).copy(),
               d.astype(np.float32), np.full((n_rays,), 1e30, np.float32))

    # bounce: random surface origins, random directions off the surface.
    ti = rng.integers(0, v0.shape[0], n_rays)
    b1 = rng.random(n_rays, dtype=np.float32)
    b2 = rng.random(n_rays, dtype=np.float32)
    flip = b1 + b2 > 1
    b1 = np.where(flip, 1 - b1, b1)
    b2 = np.where(flip, 1 - b2, b2)
    p = (v0[ti] * (1 - b1 - b2)[:, None] + v1[ti] * b1[:, None]
         + v2[ti] * b2[:, None])
    n = np.cross(v1[ti] - v0[ti], v2[ti] - v0[ti])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = np.where((dirs * n).sum(1, keepdims=True) < 0, -dirs, dirs)
    bounce = ((p + n * 1e-4 * radius).astype(np.float32),
              dirs.astype(np.float32), np.full((n_rays,), 1e30, np.float32))

    # shadow: the same origins toward a point light above the scene.
    light = center + np.array([0.3, 1.0, 0.2]) * radius * 1.5
    to_l = light - p
    dist = np.linalg.norm(to_l, axis=1)
    to_l /= dist[:, None]
    shadow = (bounce[0], to_l.astype(np.float32),
              (dist * (1 - 1e-3)).astype(np.float32))
    dead = (primary[0], primary[1], np.zeros((n_rays,), np.float32))
    return dict(primary=primary, bounce=bounce, shadow=shadow, dead=dead)


def _sort_key(o, d, lo, hi, mode, tm=None):
    tm_dead = None if tm is None else (tm <= 0).astype(np.uint64)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip((o - lo) / ext * 1023.0, 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    morton = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    octant = ((d[:, 0] >= 0).astype(np.uint64)
              | ((d[:, 1] >= 0).astype(np.uint64) << 1)
              | ((d[:, 2] >= 0).astype(np.uint64) << 2))
    qd = np.clip((d * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint64)
    dmorton = ((spread(qd[:, 0] << 2) << 2) | (spread(qd[:, 1] << 2) << 1)
               | spread(qd[:, 2] << 2))
    if mode == "oct-org-compact":
        # Dead rays last.
        key = (octant << 30) | morton
        return key | ((tm_dead << 34) if tm_dead is not None else 0)
    if mode == "oct-org":
        return (octant << 30) | morton
    if mode == "org-oct":
        return (morton << 3) | octant
    if mode == "org-dir":
        return (morton << 24) | (dmorton >> 6)
    if mode == "dir-org":
        return (dmorton << 30) | morton
    raise ValueError(mode)


def coherence_sort(o, d, lo, hi, mode="oct-org", tm=None):
    """The permutation that puts rays into the given order: Morton codes
    of the origin (10 bits an axis inside lo..hi), the direction's octant
    or its Morton code, most significant first as the mode names them."""
    if mode == "none":
        return np.arange(o.shape[0])
    return np.argsort(_sort_key(o, d, lo, hi, mode, tm), kind="stable")


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; for a
    CPU run, a label that says so."""
    if device.type != "cuda":
        return "cpu (host times of the plain versions)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_runs(fn, runs: int, device, warmup: int = 2,
              ahead: bool = False) -> np.ndarray:
    """ms of each of `runs` calls of fn after `warmup` calls: CUDA events
    around each call on a card, the host clock on the CPU. A call that
    takes the card less time than the host takes to issue it measures the
    host; with ahead, the card first waits AHEAD_CYCLES clocks
    (torch.cuda._sleep) while the host issues every timed call, so the
    events bracket the card's time alone."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        out = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(out)
    if ahead:
        torch.cuda._sleep(AHEAD_CYCLES)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return np.asarray([s.elapsed_time(e) for s, e in pairs])


def _summary(ms: np.ndarray, n_rays: int) -> dict:
    med = float(np.median(ms))
    return dict(ms=med, q1=float(np.percentile(ms, 25)),
                q3=float(np.percentile(ms, 75)), n=int(ms.size),
                mrays_s=n_rays / med / 1e3)


def differ_outside_ties(a, b) -> dict:
    """Rays on which two closest-hit results (t, tri, u, v) over the same
    tables differ: in the hit set, or by hits of different triangles at
    different t (a tie is a different triangle at the same t within
    TIE_REL)."""
    t_a, tri_a = a[0], a[1]
    t_b, tri_b = b[0], b[1]
    hit_a, hit_b = tri_a >= 0, tri_b >= 0
    both = hit_a & hit_b
    other = both & (tri_a != tri_b)
    tie = other & ((t_a - t_b).abs() <= TIE_REL * t_b.abs())
    return dict(rays=int(t_a.shape[0]), hit_set=int((hit_a != hit_b).sum()),
                only_first=int((hit_a & ~hit_b).sum()),
                only_second=int((hit_b & ~hit_a).sum()),
                other_triangle=int((other & ~tie).sum()),
                ties=int(tie.sum()))


def record_wave_rays(scene, film, spp, device):
    """The traversal launches of one render_sample(spp) of
    Renderer(scene, film) on the default path, in launch order:
    [(kind, o, d, t_max, nodes, tris_bw)], kind "closest" or "shadow".
    closest_hit and any_hit of trace/traverse.py are wrapped while the
    renderer runs, and put back."""
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.trace import traverse

    calls = []
    real = traverse.closest_hit, traverse.any_hit

    def recorder(kind, fn):
        def wrapped(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is None:
                calls.append((kind, o.clone(), d.clone(), t_max.clone(),
                              nodes, tris_bw))
            return fn(o, d, t_max, nodes, tris_bw, roots)
        return wrapped

    r = Renderer(scene, film_size=film, device=str(device))
    r.render_sample(spp)        # warm up; nothing recorded
    traverse.closest_hit = recorder("closest", real[0])
    traverse.any_hit = recorder("shadow", real[1])
    try:
        r.render_sample(spp)
    finally:
        traverse.closest_hit, traverse.any_hit = real
    return calls


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the larger of n_bytes over the memory rate
    and ops float32 operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_ops(live, pops, clusters, nodes, tri_ops=TRI_OPS) -> float:
    """Float32 operations of a stack walk over a node table: each live
    ray's set-up, the slab tests of each popped node's children (the
    table's mean count of valid child slots), the 8 triangle tests of
    each leaf cluster at tri_ops each."""
    from tracerboy_tpu_torch.accel.bvh import INVALID

    children = float((nodes[:, 48:56] != INVALID).sum()) / nodes.shape[0]
    return (live * RAY_OPS + pops * children * SLAB_OPS
            + clusters * 8 * tri_ops)


def walk_bound(o, d, tm, nodes, tris, footprint, out_bytes,
               tri_ops=TRI_OPS):
    """(bound_ms, bound_by, bytes, ops) of a stack walk of these rays:
    the rays in, the node and cluster rows the walk reads (footprint:
    traverse.walk_footprint or traverse_v1.walk_footprint_v1), out_bytes
    a ray out; each live ray's set-up, its pops' slab tests and its
    clusters' triangle tests at tri_ops each."""
    node_rows, cluster_rows, pops, clusters = footprint(o, d, tm, nodes, tris)
    n_bytes = (_nbytes(o, d, tm) + int(node_rows.sum()) * 4 * nodes.shape[1]
               + int(cluster_rows.sum()) * 4 * tris.shape[1]
               + out_bytes * o.shape[0])
    ops = walk_ops(int((tm > 0).sum()), int(pops.sum()),
                   int(clusters.sum()), nodes, tri_ops)
    return (*bound(n_bytes, ops), int(n_bytes), float(ops))


def slot_path_rows(nodes, slot_c):
    """Bool mask of the coarse node rows on the paths from the root to the
    parents of the selected clusters (slot_c >= 0): the rows the
    selection must read to reach its slots."""
    from tracerboy_tpu_torch.accel.bvh import INVALID

    W = nodes.shape[0]
    cid = nodes[:, 48:56].to(torch.int64)
    owner = torch.arange(W, device=nodes.device)[:, None].expand_as(cid)
    parent = torch.full((W,), -1, dtype=torch.int64, device=nodes.device)
    inner = (cid >= 0) & (cid != INVALID)
    parent[cid[inner]] = owner[inner]
    leaf = cid < 0
    cl_parent = torch.full((int((-cid[leaf] - 1).max()) + 1,), -1,
                           dtype=torch.int64, device=nodes.device)
    cl_parent[-cid[leaf] - 1] = owner[leaf]
    seen = torch.zeros(W, dtype=torch.bool, device=nodes.device)
    cur = torch.unique(cl_parent[slot_c[slot_c >= 0].long()])
    while cur.numel():
        seen[cur] = True
        cur = parent[cur]
        cur = torch.unique(cur[cur >= 0])
        cur = cur[~seen[cur]]
    return seen


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def select_bound(o, d, tm, nodes, slot_c):
    """(bytes, operations) of one selection: rays in, the coarse rows on
    the paths to its slots, slot_t, slot_c and dropped out; each live
    ray's set-up and the slab tests of the root's children."""
    rows = int(slot_path_rows(nodes, slot_c).sum())
    live = int((tm > 0).sum())
    n_bytes = (_nbytes(o, d, tm) + rows * nodes[0].numel() * 4
               + (8 * slot_c.shape[1] + 4) * o.shape[0])
    return n_bytes, walk_ops(live, live, 0, nodes)


def dense_bound(o, d, cap, cluster, mot):
    """(bytes, operations) of one dense launch: pairs in, the rows and
    base of their distinct clusters, (t, tri, u, v) out; each pair's
    set-up and 128 triangle tests."""
    n_cl = int(torch.unique(cluster).numel())
    m = cluster.shape[0]
    n_bytes = (_nbytes(o, d, cap, cluster) + n_cl * mot[0].numel() * 4
               + 4 * n_cl + 16 * m)
    return n_bytes, m * (RAY_OPS + CLUSTER_TRIS * TRI_OPS)


def dense_row_stages(o, d, cap, cluster, mot, chunk: int = 1 << 16):
    """How many of a dense launch's pair-rows pass each stage of the
    triangle test, in dense_pairs_plain's arithmetic: `facing` |B| >=
    1e-12 and -A, B of one sign (t > 0), `t` 1e-5 < t < min(cap, the
    nearest hit of the rows before it), `u` u >= -1e-5, `hit` accepted
    (v >= -1e-5, u + v <= 1 + 1e-5) below the nearer hit. Each stage
    counted per pair-row and per (warp, row): a row of a group of 32
    neighbouring pairs where any pair of the group is still in.
    Returns {stage: [per pair-row, per warp-row]} counts and the totals."""
    from tracerboy_tpu_torch.trace.binned import BIG

    stages = ("facing", "t", "u", "hit")
    counts = {k: [0, 0] for k in stages}
    m = cluster.shape[0]
    chunk -= chunk % WARP
    for s in range(0, m, chunk):
        cl = cluster[s:s + chunk].long()
        a, g, h = (mot[cl, k * CLUSTER_TRIS:(k + 1) * CLUSTER_TRIS]
                   for k in range(3))
        ox, oy, oz = (o[s:s + chunk, k:k + 1] for k in range(3))
        dx, dy, dz = (d[s:s + chunk, k:k + 1] for k in range(3))
        A = a[..., 0] * ox + a[..., 1] * oy + a[..., 2] * oz + a[..., 3]
        B = a[..., 0] * dx + a[..., 1] * dy + a[..., 2] * dz
        facing = (A * B < 0) & (B.abs() >= 1e-12)
        t = -A / torch.where(B.abs() < 1e-12, 1e-12, B)
        u = ((g[..., 0] * ox + g[..., 1] * oy + g[..., 2] * oz + g[..., 3])
             + t * (g[..., 0] * dx + g[..., 1] * dy + g[..., 2] * dz))
        v = ((h[..., 0] * ox + h[..., 1] * oy + h[..., 2] * oz + h[..., 3])
             + t * (h[..., 0] * dx + h[..., 1] * dy + h[..., 2] * dz))
        ok = ((t > 1e-5) & (u >= -1e-5) & (v >= -1e-5)
              & (u + v <= 1.0 + 1e-5) & (B.abs() >= 1e-12)
              & (t < cap[s:s + chunk, None]))
        # The nearest accepted hit of the rows before each row.
        near = torch.cummin(torch.where(ok, t, BIG), dim=1).values
        before = torch.cat([torch.full_like(near[:, :1], BIG),
                            near[:, :-1]], dim=1)
        lim = torch.minimum(before, cap[s:s + chunk, None])
        in_t = facing & (t > 1e-5) & (t < lim)
        in_u = in_t & (u >= -1e-5)
        passed = dict(facing=facing, t=in_t, u=in_u, hit=ok & (t < before))
        n = cl.shape[0]
        pad = -n % WARP
        for k, x in passed.items():
            counts[k][0] += int(x.sum())
            xw = torch.cat([x, x.new_zeros((pad, x.shape[1]))]) if pad else x
            counts[k][1] += int(xw.reshape(-1, WARP, x.shape[1]).any(1).sum())
    warps = -(-m // WARP)
    return dict(counts=counts, pair_rows=m * CLUSTER_TRIS,
                warp_rows=warps * CLUSTER_TRIS)


def record_binned_launches(scene, film, spp, device):
    """The selection and dense launches of one TB_BINNED=1
    render_sample(spp) of Renderer(scene, film), in launch order:
    [("select", (o, d, t_max, nodes)) or ("dense", (o, d, cap, cluster,
    mot, base))]. select_clusters and dense_pairs of trace/binned.py are
    wrapped while the renderer runs, and put back; TB_BINNED is restored."""
    import os

    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.trace import binned

    calls = []
    real = binned.select_clusters, binned.dense_pairs

    def select(o, d, t_max, nodes):
        calls.append(("select", (o.clone(), d.clone(), t_max.clone(), nodes)))
        return real[0](o, d, t_max, nodes)

    def dense(*args):
        calls.append(("dense", args))
        return real[1](*args)

    before = os.environ.get("TB_BINNED")
    os.environ["TB_BINNED"] = "1"
    try:
        r = Renderer(scene, film_size=film, device=str(device))
        r.render_sample(spp)        # warm up; nothing recorded
        binned.select_clusters, binned.dense_pairs = select, dense
        try:
            r.render_sample(spp)
        finally:
            binned.select_clusters, binned.dense_pairs = real
    finally:
        if before is None:
            del os.environ["TB_BINNED"]
        else:
            os.environ["TB_BINNED"] = before
    return calls


def emit_walk(o, d, tm, top, chunk=1 << 16):
    """The emit walk over these rays (trace/cut.py emit_cuts; the root of
    every live ray, then each inner child a ray enters within t_max: the
    walk culls by t_max only), by the emit twin's slab test. Returns (node
    visits, the bool mask of the top rows it reads, emits: the emit
    children entered, K or not)."""
    from tracerboy_tpu_torch.accel.bvh import INVALID
    from tracerboy_tpu_torch.trace import traverse

    W = top.shape[0]
    cid = top[:, 48:56].to(torch.int64)
    b = top[:, :48].contiguous().view(torch.float32).reshape(W, 6, 8)
    lo, hi = b[:, 0:3].permute(0, 2, 1), b[:, 3:6].permute(0, 2, 1)
    inv = 1.0 / traverse.fix_dir(d)
    visits = emits = 0
    rows = torch.zeros(W, dtype=torch.bool, device=top.device)
    for s in range(0, o.shape[0], chunk):
        fr = (tm[s:s + chunk] > 0).nonzero(as_tuple=True)[0] + s
        fn = torch.zeros_like(fr)
        while fr.numel():
            visits += fr.numel()
            rows[fn] = True
            t_near, t_far = traverse.box_entry(o[fr][:, None],
                                               inv[fr][:, None], lo[fn],
                                               hi[fn])
            c = cid[fn]
            hit = ((c != INVALID) & (t_far >= torch.clamp_min(t_near, 0.0))
                   & (t_near < tm[fr][:, None]))
            emits += int((hit & (c < 0)).sum())
            ri, si = (hit & (c >= 0)).nonzero(as_tuple=True)
            fr, fn = fr[ri], c[ri, si]
    return visits, rows, emits


def emit_bound(o, d, tm, top, K):
    """(bytes, operations, walk) of one emit launch: t_max of every lane
    and o, d of each live one in (a dead lane's ray is not needed), the
    56 words of every top row the walk reaches, K ids out a lane; each
    live ray's set-up and 8 slab tests a node visit. walk: dict(visits,
    rows, emits) of emit_walk."""
    visits, rows, emits = emit_walk(o, d, tm, top)
    n_rows = int(rows.sum())
    live = int((tm > 0).sum())
    n_bytes = (_nbytes(tm) + 24 * live + n_rows * EMIT_ROW_WORDS * 4
               + 4 * K * o.shape[0])
    ops = live * RAY_OPS + visits * 8 * SLAB_OPS
    return n_bytes, ops, dict(visits=visits, rows=n_rows, emits=emits)


def record_cut_launches(scene, film, spp, device):
    """The emit launches of a TB_CUT=1 Renderer(scene, film): one
    render_sample(n) for each n of spp (an int or a sequence), after one
    render_sample of the first as a warm-up, in launch order: [(table, n,
    (o, d, t_max, top, n_cuts, K))], table "main" (before a closest-hit
    wave) or "shadow" (before a shadow wave). emit_cuts of trace/cut.py is
    wrapped while the renderer runs, and put back; TB_CUT is restored."""
    import os

    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.trace import cut

    spps = (spp,) if isinstance(spp, int) else tuple(spp)
    calls = []
    real = cut.emit_cuts
    before = os.environ.get("TB_CUT")
    os.environ["TB_CUT"] = "1"
    try:
        r = Renderer(scene, film_size=film, device=str(device))
        main_top = r.scene["pk_cut_top"]
        n_now = spps[0]

        def wrapped(o, d, t_max, top, n_cuts, K=8):
            table = "main" if top is main_top else "shadow"
            calls.append((table, n_now, (o.clone(), d.clone(),
                                         t_max.clone(), top, n_cuts, K)))
            return real(o, d, t_max, top, n_cuts, K)

        r.render_sample(spps[0])        # warm up; nothing recorded
        cut.emit_cuts = wrapped
        try:
            for n_now in spps:
                r.render_sample(n_now)
        finally:
            cut.emit_cuts = real
    finally:
        if before is None:
            del os.environ["TB_CUT"]
        else:
            os.environ["TB_CUT"] = before
    return calls


def cut_wave_study(args, device, card, results):
    """The `cut-wave` set: each recorded emit launch timed again (CUDA
    events, --runs each) beside its bound; sums per table and in all."""
    from tracerboy_tpu_torch.trace import cut

    film = tuple(int(x) for x in args.wave_film.split("x"))
    calls = record_cut_launches(args.scene, film, (1, args.wave_spp), device)
    seen = dict(main=0, shadow=0)
    totals = {k: dict(ms=0.0, bound_ms=0.0, launches=0, lanes=0, live=0)
              for k in ("main", "shadow", "total")}
    for table, spp, call in calls:
        label = f"{table}_{seen[table]}"
        seen[table] += 1
        o, d, tm, top, n_cuts, K = call
        ids = cut.emit_cuts(*call)
        res = _summary(time_runs(lambda: cut.emit_cuts(*call), args.runs,
                                 device, ahead=True), o.shape[0])
        n_bytes, ops, walk = emit_bound(o, d, tm, top, K)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, ops)
        live = int((tm > 0).sum())
        res.update(spp=spp, lanes=int(o.shape[0]), live=live,
                   emits_per_live=walk["emits"] / max(live, 1),
                   visits_per_live=walk["visits"] / max(live, 1),
                   rows=walk["rows"],
                   over_k=int((ids[:, K - 1] == n_cuts).sum()),
                   bytes=int(n_bytes), ops=float(ops))
        results[f"{args.scene}/cut-wave/{label}"] = res
        for key in (table, "total"):
            tot = totals[key]
            for k in ("ms", "bound_ms", "lanes", "live"):
                tot[k] += res[k]
            tot["launches"] += 1
        print(f"{card} | {args.scene}/cut-wave/{label}: {res['ms']:.4f} ms "
              f"({res['q1']:.4f} .. {res['q3']:.4f}, n={res['n']}), bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}); "
              f"render_sample({spp}), {res['lanes']} lanes, {live} live, "
              f"{res['emits_per_live']:.2f} emits and "
              f"{res['visits_per_live']:.2f} node visits a live ray, "
              f"{res['rows']} top rows, {res['over_k']} rays over K={K}")
    for key, tot in totals.items():
        results[f"{args.scene}/cut-wave/{key}"] = tot
        print(f"{card} | {args.scene}/cut-wave/{key}: {tot['ms']:.4f} ms "
              f"over {tot['launches']} launches, bound "
              f"{tot['bound_ms']:.4f} ms; {tot['lanes']} lanes, "
              f"{tot['live']} live")


def record_stats_launches(scene, film, spps, device):
    """The stats-kernel launches of a HEATMAP Renderer(scene, film): one
    render_sample(n) for each n of spps, in order: [(o, d, t_max, nodes,
    tris_bw)]. closest_hit_stats of trace/traverse.py is wrapped while
    the renderer runs, and put back."""
    import dataclasses

    from tracerboy_tpu_torch import OutputType, Renderer
    from tracerboy_tpu_torch.trace import traverse

    calls = []
    real = traverse.closest_hit_stats

    def wrapped(o, d, t_max, nodes, tris_bw):
        calls.append((o.clone(), d.clone(), t_max.clone(), nodes, tris_bw))
        return real(o, d, t_max, nodes, tris_bw)

    r = Renderer(scene, film_size=film, device=str(device))
    r.settings = dataclasses.replace(r.settings,
                                     output_type=OutputType.HEATMAP)
    r.render_sample(1)          # warm up; nothing recorded
    traverse.closest_hit_stats = wrapped
    try:
        for n in spps:
            r.render_sample(n)
    finally:
        traverse.closest_hit_stats = real
    return calls


def heatmap_wave_study(args, device, card, results):
    """The `heatmap-wave` set: each recorded stats launch timed again
    (CUDA events, --runs each) beside its bound."""
    from tracerboy_tpu_torch.trace import traverse

    film = tuple(int(x) for x in args.wave_film.split("x"))
    calls = record_stats_launches(args.scene, film, (1, args.wave_spp),
                                  device)
    total = dict(ms=0.0, bound_ms=0.0, launches=0, lanes=0)
    for i, call in enumerate(calls):
        o, d, tm, nodes, tris_bw = call
        res = _summary(time_runs(lambda: traverse.closest_hit_stats(*call),
                                 args.runs, device), o.shape[0])
        res["bound_ms"], res["bound_by"], res["bytes"], res["ops"] = \
            walk_bound(o, d, tm, nodes, tris_bw, traverse.walk_footprint, 24)
        res.update(lanes=int(o.shape[0]), live=int((tm > 0).sum()))
        results[f"{args.scene}/heatmap-wave/stats_{i}"] = res
        for k in ("ms", "bound_ms", "lanes"):
            total[k] += res[k]
        total["launches"] += 1
        print(f"{card} | {args.scene}/heatmap-wave/stats_{i}: "
              f"{res['ms']:.3f} ms ({res['q1']:.3f} .. {res['q3']:.3f}, "
              f"n={res['n']}) = {res['mrays_s']:.1f} Mrays/s, bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}); "
              f"{res['lanes']} lanes, {res['live']} live")
    results[f"{args.scene}/heatmap-wave/total"] = total
    print(f"{card} | {args.scene}/heatmap-wave/total: {total['ms']:.3f} ms "
          f"over {total['launches']} launches, bound "
          f"{total['bound_ms']:.4f} ms")


def binned_wave_study(args, device, card, results):
    """The `binned-wave` set: each recorded selection and dense launch
    timed again (CUDA events, --runs each), beside its bound; the dense
    launches' run lengths and row stages."""
    from tracerboy_tpu_torch.trace import binned

    film = tuple(int(x) for x in args.wave_film.split("x"))
    calls = record_binned_launches(args.scene, film, args.wave_spp, device)
    seen = dict(select=0, dense=0)
    totals = {k: dict(ms=0.0, bound_ms=0.0, launches=0) for k in seen}
    stage_sum: dict = {}
    for kind, call in calls:
        label = f"{kind}_{seen[kind]}"
        seen[kind] += 1
        if kind == "select":
            o, d, tm, nodes = call
            out = binned.select_clusters(o, d, tm, nodes)
            res = _summary(time_runs(lambda: binned.select_clusters(*call),
                                     args.runs, device), o.shape[0])
            n_bytes, ops = select_bound(o, d, tm, nodes, out[1])
            res.update(lanes=int(o.shape[0]), live=int((tm > 0).sum()),
                       slots=int((out[1] >= 0).sum()))
            what = (f"{res['lanes']} lanes, {res['live']} live, "
                    f"{res['slots']} slots filled")
        else:
            o, d, cap, cl, mot, base = call
            res = _summary(time_runs(lambda: binned.dense_pairs(*call),
                                     args.runs, device), o.shape[0])
            n_bytes, ops = dense_bound(o, d, cap, cl, mot)
            runs = torch.unique_consecutive(cl, return_counts=True)[1]
            if not runs.numel():
                runs = torch.zeros(1, dtype=torch.int64)
            rows = dense_row_stages(o, d, cap, cl, mot)
            for k, (per_row, per_warp) in rows["counts"].items():
                acc = stage_sum.setdefault(k, [0, 0])
                acc[0] += per_row
                acc[1] += per_warp
            stage_sum["pair_rows"] = (stage_sum.get("pair_rows", 0)
                                      + rows["pair_rows"])
            stage_sum["warp_rows"] = (stage_sum.get("warp_rows", 0)
                                      + rows["warp_rows"])
            res.update(pairs=int(cl.shape[0]), clusters=int(runs.numel()),
                       run_mean=float(runs.float().mean()),
                       run_min=int(runs.min()), run_max=int(runs.max()),
                       runs_under_32=int((runs < 32).sum()),
                       stages={k: [v[0] / max(rows["pair_rows"], 1),
                                   v[1] / max(rows["warp_rows"], 1)]
                               for k, v in rows["counts"].items()})
            what = (f"{res['pairs']} pairs, {res['clusters']} clusters, runs "
                    f"{res['run_min']} .. {res['run_max']} (mean "
                    f"{res['run_mean']:.0f}, {res['runs_under_32']} under "
                    f"32), rows in (pair / warp) " + ", ".join(
                        f"{k} {a:.3f} / {b:.3f}"
                        for k, (a, b) in res["stages"].items()))
        res["bound_ms"], res["bound_by"] = bound(n_bytes, ops)
        res.update(bytes=int(n_bytes), ops=float(ops))
        results[f"{args.scene}/binned-wave/{label}"] = res
        tot = totals[kind]
        tot["ms"] += res["ms"]
        tot["bound_ms"] += res["bound_ms"]
        tot["launches"] += 1
        print(f"{card} | {args.scene}/binned-wave/{label}: {res['ms']:.3f} ms "
              f"({res['q1']:.3f} .. {res['q3']:.3f}, n={res['n']}), bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}); {what}")
    for kind, tot in totals.items():
        results[f"{args.scene}/binned-wave/total_{kind}"] = tot
        print(f"{card} | {args.scene}/binned-wave/total_{kind}: "
              f"{tot['ms']:.3f} ms over {tot['launches']} launches, bound "
              f"{tot['bound_ms']:.4f} ms")
    if stage_sum:
        share = {k: [v[0] / stage_sum["pair_rows"],
                     v[1] / stage_sum["warp_rows"]]
                 for k, v in stage_sum.items() if isinstance(v, list)}
        results[f"{args.scene}/binned-wave/dense_row_stages"] = share
        print(f"{card} | {args.scene}/binned-wave/dense_row_stages (pair / "
              f"warp): " + ", ".join(f"{k} {a:.3f} / {b:.3f}"
                                     for k, (a, b) in share.items()))


def wave_study(args, device, card, lo, hi, results):
    """The `wave` ray set: every recorded launch in every ray order."""
    from tracerboy_tpu_torch.trace import traverse

    film = tuple(int(x) for x in args.wave_film.split("x"))
    calls = record_wave_rays(args.scene, film, args.wave_spp, device)
    seen = dict(closest=0, shadow=0)
    totals: dict = {}
    for kind, o, d, tm, nodes, tris_bw in calls:
        label = f"{kind}_{seen[kind]}"
        seen[kind] += 1
        fn, vname = ((traverse.closest_hit, "v2") if kind == "closest"
                     else (traverse.any_hit, "v2any"))
        o_np, d_np, tm_np = (x.cpu().numpy() for x in (o, d, tm))
        n = o.shape[0]
        for sort_mode in args.sort.split(","):
            prefix = f"{args.scene}/wave/{label}/{sort_mode}"
            parts = dict(kernel=0.0, reorder=0.0)
            if sort_mode == "none":
                rays = (o, d, tm)
            else:
                key = torch.from_numpy(_sort_key(
                    o_np, d_np, lo, hi, sort_mode, tm_np).astype(np.int64)
                ).to(device)
                order = torch.argsort(key, stable=True)
                rays = tuple(x[order].contiguous() for x in (o, d, tm))
                res = _summary(time_runs(
                    lambda: _reorder(key, (o, d, tm)), args.runs, device), n)
                results[f"{prefix}/reorder"] = res
                parts["reorder"] = res["ms"]
            res = _summary(time_runs(lambda: fn(*rays, nodes, tris_bw),
                                     args.runs, device), n)
            res["live"] = int((tm > 0).sum())
            results[f"{prefix}/{vname}"] = res
            parts["kernel"] = res["ms"]
            print(f"{card} | {prefix}/{vname}: {res['ms']:.3f} ms "
                  f"({res['q1']:.3f} .. {res['q3']:.3f}, n={res['n']}), "
                  f"reorder {parts['reorder']:.3f} ms, {n} lanes, "
                  f"{res['live']} live")
            tot = totals.setdefault((kind, sort_mode),
                                    dict(kernel=0.0, reorder=0.0))
            for k, v in parts.items():
                tot[k] += v
    for (kind, sort_mode), tot in totals.items():
        key = f"{args.scene}/wave/total_{kind}/{sort_mode}"
        results[key] = dict(kernel_ms=tot["kernel"],
                            reorder_ms=tot["reorder"],
                            launches=seen[kind])
        print(f"{card} | {key}: kernels {tot['kernel']:.3f} ms + reorder "
              f"{tot['reorder']:.3f} ms over {seen[kind]} launches")


def _reorder(key, src):
    """What a ray order costs on the device beside the kernel: the sort of
    the keys, the gather of the rays, the scatter of four outputs back."""
    order = torch.argsort(key, stable=True)
    rays = [x[order] for x in src]
    out = [torch.empty_like(rays[2]) for _ in range(4)]
    for buf in out:
        buf[order] = rays[2]
    return out


def build_variants(names, packed, wide_tables):
    """{name: fn(o, d, t_max) -> the variant's full result}."""
    from tracerboy_tpu_torch.trace import traverse, traverse_v1

    nodes, tris, tris_bw = packed["nodes"], packed["tris"], packed["tris_bw"]
    known = {
        "v1": lambda o, d, tm: traverse_v1.closest_hit_v1(o, d, tm, nodes,
                                                          tris),
        "v2": lambda o, d, tm: traverse.closest_hit(o, d, tm, nodes,
                                                    tris_bw),
        "v2any": lambda o, d, tm: traverse.any_hit(o, d, tm, nodes, tris_bw),
        "wide": lambda o, d, tm: traverse.traverse_wide(o, d, tm,
                                                        *wide_tables)[:4],
    }
    unknown = [n for n in names if n not in known]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; the study has "
                         f"{sorted(known)}")
    return {n: known[n] for n in names}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="shadertoy",
                    help="a name load_scene takes: shadertoy, "
                         "shadertoy:cornell")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--rays", type=int, default=1280 * 720)
    ap.add_argument("--variants", default="v1,v2,v2any")
    ap.add_argument("--sets", default="primary,bounce,shadow")
    ap.add_argument("--sort", default="oct-org",
                    help="comma list of " + ",".join(SORT_MODES))
    ap.add_argument("--stats", action="store_true",
                    help="kernel v2's per-ray pops and clusters beside the "
                         "wide traversal's per-ray need")
    ap.add_argument("--dead-frac", type=float, default=0.0,
                    help="kill this share of the rays (t_max = 0); compare "
                         "the orders oct-org and oct-org-compact")
    ap.add_argument("--wave-film", default="1280x720",
                    help="film of the render the `wave` set records")
    ap.add_argument("--wave-spp", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.runs < 1:
        raise SystemExit("--runs must be at least 1")

    from tracerboy_tpu_torch.accel.pack import pack_scene
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import traverse, traverse_v1

    device = torch.device(args.device)
    card = card_line(device)
    t0 = time.time()
    cs = load_scene(args.scene, film_size=(64, 64))
    print(f"[{time.time() - t0:6.1f}s] scene: {cs.tri_v0.shape[0]} tris")
    packed_np, bvh = pack_scene(cs.tri_v0, cs.tri_v1, cs.tri_v2,
                                raw_rows=True)
    print(f"[{time.time() - t0:6.1f}s] packed: nodes "
          f"{packed_np['nodes'].nbytes / 2**20:.1f} MB, tris "
          f"{packed_np['tris'].nbytes / 2**20:.1f} MB")

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    packed = {k: dev(v) for k, v in packed_np.items()}
    tmap = packed_np["tri_map"]
    wide_tables = (dev(bvh.bounds_lo), dev(bvh.bounds_hi),
                   dev(np.asarray(bvh.children).astype(np.int32)),
                   dev(np.asarray(cs.tri_v0)[tmap]),
                   dev(np.asarray(cs.tri_v1)[tmap]),
                   dev(np.asarray(cs.tri_v2)[tmap]), bvh.leaf_size)
    variants = build_variants(args.variants.split(","), packed, wide_tables)

    sets = make_ray_sets(cs, args.rays, np.random.default_rng(7))
    lo = np.asarray(cs.tri_v0).min(0)
    hi = np.asarray(cs.tri_v0).max(0)

    results: dict = dict(device=card, scene=args.scene, rays=args.rays,
                         runs=args.runs)
    for set_name in args.sets.split(","):
        if set_name == "wave":
            wave_study(args, device, card, lo, hi, results)
            continue
        if set_name == "binned-wave":
            binned_wave_study(args, device, card, results)
            continue
        if set_name == "heatmap-wave":
            heatmap_wave_study(args, device, card, results)
            continue
        if set_name == "cut-wave":
            cut_wave_study(args, device, card, results)
            continue
        for sort_mode in args.sort.split(","):
            o, d, tm = sets[set_name]
            if args.dead_frac > 0:
                tm = tm.copy()
                kill = np.random.default_rng(1).random(tm.shape[0])
                tm[kill < args.dead_frac] = 0.0
            perm = coherence_sort(o, d, lo, hi, sort_mode, tm=tm)
            ot, dt, tmt = dev(o[perm]), dev(d[perm]), dev(tm[perm])
            prefix = f"{args.scene}/{set_name}/{sort_mode}"

            if sort_mode != "none":
                key = dev(_sort_key(o, d, lo, hi, sort_mode, tm)
                          .astype(np.int64))
                src = (dev(o), dev(d), dev(tm))
                res = _summary(time_runs(lambda: _reorder(key, src),
                                         args.runs, device), args.rays)
                results[f"{prefix}/reorder"] = res
                print(f"{card} | {prefix}/reorder: {res['ms']:.3f} ms "
                      f"({res['q1']:.3f} .. {res['q3']:.3f}, n={res['n']})")

            if args.stats:
                tables = (packed["nodes"], packed["tris_bw"])
                st = traverse.closest_hit_stats(ot, dt, tmt, *tables)
                cost = traverse.traverse_wide(ot, dt, tmt, *wide_tables)[4]
                live = tmt > 0
                pops, clusters = (x[live].to(torch.float32) for x in st[4:])
                res = _summary(time_runs(
                    lambda: traverse.closest_hit_stats(ot, dt, tmt, *tables),
                    args.runs, device), args.rays)
                res["bound_ms"], res["bound_by"], res["bytes"], \
                    res["ops"] = walk_bound(ot, dt, tmt, *tables,
                                            traverse.walk_footprint, 24)
                res.update(live=int(live.sum()),
                           pops_mean=float(pops.mean()),
                           pops_max=float(pops.max()),
                           clusters_mean=float(clusters.mean()),
                           clusters_max=float(clusters.max()),
                           tests_v2=float((pops.mean() + clusters.mean())
                                          * 8),
                           need_wide=float(cost[live].mean()))
                results[f"{prefix}/stats"] = res
                print(f"{card} | {prefix}/stats: {res['ms']:.3f} ms "
                      f"({res['q1']:.3f} .. {res['q3']:.3f}, n={res['n']}) "
                      f"= {res['mrays_s']:.1f} Mrays/s, bound "
                      f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
                print(f"{card} | {prefix}: v2 pops/ray mean "
                      f"{res['pops_mean']:.2f} max {res['pops_max']:.0f}, "
                      f"clusters/ray mean {res['clusters_mean']:.2f} max "
                      f"{res['clusters_max']:.0f}: {res['tests_v2']:.1f} box "
                      f"and triangle tests a ray, against the wide "
                      f"traversal's need of {res['need_wide']:.1f}")

            outs = {}
            for vname, fn in variants.items():
                if vname == "v2any" and set_name != "shadow":
                    continue
                out = fn(ot, dt, tmt)
                outs[vname] = out
                nhit = (int(out.sum()) if vname == "v2any"
                        else int((out[1] >= 0).sum()))
                res = _summary(
                    time_runs(lambda: fn(ot, dt, tmt), args.runs, device),
                    args.rays)
                res["hits"] = nhit
                bound_text = ""
                if vname == "v1":
                    res["bound_ms"], res["bound_by"], res["bytes"], \
                        res["ops"] = walk_bound(
                            ot, dt, tmt, packed["nodes"], packed["tris"],
                            traverse_v1.walk_footprint_v1, 16, MT_OPS)
                    bound_text = (f", bound {res['bound_ms']:.4f} ms "
                                  f"({res['bound_by']})")
                results[f"{prefix}/{vname}"] = res
                print(f"{card} | {prefix}/{vname}: {res['ms']:.3f} ms "
                      f"({res['q1']:.3f} .. {res['q3']:.3f}, n={res['n']}) "
                      f"= {res['mrays_s']:.1f} Mrays/s  (hits {nhit})"
                      f"{bound_text}")
            if "v1" in outs and "v2" in outs:
                res = differ_outside_ties(outs["v1"], outs["v2"])
                results[f"{prefix}/v1_vs_v2"] = res
                print(f"{card} | {prefix}: v1 and v2 differ outside ties "
                      f"on {res['hit_set'] + res['other_triangle']} of "
                      f"{res['rays']} rays (hit only by v1 "
                      f"{res['only_first']}, only by v2 "
                      f"{res['only_second']}, another triangle at another t "
                      f"{res['other_triangle']}; ties {res['ties']})")

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
