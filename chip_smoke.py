#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tracerboy_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. exit non-zero without a CUDA device (there is no CPU path);
  3. build the kernels (nvcc, sm_90a; one nvcc per source, all at once)
     and print the seconds;
  4. kernel vs plain twin on "shadertoy" at 1280x720: 65,536 rays (half
     primary, half random with finite and zero t_max), closest hit on
     the main BVH and any hit on the shadow BVH, within TOLERANCE; then
     both timed with CUDA events on a full 921,600-ray wave; then both
     against their twins, and timed, on rays in no order at full width:
     the 921,600 bounce and shadow rays of the traversal study's
     make_ray_sets; then the walk the two kernels run
     (traverse.octet_walk, plain PyTorch) beside the serial walk of the
     stats kernel on the primary and the unordered rays: its hits against
     the kernels', its pops, cluster tests and stack entries held beside
     the serial walk's (the boxes the octet order enters in excess);
  5. the stats kernel (closest hit with per-ray traversal counts, the
     HEATMAP view's primary wave) on the 65,536 rays, the 921,600-ray
     primary wave and the study's 921,600 bounce rays in no order: hits
     equal to the stats-free kernel's by that kernel's own tie rule (t
     equal; id, u, v equal outside ties; the two walk in different
     orders), counts equal to its twin's (each mismatching ray listed),
     no stack overflow; timed beside the stats-free kernel and the twin
     on the primary wave and on the unordered rays;
  6. the same for the opt-in paths' kernels on the scene compiled with
     the cut and binned tables (TB_CUT=1, TB_BINNED=1): emit (cut phase
     1), closest and any hit with per-ray roots (cut phase 2), selection
     and dense pairs (binned), on the 65,536 rays and on the 921,600-ray
     primary and shadow waves, each timed beside its twin; then selection
     and dense pairs on every launch of one TB_BINNED=1 render_sample(1)
     at 1280x720 (the bounce waves, the only rays the binned path gives
     them), each against its plain version and timed, with the sums; then
     the emit kernel on every launch of one TB_CUT=1 render_sample(1) at
     1280x720 (one before each closest-hit and each shadow wave), each
     equal to its plain version bit for bit and timed, with the sums, and
     on a cut table too large for its shared memory (TB_CUT_TRIS=64);
  7. the slice: Renderer("shadertoy", (1280, 720)) render_sample(1),
     render_sample(8), current_image(), which must launch both kernels
     and overflow no stack; then "shadertoy:cornell" at 512x512, 4 spp,
     on the brute-force path; then the same render_sample(1) and (8) with
     TB_CUT=1 (and a HEATMAP render_sample(1), whose primary wave must
     still take the stats kernel) and again with TB_BINNED=1, each of
     which must launch its new kernels and overflow no stack; then the
     closest-hit and any-hit launches of one more 8-sample wave of the
     default path, recorded and timed one by one (ms per bounce);
  8. the first-hit AOV slice at 1280x720: render_sample(1) and
     current_image() in every OutputType (and render_sample(8) in LIT
     and HEATMAP), a finite image in [0, 1] each; HEATMAP launches the
     stats kernel once per wave (the primary) and the stats-free kernel
     for the bounces, the other views never the stats kernel; then
     select_pixel, visualize_selected_ray_path (one wave) and
     convergence_error;
  9. the denoiser: the OIDN UNet with the committed rt_ldr_ft.npz
     weights on the slice's resolved 1280x720 image through the Reinhard
     transfer, in bfloat16 and in float32 (finite, (720, 1280, 3); ms per
     call and the bf16-vs-f32 max |d|);
 10. path parity: one renderer's 2-sample merged wave at 128x72 on the
     kernel path against the twin path, and the cut and the binned path
     against the default kernel path, with the CPU tests' tolerance;
 11. the first-generation ("v1") closest-hit kernel against its plain
     version on the 65,536 rays, the 921,600-ray primary wave and the
     study's 921,600 bounce rays in no order (within TOLERANCE, ids
     outside ties, no stack overflow, the tree's stack need inside the
     kernel's stack), timed beside the closest-hit kernel of the waves on
     the primary wave and on the unordered rays; the rays on which the two
     kernels differ (another triangle test: never a failure) are
     counted;
 12. the traversal study (tracerboy_tpu_torch.utils.bench_traverse) at
     921,600 rays on "shadertoy": primary, bounce and shadow rays, in the
     given order and sorted oct-org, through v1, the closest-hit and the
     any-hit kernel; it must launch the v1 kernel and overflow no stack;
 13. RealTime mode at 1280x720: 16 frames of render_realtime_frame_fused
     with a move_camera after the tenth, then 4 of render_realtime_frame
     with a move after the second; every image finite in [0, 1]; the
     share of pixels with a valid history, the live pixel share under the
     adaptive mask, ms per frame and its split into trace and post by
     CUDA events; both traversal kernels must launch; then
     trace_decoupled(8) and the demodulation identity at full width (a
     wave without russian roulette: albedo * D + (I - D) + E against the
     plain wave's radiance, within IDENTITY);
 14. a JSON line of the seven kernels (launches from the run of the path
     each serves, error statistics, ms against plain_ms, the bound the
     card could reach on the same inputs and what sets it), then the
     result line {"ok": true, "device": {...}} last.

Imports nothing of JAX or the JAX package (the UNet weights are a data
file read by path).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_COMPARE = 65_536
FULL_WAVE = (1280, 720)
CORNELL_FILM = (512, 512)
PARITY_FILM = (128, 72)
# Kernel vs twin: both evaluate the same float32 expressions in the same
# order (the kernels are built with --fmad=false), so results agree
# exactly but for rays where rounding in a box test lets one side skip a
# box the other enters, and for exact ties in t (the kernel keeps the
# first triangle found, the twin the lowest id). u and v of the same
# triangle come from the same expressions, hence uv_abs 1e-6.
# Emit: a set mismatch needs a slab test that rounds differently at a
# shared face. Selection: the slot sets differ only where clusters tie at
# the K-th entry t (ties are counted apart); the dropped bound must hold
# on every ray. Dense: the same expressions in the same order, hence
# t_rel and uv_abs 1e-6.
TOLERANCE = dict(hit_mismatch_frac=1e-4, t_rel=1e-6, uv_abs=1e-6,
                 id_mismatch_frac=1e-4, occ_mismatch_frac=1e-4,
                 emit_set_mismatch_frac=1e-4,
                 select_set_mismatch_frac=1e-4,
                 dropped_violations=0, dense_t_rel=1e-6,
                 dense_uv_abs=1e-6)
OPT_IN = ("TB_CUT", "TB_BINNED", "TB_CUT_K", "TB_CUT_TRIS")
# Path parity: the CPU tests' bound between the port and the JAX package.
PARITY = dict(pixel_atol=1e-3, pixel_frac=0.99, mean_rel=1e-4)
# Stats kernel: it keeps the serial walk, the stats-free kernel walks in
# another order, so the two are held together as a kernel and its twin
# are (TOLERANCE; ids outside ties); the stats twin repeats the stats
# kernel's walk, so the counts differ only where a slab test rounds
# otherwise.
STATS_TOLERANCE = dict(count_mismatch_frac=1e-4, overflows=0)
UNET_WEIGHTS = (Path(__file__).resolve().parent / "tracerboy_tpu" / "ml"
                / "weights" / "rt_ldr_ft.npz")
# The bound of a kernel: the larger of its bytes (each ray input read
# once, each table row these rays need read once, each output written
# once) over the H100 SXM's 3.35 TB/s and its float32 operations over 67
# TFLOP/s (no tensor cores): bound, walk_ops, select_bound, dense_bound,
# emit_bound and slot_path_rows of
# tracerboy_tpu_torch/utils/bench_traverse.py, which give the rates and
# the operations per step. The rows: those the walk reads (node rows it
# expands, cluster rows it tests; traverse.walk_footprint and
# bench_traverse.emit_walk), for the selection the coarse rows on the
# paths from the root to its slots, for dense pairs the clusters of its
# pairs.
# The demodulation identity on a wave without russian roulette: the two
# traces take the same paths, so the composite differs from the plain
# radiance by float32 rounding of the split sums only.
IDENTITY = dict(pixel_atol=1e-3, pixel_frac=0.999)
STUDY_ARGS = ["--scene", "shadertoy", "--rays", str(1280 * 720), "--sets",
              "primary,bounce,shadow", "--sort", "none,oct-org",
              "--variants", "v1,v2,v2any", "--runs", "10", "--stats"]
RT_FUSED_FRAMES, RT_MOVE_AFTER, RT_PLAIN_FRAMES = 16, 10, 4
RT_MOVE = dict(forward=0.15, strafe=0.05, yaw=0.02, pitch=-0.01)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        fail("nvidia-smi not found: no NVIDIA driver on this machine")
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_once(fn):
    """(fn(), its ms by CUDA events): one call, no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_bytes(table, rows) -> int:
    """Bytes of the rows of table marked in the bool mask rows."""
    return int(rows.sum()) * table[0].numel() * table.element_size()


def bound_keys(n_bytes, ops) -> dict:
    """The kernels line's bound keys; no single PyTorch call computes a
    BVH traversal, so library_ms is null."""
    from tracerboy_tpu_torch.utils.bench_traverse import bound

    ms, by = bound(n_bytes, ops)
    return dict(bound_ms=ms, bound_by=by, bytes=int(n_bytes), ops=float(ops),
                library_ms=None)


def check_image(name, img):
    shape = (FULL_WAVE[1], FULL_WAVE[0], 3)
    if img.shape != shape:
        fail(f"{name}: image shape {img.shape}, expected {shape}")
    if not (np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
        fail(f"{name}: image is not finite within [0, 1]")


def primary_rays(scene, width, height, pixel_ids, rng):
    """Camera rays through random jitter inside the given pixels."""
    import torch

    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.trace.camera import generate_primary_rays_soa

    dev = pixel_ids.device
    n = pixel_ids.shape[0]
    ju = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    jv = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    o, d = generate_primary_rays_soa(scene["camera"], width, height,
                                     pixel_ids, ju, jv)
    return v3.to_rows(o).contiguous(), v3.to_rows(d).contiguous()


def compare_rays(scene, rng):
    """N_COMPARE rays: half primary, half random inside the scene bounds,
    with t_max finite, infinite (1e30) or 0 (dead)."""
    import torch

    dev = scene["pk_nodes"].device
    w, h = FULL_WAVE
    half = N_COMPARE // 2
    pix = torch.from_numpy(rng.integers(0, w * h, half)).to(dev)
    o1, d1 = primary_rays(scene, w, h, pix, rng)
    lo = scene["world_lo"].cpu().numpy()
    hi = scene["world_hi"].cpu().numpy()
    o2 = lo + (hi - lo) * rng.random((half, 3))
    d2 = rng.normal(size=(half, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    tm = np.full(N_COMPARE, 1e30)
    kind = rng.random(N_COMPARE)
    tm[kind < 0.3] = rng.random(int((kind < 0.3).sum())) * float(
        np.linalg.norm(hi - lo))
    tm[kind > 0.9] = 0.0
    o = torch.cat([o1, torch.from_numpy(o2.astype(np.float32)).to(dev)])
    d = torch.cat([d1, torch.from_numpy(d2.astype(np.float32)).to(dev)])
    return (o.contiguous(), d.contiguous(),
            torch.from_numpy(tm.astype(np.float32)).to(dev))


def _max_abs(a, b):
    return float(np.abs(a - b).max()) if a.size else 0.0


def outside_tie_records(o, d, nodes, tris_bw, k, p, rays):
    """For the given rays (both sides hit, ids differ, not a tie): both
    sides' t and id, and the entry t (t_near) of each side's cluster box
    by the kernels' slab arithmetic. The kernel culls a box whose t_near
    is not below its best hit so far, the twin only by t_max."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    sel = torch.from_numpy(rays).to(o.device)
    lo, hi = traverse.cluster_boxes(nodes, tris_bw.shape[0])
    inv = 1.0 / traverse.fix_dir(d[sel])
    rec = dict(t_kernel=k[0][sel], t_twin=p[0][sel], tri_kernel=k[1][sel],
               tri_twin=p[1][sel])
    for side in ("kernel", "twin"):
        cl = torch.div(rec[f"tri_{side}"].long(), traverse.LEAF,
                       rounding_mode="floor")
        rec[f"box_t_near_{side}"] = traverse.box_entry(o[sel], inv, lo[cl],
                                                       hi[cl])[0]
    cols = {key: val.cpu().tolist() for key, val in rec.items()}
    return [{key: cols[key][i] for key in cols} for i in range(len(rays))]


def check_closest(o, d, tables, k, p, hit_attributes=None):
    """Kernel outputs k against twin outputs p, each (t, tri, u, v), on
    tables (nodes, triangle rows). Where both hit the same id, t, u and v
    are compared; where the ids differ, the kernel's triangle is re-tested
    (hit_attributes, by default traverse.hit_attributes on Baldwin-Weber
    rows): it is a tie if it is hit at the twin's t, and then its u, v are
    compared with the re-test's. Up to 4 id mismatches outside ties are
    listed with their box entry t."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    nodes, tris_bw = tables
    hit_attributes = hit_attributes or traverse.hit_attributes
    t_k, tri_k, u_k, v_k = (x.cpu().numpy() for x in k)
    t_p, tri_p, u_p, v_p = (x.cpu().numpy() for x in p)
    hit_k, hit_p = tri_k >= 0, tri_p >= 0
    both = hit_k & hit_p
    same = both & (tri_k == tri_p)
    diff = np.flatnonzero(both & (tri_k != tri_p))
    sel = torch.from_numpy(diff).to(o.device)
    t_r, u_r, v_r = (x.cpu().numpy() for x in hit_attributes(
        o[sel], d[sel], k[1][sel], tris_bw))
    tie = (t_r == t_k[diff]) & (t_k[diff] == t_p[diff])
    rel = np.abs(t_k[both] - t_p[both]) / np.maximum(np.abs(t_p[both]),
                                                     1e-30)
    uv_err = max(_max_abs(u_k[same], u_p[same]),
                 _max_abs(v_k[same], v_p[same]),
                 _max_abs(u_k[diff], u_r), _max_abs(v_k[diff], v_r))
    stats = dict(
        rays=int(t_k.shape[0]), hits=int(hit_k.sum()),
        hit_mismatch=int((hit_k != hit_p).sum()),
        max_rel_t_err=float(rel.max()) if rel.size else 0.0,
        max_abs_t_err=_max_abs(t_k[both], t_p[both]),
        max_abs_uv_err=uv_err,
        ties=int(tie.sum()),
        id_mismatch_outside_ties=int((~tie).sum()),
    )
    stats["max_abs_err"] = max(stats["max_abs_t_err"], uv_err)
    if stats["id_mismatch_outside_ties"]:
        stats["outside_ties"] = outside_tie_records(
            o, d, nodes, tris_bw, k, p, diff[~tie][:4])
    n = t_k.shape[0]
    ok = (stats["hit_mismatch"] <= TOLERANCE["hit_mismatch_frac"] * n
          and stats["max_rel_t_err"] <= TOLERANCE["t_rel"]
          and uv_err <= TOLERANCE["uv_abs"]
          and stats["id_mismatch_outside_ties"]
          <= TOLERANCE["id_mismatch_frac"] * n)
    return ok, stats


def check_anyhit(k, p):
    occ_k, occ_p = k.cpu().numpy(), p.cpu().numpy()
    mism = int((occ_k != occ_p).sum())
    # max_abs_err: |occlusion difference| (0 or 1) over the rays.
    stats = dict(rays=int(occ_k.shape[0]), occluded=int(occ_k.sum()),
                 occ_mismatch=mism, max_abs_err=float(mism > 0))
    return mism <= TOLERANCE["occ_mismatch_frac"] * occ_k.shape[0], stats


def shadow_rays(scene, o, d, t, tri, rng):
    """Shadow rays from the primary hits toward random points of the
    scene's light triangles (misses become dead lanes)."""
    import torch

    lights = scene["lights"]
    n = o.shape[0]
    L = lights["p0"].shape[0]
    idx = torch.from_numpy(rng.integers(0, L, n)).to(o.device)
    b = torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(o.device)
    flip = b.sum(1, keepdim=True) > 1
    b = torch.where(flip, 1 - b, b)
    p = (lights["p0"][idx] * (1 - b.sum(1, keepdim=True))
         + lights["p1"][idx] * b[:, :1] + lights["p2"][idx] * b[:, 1:])
    hit = tri >= 0
    org = o + d * torch.where(hit, t * 0.999, 0.0)[:, None]
    to = p - org
    dist = torch.linalg.norm(to, dim=1)
    sd = to / dist[:, None]
    tm = torch.where(hit, dist * 0.999, 0.0)
    return org.contiguous(), sd.contiguous(), tm.contiguous()


def set_opt_in(**env):
    """Set the opt-in path variables to env; unset the others. The port
    reads them when a scene is compiled and in Renderer.wave_config."""
    for key in OPT_IN:
        os.environ.pop(key, None)
    os.environ.update(env)


def build_kernels():
    """Build the four kernel libraries at once, one nvcc each."""
    from tracerboy_tpu_torch.trace import binned, cut, traverse, traverse_v1

    modules = (traverse, cut, binned, traverse_v1)
    with ThreadPoolExecutor(len(modules)) as ex:
        for f in [ex.submit(m.build_kernels) for m in modules]:
            f.result()


def study_rays(cs, device):
    """The 921,600 bounce and shadow rays of the traversal study
    (bench_traverse.make_ray_sets, default_rng(7)): surface points in no
    order, toward random directions and toward one light."""
    import torch

    from tracerboy_tpu_torch.utils.bench_traverse import make_ray_sets

    w, h = FULL_WAVE
    sets = make_ray_sets(cs, w * h, np.random.default_rng(7))
    return {name: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in sets[name])
            for name in ("bounce", "shadow")}


def unordered_phase(main_t, shadow_t, rays):
    """Closest hit on the study's bounce rays and any hit on its shadow
    rays, 921,600 each in no order, against the twins and timed. Returns
    (closest statistics, any-hit statistics, times)."""
    from tracerboy_tpu_torch.trace import kernels, traverse

    kernels.reset_counters()
    bo, so = rays["bounce"], rays["shadow"]
    ok_c, st_c = check_closest(
        bo[0], bo[1], main_t, traverse.closest_hit(*bo, *main_t),
        traverse.closest_hit_plain(*bo, *main_t))
    ok_a, st_a = check_anyhit(traverse.any_hit(*so, *shadow_t),
                              traverse.anyhit_plain(*so, *shadow_t))
    overflows = kernels.stack_overflows()
    times = dict(
        closest_ms=cuda_ms(lambda: traverse.closest_hit(*bo, *main_t), 20),
        closest_plain_ms=cuda_ms(lambda: traverse.closest_hit_plain(
            *bo, *main_t), 1, warmup=0),
        anyhit_ms=cuda_ms(lambda: traverse.any_hit(*so, *shadow_t), 20),
        anyhit_plain_ms=cuda_ms(lambda: traverse.anyhit_plain(
            *so, *shadow_t), 1, warmup=0),
        stack_overflows=overflows)
    print("unordered closest kernel vs twin:", json.dumps(st_c))
    print("unordered anyhit kernel vs twin:", json.dumps(st_a))
    print("timing 921,600 unordered rays:", json.dumps(times))
    if not (ok_c and ok_a) or overflows:
        fail(f"kernel disagrees with its twin on unordered rays beyond "
             f"{TOLERANCE}, or overflowed a stack")
    return st_c, st_a, times


def walks_phase(sets):
    """The walk the closest-hit and any-hit kernels run (octet_walk, plain
    PyTorch) on each (label, rays, tables, any_hit) of sets: its hits
    against the kernel's (the same walk: t, id, u, v or the occlusion,
    within TOLERANCE), and its pops, cluster tests and stack entries held
    beside the serial walk's (walk_footprint)."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    ok_all = True
    for label, (o, d, tm), tables, any_hit in sets:
        w = traverse.octet_walk(o, d, tm, *tables, any_hit=any_hit)
        serial = traverse.walk_footprint(o, d, tm, *tables, any_hit=any_hit)
        if any_hit:
            k = traverse.any_hit(o, d, tm, *tables)
            differ = int((k != (w[1] >= 0)).sum())
            ok = differ <= TOLERANCE["occ_mismatch_frac"] * o.shape[0]
        else:
            k = traverse.closest_hit(o, d, tm, *tables)
            differ = int(((k[0] != w[0]) | (k[1] != w[1]) | (k[2] != w[2])
                          | (k[3] != w[3])).sum())
            ok = differ <= TOLERANCE["hit_mismatch_frac"] * o.shape[0]
        live = int((tm > 0).sum())
        st = dict(
            rays=int(o.shape[0]), live=live,
            rays_differing_from_kernel=differ,
            octet=dict(pops=int(w[4].sum()), clusters=int(w[5].sum()),
                       max_held=int(w[6].max())),
            serial=dict(pops=int(serial[2].sum()),
                        clusters=int(serial[3].sum())),
            stack_need=traverse.stack_need(tables[0]))
        st["excess_pops_share"] = (st["octet"]["pops"]
                                   / max(st["serial"]["pops"], 1) - 1)
        st["excess_clusters_share"] = (st["octet"]["clusters"]
                                       / max(st["serial"]["clusters"], 1) - 1)
        print(f"octet walk beside the serial walk, {label}:", json.dumps(st))
        ok_all &= ok and st["octet"]["max_held"] <= st["stack_need"]
        del w, serial, k
        torch.cuda.empty_cache()
    if not ok_all:
        fail("the octet walk disagrees with the kernels, or holds more "
             "stack entries than stack_need allows")


def wave_bounce_phase():
    """The closest-hit and any-hit launches of one 8-sample wave of the
    default path at 1280x720 (7,372,800 lanes), recorded by
    bench_traverse.record_wave_rays and timed one by one: ms per bounce
    and the sums."""
    import torch

    from tracerboy_tpu_torch.trace import traverse
    from tracerboy_tpu_torch.utils.bench_traverse import record_wave_rays

    set_opt_in()
    calls = record_wave_rays("shadertoy", FULL_WAVE, 8, torch.device("cuda"))
    rows = []
    for kind, o, d, tm, nodes, tris in calls:
        fn = traverse.closest_hit if kind == "closest" else traverse.any_hit
        rows.append(dict(kind=kind, lanes=int(o.shape[0]),
                         live=int((tm > 0).sum()),
                         ms=cuda_ms(lambda: fn(o, d, tm, nodes, tris), 5)))
    res = dict(launches=rows,
               closest_ms=sum(r["ms"] for r in rows if r["kind"] == "closest"),
               anyhit_ms=sum(r["ms"] for r in rows if r["kind"] == "shadow"))
    print("traversal per bounce of one 8-spp wave:", json.dumps(res))
    if not rows or not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        fail(f"wave bounce times malformed: {res}")
    return res


def stats_phase(tables, sets, timed):
    """The stats kernel on each (label, (o, d, t_max)) of sets against
    the stats-free kernel (another walk order: compared as a kernel with
    its twin, ids outside ties, within TOLERANCE) and its twin (the hits
    and the counts, each mismatching ray listed), with no stack overflow;
    on each set named in timed (a dict label: key prefix) the kernels are
    timed beside the twin's comparison call ({prefix}_ms,
    {prefix}_free_ms). Returns (statistics by label, times)."""
    import torch

    from tracerboy_tpu_torch.trace import kernels, traverse

    kernels.reset_counters()
    stats, times, ok_all = {}, {}, True
    for label, (o, d, tm) in sets:
        k = traverse.closest_hit_stats(o, d, tm, *tables)
        free = traverse.closest_hit(o, d, tm, *tables)
        p, plain_ms = timed_once(lambda: traverse.closest_hit_stats_plain(
            o, d, tm, *tables))
        n = o.shape[0]
        both = (k[1] >= 0) & (p[1] >= 0)
        cnt_k, cnt_p = torch.stack(k[4:], 1), torch.stack(p[4:], 1)
        mism = (cnt_k != cnt_p).any(1).nonzero(as_tuple=True)[0]
        errs = [(k[j][both] - p[j][both]).abs() for j in (0, 2, 3)]
        errs.append((cnt_k - cnt_p).abs().to(torch.float32))
        st = dict(
            rays=n, live=int((tm > 0).sum()), hits=int((k[1] >= 0).sum()),
            pops=int(k[4].sum()), clusters=int(k[5].sum()),
            max_pops=int(k[4].max()), max_clusters=int(k[5].max()),
            hits_equal_twin=all(torch.equal(a, b)
                                for a, b in zip(k[:4], p[:4])),
            count_mismatch=int(mism.numel()),
            max_abs_err=max(float(e.max()) if e.numel() else 0.0
                            for e in errs))
        if mism.numel():
            rows = torch.cat([mism[:200, None].to(torch.int32),
                              cnt_k[mism[:200]], cnt_p[mism[:200]]], 1)
            st["mismatches"] = [
                dict(ray=r[0], pops_kernel=r[1], clusters_kernel=r[2],
                     pops_twin=r[3], clusters_twin=r[4])
                for r in rows.cpu().tolist()]
        ok_free, st["vs_stats_free"] = check_closest(o, d, tables, free,
                                                     k[:4])
        stats[label] = st
        print(f"stats kernel vs twin, {label}:", json.dumps(st))
        ok_all &= (ok_free and st["count_mismatch"]
                   <= STATS_TOLERANCE["count_mismatch_frac"] * n)
        times[f"{label}_plain_ms"] = plain_ms
    overflows = kernels.stack_overflows()
    for label, (o, d, tm) in sets:
        if label not in timed:
            continue
        times[f"{timed[label]}_ms"] = cuda_ms(
            lambda: traverse.closest_hit_stats(o, d, tm, *tables), 20)
        times[f"{timed[label]}_free_ms"] = cuda_ms(
            lambda: traverse.closest_hit(o, d, tm, *tables), 20)
    times["stack_overflows"] = overflows
    print("timing stats kernel:", json.dumps(times))
    if overflows > STATS_TOLERANCE["overflows"]:
        fail(f"stats phase: {overflows} traversal stack overflows")
    if not ok_all:
        fail(f"the stats kernel disagrees beyond {STATS_TOLERANCE}")
    return stats, times


def check_emit(k, p):
    """Emit kernel ids against the twin's: rays whose sorted subtree sets
    differ, and rays whose slot order differs."""
    n = k.shape[0]
    set_mism = int((k.sort(1).values != p.sort(1).values).any(1).sum())
    # max_abs_err: 1 if any ray's subtree set differs, else 0.
    stats = dict(rays=n, with_emits=int((k >= 0).any(1).sum()),
                 set_mismatch=set_mism,
                 order_mismatch=int((k != p).any(1).sum()),
                 max_abs_err=float(set_mism > 0))
    return set_mism <= TOLERANCE["emit_set_mismatch_frac"] * n, stats


def outside_min_entry(o, d, tm, nodes, slot_c, chunk=1 << 15):
    """Per ray, the least entry t of a cluster it enters outside its
    slots, by an exhaustive box test (1e30 if none)."""
    import torch

    from tracerboy_tpu_torch.trace import binned, traverse

    lo, hi = traverse.cluster_boxes(nodes, binned.n_clusters(nodes))
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    for s in range(0, o.shape[0], chunk):
        sl = slice(s, s + chunk)
        entry = binned.cluster_entries(o[sl], d[sl], tm[sl], lo, hi)
        sc = slot_c[sl]
        rows = torch.arange(sc.shape[0], device=o.device)[:, None]
        keep = sc >= 0
        entry[rows.expand_as(sc)[keep], sc[keep].long()] = 1e30
        out[sl] = entry.min(1).values
    return out


def check_select(o, d, tm, nodes, k, p):
    """Selection kernel against the twin: slot sets (apart from ties at
    the K-th entry t, where the set is not unique), the entry t of the
    slots where the sets agree, and the dropped bound on every ray:
    K-th nearest entry t <= dropped <= every entered cluster outside."""
    import torch

    st_k, sc_k, dr_k = k
    st_p, sc_p, dr_p = p
    full_p = (sc_p >= 0).all(1)
    tie = full_p & (dr_p == torch.where(full_p, st_p.max(1).values, 1e30))
    differ = (sc_k.sort(1).values != sc_p.sort(1).values).any(1)
    kth_k = torch.where((sc_k >= 0).all(1), st_k.max(1).values, 1e30)
    outside = outside_min_entry(o, d, tm, nodes, sc_k)
    violations = int(((kth_k > dr_k) | (dr_k > outside)).sum())
    err = (st_k.gather(1, sc_k.argsort(1))
           - st_p.gather(1, sc_p.argsort(1)))[~differ].abs()
    n = o.shape[0]
    stats = dict(rays=n, slots_filled=int((sc_k >= 0).sum()),
                 set_mismatch=int((differ & ~tie).sum()),
                 ties=int((differ & tie).sum()),
                 dropped_violations=violations,
                 max_abs_err=float(err.max()) if err.numel() else 0.0)
    ok = (stats["set_mismatch"] <= TOLERANCE["select_set_mismatch_frac"] * n
          and violations <= TOLERANCE["dropped_violations"])
    return ok, stats


def check_dense(k, p):
    """Dense kernel against the twin, pair by pair: hit masks, ids (a
    different id at the same t is a tie), t, u and v."""
    t_k, i_k, u_k, v_k = (x.cpu().numpy() for x in k)
    t_p, i_p, u_p, v_p = (x.cpu().numpy() for x in p)
    both = (i_k >= 0) & (i_p >= 0)
    same = both & (i_k == i_p)
    tie = both & (i_k != i_p) & (t_k == t_p)
    rel = np.abs(t_k[both] - t_p[both]) / np.abs(t_p[both])
    uv = max(_max_abs(u_k[same], u_p[same]), _max_abs(v_k[same], v_p[same]))
    n = t_k.shape[0]
    stats = dict(pairs=n, hits=int((i_k >= 0).sum()),
                 hit_mismatch=int(((i_k >= 0) != (i_p >= 0)).sum()),
                 max_rel_t_err=float(rel.max()) if rel.size else 0.0,
                 max_abs_uv_err=uv, ties=int(tie.sum()),
                 id_mismatch_outside_ties=int((both & (i_k != i_p)
                                               & ~tie).sum()))
    stats["max_abs_err"] = max(_max_abs(t_k[both], t_p[both]), uv)
    ok = (stats["hit_mismatch"] <= TOLERANCE["hit_mismatch_frac"] * n
          and stats["max_rel_t_err"] <= TOLERANCE["dense_t_rel"]
          and uv <= TOLERANCE["dense_uv_abs"]
          and stats["id_mismatch_outside_ties"]
          <= TOLERANCE["id_mismatch_frac"] * n)
    return ok, stats


def sorted_pairs(o, d, tm, slot_c):
    """binned_closest's (ray, cluster) pairs of all slots, by cluster."""
    import torch

    from tracerboy_tpu_torch.trace import kernels

    pos, cl = kernels.bin_pairs(slot_c)
    ray = torch.div(pos, slot_c.shape[1], rounding_mode="floor")
    return o[ray], d[ray], tm[ray], cl


def opt_in_kernel_phase(scene, compare, primary, shadow):
    """The cut and binned paths' kernels against their twins on the
    65,536 compare rays and the 921,600-ray primary (closest hit) and
    shadow (any hit) waves; each timed at the wave's shape."""
    import torch

    from tracerboy_tpu_torch.trace import binned, cut, kernels, traverse
    from tracerboy_tpu_torch.utils.bench_traverse import (
        dense_bound,
        emit_bound,
        select_bound,
        slot_path_rows,
    )

    K = 8
    main_t = (scene["pk_nodes"], scene["pk_tris_bw"])
    shadow_t = (scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
    cuts = {"main": (scene["pk_cut_top"], scene["pk_cut_roots"]),
            "shadow": (scene["pk_sh_cut_top"], scene["pk_sh_cut_roots"])}
    nodes = scene["bn_nodes"]
    dense_tables = (scene["bn_mot"], scene["bn_base"])
    stats, times = {}, {}
    ok_all = True

    def pairs(o, d, tm, which):
        top, roots = cuts[which]
        ids = cut.emit_cuts(o, d, tm, top, roots.shape[0] - 1, K)
        pos, key = kernels.bin_pairs(ids)
        ray = torch.div(pos, K, rounding_mode="floor")
        return o[ray], d[ray], tm[ray], roots[key.long()]

    for label, rays, which in (("compare", compare, "main"),
                               ("primary", primary, "main"),
                               ("compare_shadow", compare, "shadow"),
                               ("shadow", shadow, "shadow")):
        o, d, tm = rays
        top, roots = cuts[which]
        S = roots.shape[0] - 1
        ek = cut.emit_cuts(o, d, tm, top, S, K)
        ep = cut.emit_cuts_plain(o, d, tm, top, S, K)
        ok, stats[f"emit_{label}"] = check_emit(ek, ep)
        ok_all &= ok
        po, pd, pt, pr = pairs(o, d, tm, which)
        if which == "main":
            tables = main_t
            ck = traverse.closest_hit(po, pd, pt, *tables, pr)
            cp = traverse.closest_hit_plain(po, pd, pt, *tables, pr)
            ok, stats[f"closest_roots_{label}"] = check_closest(
                po, pd, tables, ck, cp)
        else:
            tables = shadow_t
            ok, stats[f"anyhit_roots_{label}"] = check_anyhit(
                traverse.any_hit(po, pd, pt, *tables, pr),
                traverse.anyhit_plain(po, pd, pt, *tables, pr))
        ok_all &= ok
        if which == "main":
            sk = binned.select_clusters(o, d, tm, nodes)
            sp = binned.select_clusters_plain(o, d, tm, nodes)
            ok, stats[f"select_{label}"] = check_select(o, d, tm, nodes, sk,
                                                        sp)
            ok_all &= ok
            dpairs = sorted_pairs(o, d, tm, sk[1])
            dk = binned.dense_pairs(*dpairs, *dense_tables)
            dp = binned.dense_pairs_plain(*dpairs, *dense_tables)
            ok, stats[f"dense_{label}"] = check_dense(dk, dp)
            ok_all &= ok
        if label == "primary":
            emit_cost = emit_bound(o, d, tm, top, K)
            select_cost = select_bound(o, d, tm, nodes, sk[1])
            dense_cost = dense_bound(*dpairs, dense_tables[0])
            times.update(
                emit_ms=cuda_ms(lambda: cut.emit_cuts(o, d, tm, top, S, K),
                                20),
                emit_plain_ms=cuda_ms(lambda: cut.emit_cuts_plain(
                    o, d, tm, top, S, K), 1, warmup=0),
                closest_roots_ms=cuda_ms(lambda: traverse.closest_hit(
                    po, pd, pt, *tables, pr), 20),
                closest_roots_plain_ms=cuda_ms(
                    lambda: traverse.closest_hit_plain(po, pd, pt, *tables,
                                                       pr), 1, warmup=0),
                closest_roots_rays=int(po.shape[0]),
                select_ms=cuda_ms(lambda: binned.select_clusters(
                    o, d, tm, nodes), 20),
                select_plain_ms=cuda_ms(lambda: binned.select_clusters_plain(
                    o, d, tm, nodes), 1, warmup=0),
                dense_ms=cuda_ms(lambda: binned.dense_pairs(
                    *dpairs, *dense_tables), 20),
                dense_plain_ms=cuda_ms(lambda: binned.dense_pairs_plain(
                    *dpairs, *dense_tables), 1, warmup=0),
                dense_pairs=int(dpairs[3].shape[0]),
                primary_live=int((tm > 0).sum()),
                emit_node_visits=emit_cost[2]["visits"],
                emit_rows=emit_cost[2]["rows"],
                select_rows=int(slot_path_rows(nodes, sk[1]).sum()),
                dense_clusters=int(torch.unique(dpairs[3]).numel()),
                emit_bytes=emit_cost[0], emit_ops=emit_cost[1],
                select_bytes=select_cost[0], select_ops=select_cost[1],
                dense_bytes=dense_cost[0], dense_ops=dense_cost[1])
        if label == "shadow":
            times.update(
                anyhit_roots_ms=cuda_ms(lambda: traverse.any_hit(
                    po, pd, pt, *tables, pr), 20),
                anyhit_roots_plain_ms=cuda_ms(lambda: traverse.anyhit_plain(
                    po, pd, pt, *tables, pr), 1, warmup=0),
                anyhit_roots_rays=int(po.shape[0]))
    for key, value in stats.items():
        print(f"{key} kernel vs twin:", json.dumps(value))
    print("timing opt-in kernels, 921,600-ray waves:", json.dumps(times))
    if not ok_all:
        fail(f"an opt-in kernel disagrees with its twin beyond {TOLERANCE}")
    return stats, times


def binned_bounce_phase():
    """The selection and dense kernels against their plain versions on the
    launches of one TB_BINNED=1 render_sample(1) at 1280x720 (its bounce
    waves; bench_traverse.record_binned_launches), each compared with
    check_select / check_dense and timed (CUDA events), beside its bound.
    Returns (statistics by launch, sums: ms, plain ms, bound ms, launches
    of each kernel)."""
    import torch

    from tracerboy_tpu_torch.trace import binned, kernels
    from tracerboy_tpu_torch.utils.bench_traverse import (
        bound,
        dense_bound,
        record_binned_launches,
        select_bound,
    )

    set_opt_in()
    calls = record_binned_launches("shadertoy", FULL_WAVE, 1,
                                   torch.device("cuda"))
    stats, ok_all = {}, True
    sums = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
            for k in ("select", "dense")}
    seen = dict(select=0, dense=0)
    for kind, call in calls:
        label = f"{kind}_{seen[kind]}"
        seen[kind] += 1
        kernels.reset_counters()
        if kind == "select":
            o, d, tm, nodes = call
            got = binned.select_clusters(*call)
            want, plain_ms = timed_once(
                lambda: binned.select_clusters_plain(*call))
            ok, st = check_select(o, d, tm, nodes, got, want)
            st["stack_overflows"] = kernels.stack_overflows()
            ok &= st["stack_overflows"] == 0
            ms = cuda_ms(lambda: binned.select_clusters(*call), 10)
            cost = select_bound(o, d, tm, nodes, got[1])
            st.update(lanes=int(o.shape[0]), live=int((tm > 0).sum()))
        else:
            got = binned.dense_pairs(*call)
            want, plain_ms = timed_once(
                lambda: binned.dense_pairs_plain(*call))
            ok, st = check_dense(got, want)
            ms = cuda_ms(lambda: binned.dense_pairs(*call), 10)
            cost = dense_bound(*call[:5])
        st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound(*cost)[0])
        stats[label] = st
        ok_all &= ok
        for k in ("ms", "plain_ms", "bound_ms"):
            sums[kind][k] += st[k]
        sums[kind]["launches"] += 1
        print(f"binned bounce launch {label} kernel vs plain:", json.dumps(st))
    print("binned bounce launches of render_sample(1):", json.dumps(sums))
    if not all(sums[k]["launches"] > 0 for k in sums):
        fail(f"the binned render launched no bounce selection or dense: {sums}")
    if not ok_all:
        fail(f"a binned kernel disagrees with its plain version on the bounce "
             f"launches beyond {TOLERANCE}, or overflowed its stack")
    return stats, sums


def cut_bounce_phase():
    """The emit kernel against its plain version on every launch of one
    TB_CUT=1 render_sample(1) at 1280x720 (one before each closest-hit and
    each shadow wave; bench_traverse.record_cut_launches): the id tables
    equal bit for bit (no set and no order mismatch) and no stack
    overflow, each launch timed (CUDA events) beside its bound
    (bench_traverse.emit_bound). Then a cut table too large for the
    kernel's shared memory (TB_CUT_TRIS=64, read in place by the same
    walk) on the first closest-hit and shadow launches' rays, equal bit for
    bit too. Returns (statistics by launch, sums: ms, plain ms, bound ms,
    launches, and the large table's rows and ms)."""
    import torch

    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import cut, kernels
    from tracerboy_tpu_torch.utils.bench_traverse import (
        bound,
        emit_bound,
        record_cut_launches,
    )

    set_opt_in()
    calls = record_cut_launches("shadertoy", FULL_WAVE, 1,
                                torch.device("cuda"))
    stats, ok_all = {}, True
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
    seen = dict(main=0, shadow=0)
    firsts = {}
    for table, _, call in calls:
        label = f"{table}_{seen[table]}"
        seen[table] += 1
        firsts.setdefault(table, call)
        kernels.reset_counters()
        got = cut.emit_cuts(*call)
        want, plain_ms = timed_once(lambda: cut.emit_cuts_plain(*call))
        _, st = check_emit(got, want)
        st["stack_overflows"] = kernels.stack_overflows()
        ok_all &= (st["set_mismatch"] == 0 and st["order_mismatch"] == 0
                   and st["stack_overflows"] == 0)
        o, d, tm, top, _, K = call
        st.update(lanes=int(o.shape[0]), live=int((tm > 0).sum()),
                  ms=cuda_ms(lambda: cut.emit_cuts(*call), 10),
                  plain_ms=plain_ms,
                  bound_ms=bound(*emit_bound(o, d, tm, top, K)[:2])[0])
        stats[label] = st
        for k in ("ms", "plain_ms", "bound_ms"):
            sums[k] += st[k]
        sums["launches"] += 1
        print(f"cut bounce launch {label} kernel vs plain:", json.dumps(st))

    # A table above the shared-memory budget: the same walk, in place.
    set_opt_in(TB_CUT="1", TB_CUT_TRIS="64")
    big = load_scene("shadertoy", film_size=FULL_WAVE).as_tensors("cuda")
    set_opt_in()
    sums.update(over_budget_rows=0, over_budget_ms=0.0)
    for table, prefix in (("main", "pk_"), ("shadow", "pk_sh_")):
        top = big[prefix + "cut_top"]
        o, d, tm, _, _, K = firsts[table]
        S = int(big[prefix + "cut_roots"].shape[0]) - 1
        rows = int(cut.compact_rows(top)[0].shape[0])
        kernels.reset_counters()
        got = cut.emit_cuts(o, d, tm, top, S, K)
        _, st = check_emit(got, cut.emit_cuts_plain(o, d, tm, top, S, K))
        st.update(stack_overflows=kernels.stack_overflows(), rows=rows,
                  staged=rows * cut.CUT_ROW * 4 <= cut.STAGED_BYTES,
                  ms=cuda_ms(lambda: cut.emit_cuts(o, d, tm, top, S, K), 10))
        ok_all &= (st["set_mismatch"] == 0 and st["order_mismatch"] == 0
                   and st["stack_overflows"] == 0 and not st["staged"])
        stats[f"over_budget_{table}"] = st
        sums["over_budget_rows"] = max(sums["over_budget_rows"], rows)
        sums["over_budget_ms"] += st["ms"]
        print(f"cut table above the budget, {table} (TB_CUT_TRIS=64) "
              f"kernel vs plain:", json.dumps(st))
    print("cut bounce launches of render_sample(1):", json.dumps(sums))
    if sums["launches"] == 0 or seen["shadow"] == 0:
        fail(f"the cut render launched no emit on both tables: {seen}")
    if not ok_all:
        fail("the emit kernel differs from its plain version on a launch "
             "of the cut render or on the table above the budget, or "
             "overflowed its stack")
    return stats, sums


def render_slice(torch, Renderer, name, env, required, heatmap=False):
    """Renderer("shadertoy", (1280, 720)) under the opt-in variables env:
    render_sample(1), render_sample(8), current_image(), with the launch
    counts set to 0 just before and read just after. Every kernel in
    `required` must launch, and no stack may overflow. With heatmap, one
    more render_sample(1) in the HEATMAP view, whose primary wave must
    take the stats kernel once."""
    from tracerboy_tpu_torch.trace import binned, cut, kernels

    set_opt_in(**env)
    kernels.reset_counters()
    cut.reset_stats()
    binned.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
    cfg = r.wave_config()
    if (cfg.cut, cfg.binned_bounces) != ("TB_CUT" in env,
                                         "TB_BINNED" in env):
        fail(f"{name}: wave config cut={cfg.cut} "
             f"binned_bounces={cfg.binned_bounces} under {env}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_sample(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rays1 = r.rays_traced
    r.render_sample(8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    img = r.current_image()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    overflow = kernels.stack_overflows()
    acc = r.state.accum
    mean = float(acc[..., :3].mean())
    if not bool(torch.isfinite(acc).all()):
        fail(f"{name}: accumulator is not finite")
    if not mean > 0:
        fail(f"{name}: accumulator mean {mean} is not positive")
    check_image(name, img)
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        fail(f"{name}: the slice did not launch {missing}: {launches}")
    if overflow != 0:
        fail(f"{name}: {overflow} traversal stack overflows")
    rays8 = r.rays_traced - rays1
    results = dict(
        env=env, spp=r.state.spp, accum_mean=mean, launches=launches,
        stack_overflows=overflow, rays_traced=r.rays_traced,
        s_sample1=t1 - t0, s_per_sample_8=(t2 - t1) / 8,
        mrays_s_sample1=rays1 / (t1 - t0) / 1e6,
        mrays_s_8=rays8 / (t2 - t1) / 1e6,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    if "TB_CUT" in env:
        results["emit_overflow_share"] = (int(cut.STATS["overflow_rays"])
                                          / max(int(cut.STATS["rays"]), 1))
    if "TB_BINNED" in env:
        results["binned_fallback_share"] = (
            int(binned.STATS["fallback_rays"])
            / max(int(binned.STATS["rays"]), 1))
    if heatmap:
        from dataclasses import replace

        from tracerboy_tpu_torch import OutputType

        r.settings = replace(r.settings, output_type=OutputType.HEATMAP)
        kernels.reset_counters()
        r.render_sample(1)
        check_image(f"{name} HEATMAP", r.current_image())
        torch.cuda.synchronize()
        hl = dict(kernels.LAUNCHES)
        if hl["closest_stats"] != 1 or any(hl[k] <= 0 for k in required):
            fail(f"{name} HEATMAP: launches {hl}, expected closest_stats 1 "
                 f"and {required}")
        if kernels.stack_overflows():
            fail(f"{name} HEATMAP: traversal stack overflows")
        results["heatmap_launches"] = hl
    print(f"render shadertoy 1280x720 {name}:", json.dumps(results))
    del r
    set_opt_in()
    return results, launches


def cornell_phase(torch, Renderer):
    c = Renderer("shadertoy:cornell", film_size=CORNELL_FILM,
                 device="cuda")
    if c.traversal != "brute":
        fail(f"cornell took the {c.traversal} path, not brute force")
    t0 = time.perf_counter()
    c.render_sample(4)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cacc = c.state.accum
    cmean = float(cacc[..., :3].mean())
    if not (bool(torch.isfinite(cacc).all()) and cmean > 0):
        fail(f"cornell accumulator not finite/positive (mean {cmean})")
    cimg = c.current_image()
    if (cimg.shape != (CORNELL_FILM[1], CORNELL_FILM[0], 3)
            or not np.isfinite(cimg).all()):
        fail("cornell image malformed")
    print("render cornell 512x512 4 spp (brute):", json.dumps(dict(
        accum_mean=cmean, s_per_sample=(t1 - t0) / 4,
        mrays_s=c.rays_traced / (t1 - t0) / 1e6)))


def aov_slice_phase(torch, Renderer):
    """The first-hit AOV slice on one renderer at 1280x720: every
    OutputType's render_sample(1) (and (8) in LIT and HEATMAP) and
    current_image(), with the launch counts set to 0 just before each
    render and read just after; then pixel inspection and the ray-path
    overlay in LIT. Returns (renderer, results, stats kernel launches of
    the HEATMAP renders)."""
    from dataclasses import replace

    from tracerboy_tpu_torch import OutputType
    from tracerboy_tpu_torch.trace import kernels

    set_opt_in()
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
    bounces = r.wave_config().max_bounces
    results, heat_launches = {}, 0
    for view in OutputType:
        r.settings = replace(r.settings, output_type=view)
        heat = view == OutputType.HEATMAP
        eight = view in (OutputType.LIT, OutputType.HEATMAP)
        for n in (1, 8) if eight else (1,):
            kernels.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_sample(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_image(f"{view.name} {n} spp", r.current_image())
            # Either call traces one wave at this film size (8 samples
            # merge into one 7.4M-lane wave): one closest hit per bounce,
            # the primary's through the stats kernel in HEATMAP.
            want = dict(closest_stats=int(heat),
                        closest=bounces - int(heat))
            got = {k: launches[k] for k in want}
            if got != want:
                fail(f"{view.name} render_sample({n}): launches {got}, "
                     f"expected {want}")
            heat_launches += launches["closest_stats"]
            results[f"{view.name}_{n}"] = dict(
                s_per_sample=dt / n, peak_gib=peak,
                closest_stats=launches["closest_stats"],
                closest=launches["closest"], anyhit=launches["anyhit"])
    if kernels.stack_overflows():
        fail("AOV slice: traversal stack overflows")

    r.settings = replace(r.settings, output_type=OutputType.LIT)
    x, y = FULL_WAVE[0] // 2, FULL_WAVE[1] // 2
    sel = r.select_pixel(x, y)
    if set(sel) != {"material_id", "depth", "albedo", "normal",
                    "world_pos"} or not all(
            np.isfinite(sel[k]).all()
            for k in ("depth", "albedo", "normal", "world_pos")):
        fail(f"select_pixel({x}, {y}) malformed: {sel}")
    kernels.reset_counters()
    overlay = r.visualize_selected_ray_path(x, y)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if (launches["closest"], launches["closest_stats"]) != (bounces, 0):
        fail(f"visualize_selected_ray_path: launches {launches}, expected "
             f"one wave")
    check_image("visualize_selected_ray_path", overlay)
    drawn = int((overlay != r.current_image()).any(-1).sum())
    if drawn == 0:
        fail("visualize_selected_ray_path drew no path")
    err = r.convergence_error()
    if not (np.isfinite(err) and err >= 0):
        fail(f"convergence_error {err}")
    results["inspection"] = dict(
        pixel=[x, y], material_id=sel["material_id"],
        depth=sel["depth"], overlay_pixels_drawn=drawn,
        convergence_error=err, spp=r.state.spp)
    print("AOV slice shadertoy 1280x720:", json.dumps(results))
    return r, results, heat_launches


def denoise_phase(torch, lin):
    """The OIDN UNet with the committed fine-tuned weights on the linear
    image lin (H, W, 3) through the Reinhard transfer, in bfloat16 and in
    float32: finite outputs of lin's shape, warm ms per call (CUDA
    events) and the bf16-vs-f32 max |d| in the network's [0, 1] space and
    in linear radiance."""
    from tracerboy_tpu_torch.ml.finetune import (
        load_params_npz,
        reinhard_fwd,
        reinhard_inv,
    )
    from tracerboy_tpu_torch.ml.oidn import denoise_image

    enc = reinhard_fwd(lin)
    dens, res = {}, dict(shape=list(lin.shape))
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        net = load_params_npz(str(UNET_WEIGHTS), dtype).to(lin.device)
        den = denoise_image(net, enc)
        out = reinhard_inv(den)
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(lin.shape):
            fail(f"denoise {name}: shape {tuple(out.shape)}")
        if not (bool(torch.isfinite(out).all()) and float(out.min()) >= 0):
            fail(f"denoise {name}: output not finite and non-negative")
        res[f"{name}_ms"] = cuda_ms(lambda: denoise_image(net, enc), 5,
                                    warmup=2)
        dens[name] = (den, out)
        del net
    res["bf16_vs_f32_max_abs"] = float(
        (dens["bf16"][0] - dens["f32"][0]).abs().max())
    res["bf16_vs_f32_max_abs_linear"] = float(
        (dens["bf16"][1] - dens["f32"][1]).abs().max())
    res["input_vs_f32_mean_abs"] = float((dens["f32"][0] - enc).abs().mean())
    print("denoise 1280x720 (rt_ldr_ft.npz, Reinhard):", json.dumps(res))
    return res


def parity_phase(torch, Renderer):
    """One renderer's 2-sample merged wave (what render_sample(2)
    accumulates) on the kernel path against the twin path, and on the
    cut and binned paths against the default kernel path."""
    from dataclasses import replace

    from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

    set_opt_in(TB_CUT="1", TB_BINNED="1")
    r = Renderer("shadertoy", film_size=PARITY_FILM, device="cuda")
    set_opt_in()
    if r.traversal != "kernel":
        fail(f"shadertoy took the {r.traversal} path, not the kernels")
    cfg, params = r.wave_config(), r.frame_params()
    paths = {"kernel": replace(cfg, cut=False, binned_bounces=False)}
    paths["twin"] = replace(paths["kernel"], traversal="twin")
    paths["cut"] = replace(paths["kernel"], cut=True)
    paths["binned"] = replace(paths["kernel"], binned_bounces=True)
    accs = {}
    for path, pcfg in paths.items():
        out = render_wave_merged(r.scene, params, r.pixel_ids, 0, 2, pcfg)
        accs[path] = torch.cat([out["radiance"],
                                out["filter_weight"][:, None]],
                               dim=1).cpu().numpy()
    for path, ref_path in (("kernel", "twin"), ("cut", "kernel"),
                           ("binned", "kernel")):
        ref, got = accs[ref_path], accs[path]
        close = (np.abs(got - ref) <= PARITY["pixel_atol"]
                 * (1 + np.abs(ref))).all(-1).mean()
        mean_rel = abs(got.mean() - ref.mean()) / abs(ref.mean())
        stats = dict(pixels_within=float(close), mean_rel=float(mean_rel))
        print(f"path parity {path} vs {ref_path} 128x72 2 spp:",
              json.dumps(stats))
        if close < PARITY["pixel_frac"] or mean_rel > PARITY["mean_rel"]:
            fail(f"path parity {path} vs {ref_path} outside tolerance: "
                 f"{stats}")


def v1_phase(cs, scene, compare, primary, unordered):
    """The first-generation closest-hit kernel against its plain version
    on the compare rays, the primary wave and the unordered bounce rays,
    over the raw 9-float rows packed from the scene's triangles (the node
    table must be the scene's); timed beside the closest-hit kernel of the
    waves on the primary wave and the unordered rays. Returns (statistics
    by label, times, bound keys of the primary wave)."""
    import torch

    from tracerboy_tpu_torch.accel.pack import pack_scene
    from tracerboy_tpu_torch.trace import kernels, traverse, traverse_v1
    from tracerboy_tpu_torch.utils.bench_traverse import (
        MT_OPS,
        differ_outside_ties,
        walk_ops,
    )

    pk, _ = pack_scene(cs.tri_v0, cs.tri_v1, cs.tri_v2, raw_rows=True)
    nodes = scene["pk_nodes"]
    if not torch.equal(torch.from_numpy(pk["nodes"]).to(nodes.device), nodes):
        fail("v1: the repacked node table is not the scene's")
    tris = torch.from_numpy(pk["tris"]).to(nodes.device)
    need = traverse.stack_need(nodes)
    if need > traverse_v1.STACK_DEPTH:
        fail(f"v1: the tree can ask for {need} stack entries, the kernel "
             f"has {traverse_v1.STACK_DEPTH}")
    stats, times, ok_all = {}, dict(stack_need=need), True
    for label, (o, d, tm) in (("compare", compare), ("primary", primary),
                              ("unordered", unordered)):
        kernels.reset_counters()
        k = traverse_v1.closest_hit_v1(o, d, tm, nodes, tris)
        overflows = kernels.stack_overflows()      # the kernel's alone
        p, plain_ms = timed_once(lambda: traverse_v1.closest_hit_v1_plain(
            o, d, tm, nodes, tris))
        ok, st = check_closest(o, d, (nodes, tris), k, p,
                               traverse_v1.hit_attributes_v1)
        st["stack_overflows"] = overflows
        # Another triangle test than the waves' kernel: counted, no failure.
        st["differs_from_closest_hit"] = differ_outside_ties(
            k, traverse.closest_hit(o, d, tm, nodes, scene["pk_tris_bw"]))
        stats[label] = st
        times[f"{label}_plain_ms"] = plain_ms
        ok_all &= ok and overflows == 0
        print(f"v1 closest kernel vs plain, {label}:", json.dumps(st))
    uo, ud, utm = unordered
    times.update(
        unordered_ms=cuda_ms(lambda: traverse_v1.closest_hit_v1(
            uo, ud, utm, nodes, tris), 20),
        unordered_closest_ms=cuda_ms(lambda: traverse.closest_hit(
            uo, ud, utm, nodes, scene["pk_tris_bw"]), 20))
    o, d, tm = primary
    node_rows, cluster_rows, pops, clusters = traverse_v1.walk_footprint_v1(
        o, d, tm, nodes, tris)
    live = int((tm > 0).sum())
    times.update(
        v1_ms=cuda_ms(lambda: traverse_v1.closest_hit_v1(o, d, tm, nodes,
                                                         tris), 20),
        closest_ms=cuda_ms(lambda: traverse.closest_hit(
            o, d, tm, nodes, scene["pk_tris_bw"]), 20),
        node_rows=int(node_rows.sum()), cluster_rows=int(cluster_rows.sum()),
        pops=int(pops.sum()), clusters=int(clusters.sum()),
        max_pops=int(pops.max()), max_clusters=int(clusters.max()))
    print("timing v1 kernel, 921,600-ray primary wave and unordered rays:",
          json.dumps(times))
    if not ok_all:
        fail(f"the v1 kernel disagrees with its plain version beyond "
             f"{TOLERANCE}, or overflowed its stack")
    n_bytes = (nbytes(o, d, tm) + row_bytes(nodes, node_rows)
               + row_bytes(tris, cluster_rows) + 16 * o.shape[0])
    ops = walk_ops(live, times["pops"], times["clusters"], nodes, MT_OPS)
    return stats, times, bound_keys(n_bytes, ops)


def study_phase():
    """The traversal study entry point at 921,600 rays, in this process
    so that its launches are counted: set to 0 just before, read just
    after. The v1, closest-hit and any-hit kernels must all launch, and
    no stack may overflow. Returns (results, launches)."""
    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.utils import bench_traverse

    kernels.reset_counters()
    results = bench_traverse.main(STUDY_ARGS)
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    missing = [k for k in ("closest_v1", "closest", "anyhit")
               if launches[k] <= 0]
    if missing:
        fail(f"the traversal study did not launch {missing}: {launches}")
    if overflows:
        fail(f"the traversal study: {overflows} traversal stack overflows")
    for key, res in results.items():
        if isinstance(res, dict) and "ms" in res and not (
                np.isfinite(res["ms"]) and res["ms"] > 0
                and res.get("hits", 1) > 0):
            fail(f"the traversal study: {key} gave {res}")
    print("traversal study launches:", json.dumps(launches))
    return results, launches


def realtime_phase(torch, Renderer):
    """RealTime mode on "shadertoy" at 1280x720: the fused entry point
    with a camera move part-way, then render_realtime_frame with another;
    then the demodulated batch trace and the demodulation identity.
    Returns (results, launches of the frames)."""
    from dataclasses import replace

    from tracerboy_tpu_torch import OutputSettings, RenderMode
    from tracerboy_tpu_torch.post.realtime import composite_albedo
    from tracerboy_tpu_torch.renderer import _demod_ratio
    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.trace.wavefront import render_wave

    set_opt_in()
    w, h = FULL_WAVE
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda",
                 settings=OutputSettings(render_mode=RenderMode.REAL_TIME))
    if r.traversal != "kernel" or not r.wave_config().decouple_albedo:
        fail(f"RealTime: traversal {r.traversal}, decouple_albedo "
             f"{r.wave_config().decouple_albedo}")
    r.time_realtime_stages = True
    kernels.reset_counters()
    torch.cuda.reset_peak_memory_stats()

    def frame(fn, label, history):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn(as_numpy=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ev = r.rt_stage_events
        check_image(label, img.cpu().numpy())
        return dict(ms=ms, trace_ms=ev[0].elapsed_time(ev[1]),
                    post_ms=ev[1].elapsed_time(ev[2]),
                    # a history sample count above 1: the pixel blended a
                    # valid history tap this frame
                    valid_history=float(
                        (history()["moments"][..., 2] > 1.5).float().mean()))

    fused = []
    for i in range(RT_FUSED_FRAMES):
        if i == RT_MOVE_AFTER:
            r.move_camera(**RT_MOVE)
        rec = frame(r.render_realtime_frame_fused, f"RealTime fused {i}",
                    lambda: r._rt_hist_fused)
        rec["live_share"] = int(r._rt_live_pixels) / (w * h)
        fused.append(rec)
    plain = []
    for i in range(RT_PLAIN_FRAMES):
        if i == RT_PLAIN_FRAMES // 2:
            r.move_camera(**RT_MOVE)
        plain.append(frame(r.render_realtime_frame, f"RealTime frame {i}",
                           lambda: r._rt_history))
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    if launches["closest"] <= 0 or launches["anyhit"] <= 0:
        fail(f"RealTime: the frames did not launch both kernels: {launches}")
    if overflows:
        fail(f"RealTime: {overflows} traversal stack overflows")

    def quartiles(recs, key):
        v = np.asarray([x[key] for x in recs])
        return dict(median=float(np.median(v)),
                    q1=float(np.percentile(v, 25)),
                    q3=float(np.percentile(v, 75)), n=int(v.size))

    steady = fused[2:RT_MOVE_AFTER] + fused[RT_MOVE_AFTER + 1:]
    results = dict(
        frames=dict(fused=RT_FUSED_FRAMES, plain=RT_PLAIN_FRAMES),
        fused_ms=quartiles(steady, "ms"),
        fused_trace_ms=quartiles(steady, "trace_ms"),
        fused_post_ms=quartiles(steady, "post_ms"),
        first_frame_ms=fused[0]["ms"],
        plain_ms=quartiles(plain[1:], "ms"),
        valid_history_before_move=fused[RT_MOVE_AFTER - 1]["valid_history"],
        # The fused entry point restarts on a move (its frame 0 ignores
        # the history), so the history is valid again one frame later.
        valid_history_on_move=fused[RT_MOVE_AFTER]["valid_history"],
        valid_history_after_move=fused[-1]["valid_history"],
        # render_realtime_frame keeps its history across the move and
        # reprojects it through the previous camera.
        plain_valid_history_on_move=plain[RT_PLAIN_FRAMES // 2][
            "valid_history"],
        live_share_by_frame=[x["live_share"] for x in fused],
        governor_pad=r._governor.pad,
        launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    for key in ("valid_history_before_move", "valid_history_after_move",
                "plain_valid_history_on_move"):
        if not results[key] > 0:
            fail(f"RealTime: {key} is {results[key]}")

    # The batch form: 8 demodulated samples in one merged wave.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = r.trace_decoupled(8)
    torch.cuda.synchronize()
    results["trace_decoupled_8_ms_per_sample"] = (
        (time.perf_counter() - t0) / 8 * 1e3)
    fw = torch.clamp_min(acc["fw"], 1e-8)[:, None]
    illum, illum_d = acc["radiance"] / fw, acc["radiance_d"] / fw
    comp = composite_albedo(
        torch.clamp(acc["albedo"] / 8, 0.0, 1.0),
        _demod_ratio(illum_d, illum), illum, acc["emissive"] / 8)
    if not (bool(torch.isfinite(comp).all()) and float(comp.min()) >= 0
            and float(comp.mean()) > 0
            and bool((illum_d <= illum * (1 + 1e-5) + 1e-6).all())):
        fail("trace_decoupled(8): planes not finite, or D above I")
    results["decoupled_composite_mean"] = float(comp.mean())

    # The identity, per sample, on a wave without russian roulette.
    cfg = replace(r.wave_config(), use_russian_roulette=False,
                  decouple_albedo=False)
    params = r.frame_params()
    ref = render_wave(r.scene, params, r.pixel_ids, 1, cfg)["radiance"]
    dw = render_wave(r.scene, params, r.pixel_ids, 1,
                     replace(cfg, decouple_albedo=True))
    got = composite_albedo(
        dw["albedo"], _demod_ratio(dw["radiance_d"], dw["radiance"]),
        dw["radiance"], dw["emissive"] * dw["filter_weight"][:, None])
    err = (got - ref).abs()
    close = float((err <= IDENTITY["pixel_atol"] * (1 + ref.abs()))
                  .all(-1).float().mean())
    results["identity"] = dict(pixels_within=close,
                               max_abs_err=float(err.max()),
                               mean_radiance=float(ref.mean()))
    print("RealTime shadertoy 1280x720:", json.dumps(results))
    if close < IDENTITY["pixel_frac"]:
        fail(f"demodulation identity outside {IDENTITY}: "
             f"{results['identity']}")
    return results, launches


def main() -> int:
    print(card_line())
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port has no CPU path here",
              file=sys.stderr)
        return 1
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import traverse
    from tracerboy_tpu_torch.utils.bench_traverse import walk_ops

    set_opt_in()
    t0 = time.perf_counter()
    build_kernels()
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")

    # --- kernel vs twin -------------------------------------------------
    rng = np.random.default_rng(20261016)
    # Compiled with the opt-in tables too; the default tables are the same.
    set_opt_in(TB_CUT="1", TB_BINNED="1")
    cs = load_scene("shadertoy", film_size=FULL_WAVE)
    scene = cs.as_tensors("cuda")
    set_opt_in()
    main_t = (scene["pk_nodes"], scene["pk_tris_bw"])
    shadow_t = (scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
    o, d, tm = compare_rays(scene, rng)
    ck = traverse.closest_hit(o, d, tm, *main_t)
    cp = traverse.closest_hit_plain(o, d, tm, *main_t)
    ak = traverse.any_hit(o, d, tm, *shadow_t)
    ap = traverse.anyhit_plain(o, d, tm, *shadow_t)
    torch.cuda.synchronize()
    ok_c, st_c = check_closest(o, d, main_t, ck, cp)
    ok_a, st_a = check_anyhit(ak, ap)
    print("closest kernel vs twin:", json.dumps(st_c))
    print("anyhit kernel vs twin:", json.dumps(st_a))
    if not (ok_c and ok_a):
        fail(f"kernel disagrees with its twin beyond {TOLERANCE}")

    # Timing at the main path's shapes: a full 921,600-ray primary wave
    # and its shadow wave toward the lights.
    w, h = FULL_WAVE
    pix = torch.arange(w * h, device="cuda")
    po, pd = primary_rays(scene, w, h, pix, rng)
    ptm = torch.full((w * h,), 1e30, device="cuda")
    hits = traverse.closest_hit(po, pd, ptm, *main_t)
    so, sd, stm = shadow_rays(scene, po, pd, hits[0], hits[1], rng)
    full_k = traverse.closest_hit(po, pd, ptm, *main_t)
    full_p = traverse.closest_hit_plain(po, pd, ptm, *main_t)
    sh_k = traverse.any_hit(so, sd, stm, *shadow_t)
    sh_p = traverse.anyhit_plain(so, sd, stm, *shadow_t)
    ok_c2, st_c2 = check_closest(po, pd, main_t, full_k, full_p)
    ok_a2, st_a2 = check_anyhit(sh_k, sh_p)
    print("full wave closest kernel vs twin:", json.dumps(st_c2))
    print("full wave anyhit kernel vs twin:", json.dumps(st_a2))
    if not (ok_c2 and ok_a2):
        fail(f"kernel disagrees with its twin beyond {TOLERANCE}")
    times = dict(
        closest_ms=cuda_ms(lambda: traverse.closest_hit(po, pd, ptm,
                                                        *main_t), 20),
        closest_plain_ms=cuda_ms(lambda: traverse.closest_hit_plain(
            po, pd, ptm, *main_t), 2),
        anyhit_ms=cuda_ms(lambda: traverse.any_hit(so, sd, stm,
                                                   *shadow_t), 20),
        anyhit_plain_ms=cuda_ms(lambda: traverse.anyhit_plain(
            so, sd, stm, *shadow_t), 2),
        compare_closest_ms=cuda_ms(lambda: traverse.closest_hit(
            o, d, tm, *main_t), 20),
        compare_closest_plain_ms=cuda_ms(lambda: traverse.closest_hit_plain(
            o, d, tm, *main_t), 2),
    )
    print("timing 921,600-ray waves and 65,536 rays:", json.dumps(times))

    # --- rays in no order, and the kernels' walk beside the serial walk ----
    unordered = study_rays(cs, "cuda")
    un_c, un_a, un_times = unordered_phase(main_t, shadow_t, unordered)
    walks_phase((("primary", (po, pd, ptm), main_t, False),
                 ("primary shadow", (so, sd, stm), shadow_t, True),
                 ("unordered bounce", unordered["bounce"], main_t, False),
                 ("unordered shadow", unordered["shadow"], shadow_t, True)))
    un_bounce = unordered["bounce"]
    del unordered

    # --- the stats kernel vs the stats-free kernel and its twin -----------
    st_stats, st_times = stats_phase(
        main_t, (("compare", (o, d, tm)), ("primary", (po, pd, ptm)),
                 ("unordered bounce", un_bounce)),
        dict(primary="stats", **{"unordered bounce": "unordered"}))
    # The rows each walk reads, and the any-hit walk's pops and clusters
    # (the stats twin's walk, in the any-hit kernel's mode).
    pri_rows = traverse.walk_footprint(po, pd, ptm, *main_t)[:2]
    sh_walk = traverse.walk_footprint(so, sd, stm, *shadow_t, any_hit=True)
    n_pri = po.shape[0]
    pri_tables = (row_bytes(main_t[0], pri_rows[0])
                  + row_bytes(main_t[1], pri_rows[1]))
    walk_rows = dict(
        primary_node_rows=int(pri_rows[0].sum()),
        primary_cluster_rows=int(pri_rows[1].sum()),
        shadow_node_rows=int(sh_walk[0].sum()),
        shadow_cluster_rows=int(sh_walk[1].sum()),
        shadow_pops=int(sh_walk[2].sum()),
        shadow_clusters=int(sh_walk[3].sum()))
    print("rows read by the walks:", json.dumps(walk_rows))
    walk_bytes = dict(
        closest=nbytes(po, pd, ptm) + pri_tables + 16 * n_pri,
        stats=nbytes(po, pd, ptm) + pri_tables + 24 * n_pri,
        anyhit=nbytes(so, sd, stm) + row_bytes(shadow_t[0], sh_walk[0])
        + row_bytes(shadow_t[1], sh_walk[1]) + so.shape[0])
    pri = st_stats["primary"]
    closest_ops = walk_ops(pri["live"], pri["pops"], pri["clusters"],
                           main_t[0])
    anyhit_ops = walk_ops(int((stm > 0).sum()), walk_rows["shadow_pops"],
                          walk_rows["shadow_clusters"], shadow_t[0])
    del full_k, full_p, sh_k, sh_p, sh_walk, pri_rows, ck, cp, ak, ap, hits

    # --- the v1 kernel vs its plain version ---------------------------------
    v1_stats, v1_times, v1_bound = v1_phase(cs, scene, (o, d, tm),
                                            (po, pd, ptm), un_bounce)
    del un_bounce

    # --- the opt-in paths' kernels vs their twins ---------------------------
    opt_stats, opt_times = opt_in_kernel_phase(
        scene, (o, d, tm), (po, pd, ptm), (so, sd, stm))
    bounce_stats, bounce_sums = binned_bounce_phase()
    cut_stats, cut_sums = cut_bounce_phase()
    bn_select = [opt_stats["select_compare"], opt_stats["select_primary"],
                 *(v for k, v in bounce_stats.items()
                   if k.startswith("select"))]
    bn_dense = [opt_stats["dense_compare"], opt_stats["dense_primary"],
                *(v for k, v in bounce_stats.items()
                  if k.startswith("dense"))]
    del scene, cs, o, d, tm, po, pd, ptm, so, sd, stm

    # --- the slice: default, cut and binned paths ---------------------------
    _, launches = render_slice(torch, Renderer, "default", {},
                               ("closest", "anyhit"))
    cornell_phase(torch, Renderer)
    cut_res, cut_launches = render_slice(torch, Renderer, "TB_CUT=1",
                                         {"TB_CUT": "1"},
                                         ("emit", "closest", "anyhit"),
                                         heatmap=True)
    _, bn_launches = render_slice(torch, Renderer, "TB_BINNED=1",
                                  {"TB_BINNED": "1"},
                                  ("select", "dense", "closest", "anyhit"))

    wave_bounce_phase()

    # --- the first-hit AOV slice and the denoiser ---------------------------
    r, _, heat_launches = aov_slice_phase(torch, Renderer)
    denoise_phase(torch, r.resolve_radiance())
    del r

    # --- path parity ------------------------------------------------------
    parity_phase(torch, Renderer)

    # --- the traversal study and RealTime mode ------------------------------
    _, study_launches = study_phase()
    _, rt_launches = realtime_phase(torch, Renderer)

    def by_path(key):
        return {"default": launches[key], "cut": cut_launches[key],
                "binned": bn_launches[key], "study": study_launches[key],
                "realtime": rt_launches[key]}

    trav = "tracerboy_tpu_torch/csrc/bvh_traverse.cu"
    bsrc = "tracerboy_tpu_torch/csrc/binned.cu"
    roots_c = [v for k, v in opt_stats.items()
               if k.startswith("closest_roots")]
    roots_a = [v for k, v in opt_stats.items()
               if k.startswith("anyhit_roots")]
    emits = [*(v for k, v in opt_stats.items() if k.startswith("emit")),
             *cut_stats.values()]
    print(json.dumps({"kernels": [
        dict(name="closest_hit", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:754",
             launches=launches["closest"],
             launches_by_path=by_path("closest"),
             max_abs_err=max([st_c["max_abs_err"], st_c2["max_abs_err"],
                              un_c["max_abs_err"]]
                             + [s["max_abs_err"] for s in roots_c]),
             id_mismatch_outside_ties=sum(
                 s["id_mismatch_outside_ties"]
                 for s in [st_c, st_c2, un_c, *roots_c]),
             ms=times["closest_ms"], plain_ms=times["closest_plain_ms"],
             unordered_ms=un_times["closest_ms"],
             unordered_plain_ms=un_times["closest_plain_ms"],
             **bound_keys(walk_bytes["closest"], closest_ops),
             roots_ms=opt_times["closest_roots_ms"],
             roots_plain_ms=opt_times["closest_roots_plain_ms"]),
        dict(name="closest_hit_stats", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:754 "
                      "(stats=True)",
             launches=heat_launches + cut_res["heatmap_launches"][
                 "closest_stats"],
             launches_by_path={"default": heat_launches,
                               "cut": cut_res["heatmap_launches"][
                                   "closest_stats"]},
             max_abs_err=max(s["max_abs_err"] for s in st_stats.values()),
             count_mismatch=sum(s["count_mismatch"]
                                for s in st_stats.values()),
             ms=st_times["stats_ms"], plain_ms=st_times["primary_plain_ms"],
             stats_free_ms=st_times["stats_free_ms"],
             unordered_ms=st_times["unordered_ms"],
             unordered_plain_ms=st_times["unordered bounce_plain_ms"],
             unordered_free_ms=st_times["unordered_free_ms"],
             **bound_keys(walk_bytes["stats"], closest_ops)),
        dict(name="any_hit", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:869",
             launches=launches["anyhit"],
             launches_by_path=by_path("anyhit"),
             occ_mismatch=sum(s["occ_mismatch"]
                              for s in [st_a, st_a2, un_a, *roots_a]),
             max_abs_err=max(s["max_abs_err"]
                             for s in [st_a, st_a2, un_a, *roots_a]),
             ms=times["anyhit_ms"], plain_ms=times["anyhit_plain_ms"],
             unordered_ms=un_times["anyhit_ms"],
             unordered_plain_ms=un_times["anyhit_plain_ms"],
             **bound_keys(walk_bytes["anyhit"], anyhit_ops),
             roots_ms=opt_times["anyhit_roots_ms"],
             roots_plain_ms=opt_times["anyhit_roots_plain_ms"]),
        dict(name="emit_cuts", route="cuda",
             source="tracerboy_tpu_torch/csrc/cut_emit.cu",
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:657",
             launches=cut_launches["emit"],
             set_mismatch=sum(s["set_mismatch"] for s in emits),
             order_mismatch=sum(s["order_mismatch"] for s in emits),
             max_abs_err=max(s["max_abs_err"] for s in emits),
             ms=opt_times["emit_ms"], plain_ms=opt_times["emit_plain_ms"],
             **bound_keys(opt_times["emit_bytes"], opt_times["emit_ops"]),
             bounce_ms=cut_sums["ms"], bounce_plain_ms=cut_sums["plain_ms"],
             bounce_bound_ms=cut_sums["bound_ms"],
             bounce_launches=cut_sums["launches"],
             over_budget_rows=cut_sums["over_budget_rows"],
             over_budget_ms=cut_sums["over_budget_ms"]),
        dict(name="select_clusters", route="cuda", source=bsrc,
             replaces="tracerboy_tpu/trace/binned.py:363",
             launches=bn_launches["select"],
             max_abs_err=max(s["max_abs_err"] for s in bn_select),
             set_mismatch=sum(s["set_mismatch"] for s in bn_select),
             ties=sum(s["ties"] for s in bn_select),
             dropped_violations=sum(s["dropped_violations"]
                                    for s in bn_select),
             ms=opt_times["select_ms"], plain_ms=opt_times["select_plain_ms"],
             **bound_keys(opt_times["select_bytes"], opt_times["select_ops"]),
             bounce_ms=bounce_sums["select"]["ms"],
             bounce_plain_ms=bounce_sums["select"]["plain_ms"],
             bounce_bound_ms=bounce_sums["select"]["bound_ms"],
             bounce_launches=bounce_sums["select"]["launches"]),
        dict(name="dense_pairs", route="cuda", source=bsrc,
             replaces="tracerboy_tpu/trace/binned.py:554",
             launches=bn_launches["dense"],
             max_abs_err=max(s["max_abs_err"] for s in bn_dense),
             max_rel_t_err=max(s["max_rel_t_err"] for s in bn_dense),
             hit_mismatch=sum(s["hit_mismatch"] for s in bn_dense),
             id_mismatch_outside_ties=sum(s["id_mismatch_outside_ties"]
                                          for s in bn_dense),
             ms=opt_times["dense_ms"], plain_ms=opt_times["dense_plain_ms"],
             **bound_keys(opt_times["dense_bytes"], opt_times["dense_ops"]),
             bounce_ms=bounce_sums["dense"]["ms"],
             bounce_plain_ms=bounce_sums["dense"]["plain_ms"],
             bounce_bound_ms=bounce_sums["dense"]["bound_ms"],
             bounce_launches=bounce_sums["dense"]["launches"]),
        dict(name="closest_hit_v1", route="cuda",
             source="tracerboy_tpu_torch/csrc/bvh_traverse_v1.cu",
             replaces="tracerboy_tpu/trace/pallas_traverse.py:299",
             launches=study_launches["closest_v1"],
             max_abs_err=max(s["max_abs_err"] for s in v1_stats.values()),
             id_mismatch_outside_ties=sum(
                 s["id_mismatch_outside_ties"] for s in v1_stats.values()),
             stack_overflows=sum(s["stack_overflows"]
                                 for s in v1_stats.values()),
             differs_from_closest_hit=v1_stats["primary"][
                 "differs_from_closest_hit"],
             ms=v1_times["v1_ms"], plain_ms=v1_times["primary_plain_ms"],
             closest_hit_ms=v1_times["closest_ms"],
             unordered_ms=v1_times["unordered_ms"],
             unordered_plain_ms=v1_times["unordered_plain_ms"],
             unordered_closest_hit_ms=v1_times["unordered_closest_ms"],
             **v1_bound),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
