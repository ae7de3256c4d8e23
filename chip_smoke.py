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
     both timed with CUDA events on a full 921,600-ray wave;
  5. the same for the opt-in paths' kernels on the scene compiled with
     the cut and binned tables (TB_CUT=1, TB_BINNED=1): emit (cut phase
     1), closest and any hit with per-ray roots (cut phase 2), selection
     and dense pairs (binned), on the 65,536 rays and on the 921,600-ray
     primary and shadow waves, each timed beside its twin;
  6. the slice: Renderer("shadertoy", (1280, 720)) render_sample(1),
     render_sample(8), current_image(), which must launch both kernels
     and overflow no stack; then "shadertoy:cornell" at 512x512, 4 spp,
     on the brute-force path; then the same render_sample(1) and (8) with
     TB_CUT=1 and again with TB_BINNED=1, each of which must launch its
     new kernels and overflow no stack;
  7. path parity: one renderer's 2-sample merged wave at 128x72 on the
     kernel path against the twin path, and the cut and the binned path
     against the default kernel path, with the CPU tests' tolerance;
  8. a JSON line of the five kernels (launches from the run of the path
     each serves, error statistics, ms against plain_ms), then the
     result line {"ok": true, "device": {...}} last.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


def check_closest(o, d, tables, k, p):
    """Kernel outputs k against twin outputs p, each (t, tri, u, v), on
    tables (nodes, tris_bw). Where both hit the same id, t, u and v are
    compared; where the ids differ, the kernel's triangle is re-tested
    (traverse.hit_attributes): it is a tie if it is hit at the twin's t,
    and then its u, v are compared with the re-test's. Up to 4 id
    mismatches outside ties are listed with their box entry t."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    nodes, tris_bw = tables
    t_k, tri_k, u_k, v_k = (x.cpu().numpy() for x in k)
    t_p, tri_p, u_p, v_p = (x.cpu().numpy() for x in p)
    hit_k, hit_p = tri_k >= 0, tri_p >= 0
    both = hit_k & hit_p
    same = both & (tri_k == tri_p)
    diff = np.flatnonzero(both & (tri_k != tri_p))
    sel = torch.from_numpy(diff).to(o.device)
    t_r, u_r, v_r = (x.cpu().numpy() for x in traverse.hit_attributes(
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
    stats = dict(rays=int(occ_k.shape[0]), occluded=int(occ_k.sum()),
                 occ_mismatch=mism)
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
    """Build the three kernel libraries at once, one nvcc each."""
    from tracerboy_tpu_torch.trace import binned, cut, traverse

    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(m.build_kernels) for m in (traverse, cut,
                                                       binned)]:
            f.result()


def check_emit(k, p):
    """Emit kernel ids against the twin's: rays whose sorted subtree sets
    differ, and rays whose slot order differs."""
    n = k.shape[0]
    set_mism = int((k.sort(1).values != p.sort(1).values).any(1).sum())
    stats = dict(rays=n, with_emits=int((k >= 0).any(1).sum()),
                 set_mismatch=set_mism,
                 order_mismatch=int((k != p).any(1).sum()))
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
                dense_pairs=int(dpairs[3].shape[0]))
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


def render_slice(torch, Renderer, name, env, required):
    """Renderer("shadertoy", (1280, 720)) under the opt-in variables env:
    render_sample(1), render_sample(8), current_image(), with the launch
    counts set to 0 just before and read just after. Every kernel in
    `required` must launch, and no stack may overflow."""
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
    if img.shape != (FULL_WAVE[1], FULL_WAVE[0], 3):
        fail(f"{name}: image shape {img.shape}")
    if not (np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
        fail(f"{name}: image is not finite within [0, 1]")
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

    set_opt_in()
    t0 = time.perf_counter()
    build_kernels()
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")

    # --- kernel vs twin -------------------------------------------------
    rng = np.random.default_rng(20261016)
    # Compiled with the opt-in tables too; the default tables are the same.
    set_opt_in(TB_CUT="1", TB_BINNED="1")
    scene = load_scene("shadertoy", film_size=FULL_WAVE).as_tensors("cuda")
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
    del full_k, full_p, sh_k, sh_p, ck, cp, ak, ap, hits

    # --- the opt-in paths' kernels vs their twins ---------------------------
    opt_stats, opt_times = opt_in_kernel_phase(
        scene, (o, d, tm), (po, pd, ptm), (so, sd, stm))
    del scene, o, d, tm, po, pd, ptm, so, sd, stm

    # --- the slice: default, cut and binned paths ---------------------------
    _, launches = render_slice(torch, Renderer, "default", {},
                               ("closest", "anyhit"))
    cornell_phase(torch, Renderer)
    _, cut_launches = render_slice(torch, Renderer, "TB_CUT=1",
                                   {"TB_CUT": "1"},
                                   ("emit", "closest", "anyhit"))
    _, bn_launches = render_slice(torch, Renderer, "TB_BINNED=1",
                                  {"TB_BINNED": "1"},
                                  ("select", "dense", "closest", "anyhit"))

    # --- path parity ------------------------------------------------------
    parity_phase(torch, Renderer)

    def by_path(key):
        return {"default": launches[key], "cut": cut_launches[key],
                "binned": bn_launches[key]}

    trav = "tracerboy_tpu_torch/csrc/bvh_traverse.cu"
    bsrc = "tracerboy_tpu_torch/csrc/binned.cu"
    roots_c = [v for k, v in opt_stats.items()
               if k.startswith("closest_roots")]
    roots_a = [v for k, v in opt_stats.items()
               if k.startswith("anyhit_roots")]
    emits = [v for k, v in opt_stats.items() if k.startswith("emit")]
    print(json.dumps({"kernels": [
        dict(name="closest_hit", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:754",
             launches=launches["closest"],
             launches_by_path=by_path("closest"),
             max_abs_err=max([st_c["max_abs_err"], st_c2["max_abs_err"]]
                             + [s["max_abs_err"] for s in roots_c]),
             id_mismatch_outside_ties=sum(
                 s["id_mismatch_outside_ties"]
                 for s in [st_c, st_c2, *roots_c]),
             ms=times["closest_ms"], plain_ms=times["closest_plain_ms"],
             roots_ms=opt_times["closest_roots_ms"],
             roots_plain_ms=opt_times["closest_roots_plain_ms"]),
        dict(name="any_hit", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:869",
             launches=launches["anyhit"],
             launches_by_path=by_path("anyhit"),
             occ_mismatch=sum(s["occ_mismatch"]
                              for s in [st_a, st_a2, *roots_a]),
             ms=times["anyhit_ms"], plain_ms=times["anyhit_plain_ms"],
             roots_ms=opt_times["anyhit_roots_ms"],
             roots_plain_ms=opt_times["anyhit_roots_plain_ms"]),
        dict(name="emit_cuts", route="cuda",
             source="tracerboy_tpu_torch/csrc/cut_emit.cu",
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:657",
             launches=cut_launches["emit"],
             set_mismatch=sum(s["set_mismatch"] for s in emits),
             order_mismatch=sum(s["order_mismatch"] for s in emits),
             ms=opt_times["emit_ms"], plain_ms=opt_times["emit_plain_ms"]),
        dict(name="select_clusters", route="cuda", source=bsrc,
             replaces="tracerboy_tpu/trace/binned.py:363",
             launches=bn_launches["select"],
             max_abs_err=max(opt_stats[k]["max_abs_err"]
                             for k in ("select_compare", "select_primary")),
             set_mismatch=sum(opt_stats[k]["set_mismatch"]
                              for k in ("select_compare", "select_primary")),
             dropped_violations=sum(
                 opt_stats[k]["dropped_violations"]
                 for k in ("select_compare", "select_primary")),
             ms=opt_times["select_ms"], plain_ms=opt_times["select_plain_ms"]),
        dict(name="dense_pairs", route="cuda", source=bsrc,
             replaces="tracerboy_tpu/trace/binned.py:554",
             launches=bn_launches["dense"],
             max_abs_err=max(opt_stats[k]["max_abs_err"]
                             for k in ("dense_compare", "dense_primary")),
             max_rel_t_err=max(opt_stats[k]["max_rel_t_err"]
                               for k in ("dense_compare", "dense_primary")),
             id_mismatch_outside_ties=sum(
                 opt_stats[k]["id_mismatch_outside_ties"]
                 for k in ("dense_compare", "dense_primary")),
             ms=opt_times["dense_ms"], plain_ms=opt_times["dense_plain_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
