#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tracerboy_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. exit non-zero without a CUDA device (there is no CPU path);
  3. build the traversal kernels (nvcc, sm_90a) and print the seconds;
  4. kernel vs plain twin on "shadertoy" at 1280x720: 65,536 rays (half
     primary, half random with finite and zero t_max), closest hit on
     the main BVH and any hit on the shadow BVH, within TOLERANCE; then
     both timed with CUDA events on a full 921,600-ray wave;
  5. the slice: Renderer("shadertoy", (1280, 720)) render_sample(1),
     render_sample(8), current_image(), which must launch both kernels
     and overflow no stack; then "shadertoy:cornell" at 512x512, 4 spp,
     on the brute-force path;
  6. path parity: one renderer's 2-sample merged wave at 128x72 on the
     kernel path against the twin path, with the CPU tests' tolerance;
  7. a JSON line of the kernels (max_abs_err: the largest |kernel - twin|
     of t, u and v for closest hit, of the occlusion as 0/1 for any hit),
     then the result line {"ok": true, "device": {...}} last.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
TOLERANCE = dict(hit_mismatch_frac=1e-4, t_rel=1e-6, uv_abs=1e-6,
                 id_mismatch_frac=1e-4, occ_mismatch_frac=1e-4)
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


def check_closest(o, d, tris_bw, k, p):
    """Kernel outputs k against twin outputs p, each (t, tri, u, v).
    Where both hit the same id, t, u and v are compared; where the ids
    differ, the kernel's triangle is re-tested (traverse.hit_attributes):
    it is a tie if it is hit at the twin's t, and then its u, v are
    compared with the re-test's."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

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
                 occ_mismatch=mism,
                 max_abs_err=_max_abs(occ_k.astype(np.float32),
                                      occ_p.astype(np.float32)))
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


def render_phase(torch, traverse, Renderer):
    results = {}
    traverse.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
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
    launches = dict(traverse.LAUNCHES)
    overflow = traverse.stack_overflows()
    acc = r.state.accum
    mean = float(acc[..., :3].mean())
    if not bool(torch.isfinite(acc).all()):
        fail("accumulator is not finite")
    if not mean > 0:
        fail(f"accumulator mean {mean} is not positive")
    if img.shape != (FULL_WAVE[1], FULL_WAVE[0], 3):
        fail(f"image shape {img.shape}")
    if not (np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
        fail("image is not finite within [0, 1]")
    if launches["closest"] <= 0 or launches["anyhit"] <= 0:
        fail(f"the slice did not launch both kernels: {launches}")
    if overflow != 0:
        fail(f"{overflow} traversal stack overflows")
    rays8 = r.rays_traced - rays1
    results.update(
        spp=r.state.spp, accum_mean=mean, launches=launches,
        stack_overflows=overflow, rays_traced=r.rays_traced,
        s_sample1=t1 - t0, s_per_sample_8=(t2 - t1) / 8,
        mrays_s_sample1=rays1 / (t1 - t0) / 1e6,
        mrays_s_8=rays8 / (t2 - t1) / 1e6,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("render shadertoy 1280x720:", json.dumps(results))
    del r

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
    return results, launches


def parity_phase(torch, Renderer):
    """One renderer's 2-sample merged wave (what render_sample(2)
    accumulates) on the kernel path and on the twin path."""
    from dataclasses import replace

    from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

    r = Renderer("shadertoy", film_size=PARITY_FILM, device="cuda")
    if r.traversal != "kernel":
        fail(f"shadertoy took the {r.traversal} path, not the kernels")
    cfg, params = r.wave_config(), r.frame_params()
    accs = {}
    for backend in ("kernel", "twin"):
        out = render_wave_merged(r.scene, params, r.pixel_ids, 0, 2,
                                 replace(cfg, traversal=backend))
        accs[backend] = torch.cat([out["radiance"],
                                   out["filter_weight"][:, None]],
                                  dim=1).cpu().numpy()
    ref, got = accs["twin"], accs["kernel"]
    close = (np.abs(got - ref) <= PARITY["pixel_atol"] * (1 + np.abs(ref))
             ).all(-1).mean()
    mean_rel = abs(got.mean() - ref.mean()) / abs(ref.mean())
    stats = dict(pixels_within=float(close), mean_rel=float(mean_rel))
    print("path parity kernel vs twin 128x72 2 spp:", json.dumps(stats))
    if close < PARITY["pixel_frac"] or mean_rel > PARITY["mean_rel"]:
        fail(f"path parity outside tolerance: {stats}")


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

    t0 = time.perf_counter()
    traverse.build_kernels()
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")

    # --- kernel vs twin -------------------------------------------------
    rng = np.random.default_rng(20261016)
    scene = load_scene("shadertoy", film_size=FULL_WAVE).as_tensors("cuda")
    main_t = (scene["pk_nodes"], scene["pk_tris_bw"])
    shadow_t = (scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
    o, d, tm = compare_rays(scene, rng)
    ck = traverse.closest_hit(o, d, tm, *main_t)
    cp = traverse.closest_hit_plain(o, d, tm, *main_t)
    ak = traverse.any_hit(o, d, tm, *shadow_t)
    ap = traverse.anyhit_plain(o, d, tm, *shadow_t)
    torch.cuda.synchronize()
    ok_c, st_c = check_closest(o, d, main_t[1], ck, cp)
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
    ok_c2, st_c2 = check_closest(po, pd, main_t[1], full_k, full_p)
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
    del scene, o, d, tm, po, pd, ptm, so, sd, stm, hits
    del full_k, full_p, sh_k, sh_p, ck, cp, ak, ap

    # --- the slice --------------------------------------------------------
    _, launches = render_phase(torch, traverse, Renderer)

    # --- path parity ------------------------------------------------------
    parity_phase(torch, Renderer)

    src = "tracerboy_tpu_torch/csrc/bvh_traverse.cu"
    print(json.dumps({"kernels": [
        dict(name="closest_hit", route="cuda", source=src,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:754",
             launches=launches["closest"],
             max_abs_err=max(st_c["max_abs_err"], st_c2["max_abs_err"]),
             ms=times["closest_ms"], plain_ms=times["closest_plain_ms"]),
        dict(name="any_hit", route="cuda", source=src,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:869",
             launches=launches["anyhit"],
             max_abs_err=max(st_a["max_abs_err"], st_a2["max_abs_err"]),
             occ_mismatch=st_a["occ_mismatch"] + st_a2["occ_mismatch"],
             ms=times["anyhit_ms"], plain_ms=times["anyhit_plain_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
