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

Each variant is warmed up, then timed --runs times with CUDA events (one
launch per event pair); a line gives the median, the quartiles, Mrays/s at
the median and the hit count, after the card's name and power limit. For
a sorted order the line "reorder" gives what the order costs on the
device beside the kernel: the sort of the keys, the gather of the rays and
the scatter of four outputs back. Where v1 and v2 both ran, a line counts
the rays on which they differ outside ties: the hit sets, and hits of
different triangles at different t (beyond 1e-5 relative). The two use
different triangle tests (Moller-Trumbore with |det| > 1e-9 against
Baldwin-Weber), so a small count is expected and is no fault. --stats
prints kernel v2's per-ray pops and leaf clusters (closest_hit_stats)
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


def time_runs(fn, runs: int, device, warmup: int = 2) -> np.ndarray:
    """ms of each of `runs` calls of fn after `warmup` calls: CUDA events
    around each call on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        out = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(out)
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
    from tracerboy_tpu_torch.trace import traverse

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
                st = traverse.closest_hit_stats(ot, dt, tmt, packed["nodes"],
                                                packed["tris_bw"])
                cost = traverse.traverse_wide(ot, dt, tmt, *wide_tables)[4]
                live = tmt > 0
                pops, clusters = (x[live].to(torch.float32) for x in st[4:])
                res = dict(live=int(live.sum()),
                           pops_mean=float(pops.mean()),
                           pops_max=float(pops.max()),
                           clusters_mean=float(clusters.mean()),
                           clusters_max=float(clusters.max()),
                           tests_v2=float((pops.mean() + clusters.mean())
                                          * 8),
                           need_wide=float(cost[live].mean()))
                results[f"{prefix}/stats"] = res
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
                results[f"{prefix}/{vname}"] = res
                print(f"{card} | {prefix}/{vname}: {res['ms']:.3f} ms "
                      f"({res['q1']:.3f} .. {res['q3']:.3f}, n={res['n']}) "
                      f"= {res['mrays_s']:.1f} Mrays/s  (hits {nhit})")
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
