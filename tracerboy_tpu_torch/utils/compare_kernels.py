"""Time the v1 closest-hit kernel and the stats kernel of this tree beside
the same kernels built from another source tree, in turns, on the rays
each kernel gets, and check that all of them give the same outputs bit
for bit.

    python -m tracerboy_tpu_torch.utils.compare_kernels --parent TREE \
        [--kernels v1,stats] [--runs 10] [--rays 921600]
        [--wave-film 1280x720] [--wave-spp 8]

To compare a parent commit with the working tree on one card, unpack the
parent into an ignored directory (git archive HEAD | tar -x -C
build/parent) and pass --parent build/parent.

The parent's sources (TREE/tracerboy_tpu_torch/csrc/bvh_traverse_v1.cu
and bvh_traverse.cu, with that tree's headers) are built with this tree's
nvcc flags under names of their own and called through the C entries of
the thread-per-ray kernels, which take no ray counter and no stack size:
    tb_closest_hit_v1(o, d, t_max, nodes, tris, n, t, tri, u, v,
                      overflow, stream)
    tb_closest_hit_stats(o, d, t_max, nodes, tris, n, t, tri, u, v, pops,
                         clusters, overflow, stream)
Each kernel runs as the parent's and as this tree's
(traverse_v1.closest_hit_v1, traverse.closest_hit_stats). Ray sets: the
traversal study's primary, bounce and shadow rays
(bench_traverse.make_ray_sets, default_rng(7)), each unsorted and sorted
oct-org, on the study's tables (pack_scene with raw_rows=True); for the
stats kernel also its `heatmap-wave` launches (record_stats_launches: one
HEATMAP render_sample(1) and one render_sample(--wave-spp) at
--wave-film), which are the only launches a render gives it.

Per kernel and set: the tree's outputs against the parent's (rays on
which any output differs, and 0 stack overflows), then both timed in
turns (parent, tree, tree, parent), --runs CUDA-event timings a turn; a
line gives each side's median over its turns, the quartiles and the
bound (bench_traverse.walk_bound). Sums over the study's six sets
and over the heatmap-wave launches follow. Prints the card's name and
power limit first and one JSON object last; exits 1 if any output
differs or a stack overflowed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tracerboy_tpu_torch.trace import kernels, traverse, traverse_v1
from tracerboy_tpu_torch.utils import bench_traverse as study
from tracerboy_tpu_torch.utils.build import build_shared_library, nvcc_path

PARENT_ENTRIES = {
    # kernel: (source, C entry, pointers before n, pointers after n)
    "v1": ("bvh_traverse_v1.cu", "tb_closest_hit_v1", 5, 6),
    "stats": ("bvh_traverse.cu", "tb_closest_hit_stats", 5, 8),
}


def parent_library(tree: Path, kernel: str):
    """The parent tree's library of `kernel`, built with this tree's
    flags; returns (library, C entry name)."""
    source, entry, before, after = PARENT_ENTRIES[kernel]
    csrc = tree.resolve() / "tracerboy_tpu_torch" / "csrc"
    flags = [f for f in kernels.NVCC_FLAGS if not f.startswith("-I")]
    path = build_shared_library(
        f"parent_{kernel}", [csrc / source],
        [nvcc_path(), *flags, f"-I{csrc}"], headers=sorted(csrc.glob("*.cuh")))
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    getattr(lib, entry).restype = ctypes.c_int
    getattr(lib, entry).argtypes = [p] * before + [ctypes.c_int] + \
        [p] * after
    return lib, entry


def variants(kernel: str, tree: Path):
    """{name: fn(o, d, t_max, nodes, tris) -> outputs} of one kernel."""
    lib, entry = parent_library(tree, kernel)

    def parent(o, d, tm, nodes, tris):
        n = o.shape[0]
        n_out = 4 if kernel == "v1" else 6
        out = [torch.empty(n, dtype=torch.int32 if j in (1, 4, 5)
                           else torch.float32, device=o.device)
               for j in range(n_out)]
        kernels.launch(lib, entry, o.device, o, d, tm, nodes, tris, n, *out)
        return tuple(out)

    return dict(parent=parent, tree=(traverse_v1.closest_hit_v1
                                     if kernel == "v1"
                                     else traverse.closest_hit_stats))


def compare_set(kernel, fns, label, rays, tables, runs, device, card):
    """Outputs against the parent's, then the variants timed in turns."""
    o, d, tm = rays
    kernels.reset_counters()
    outs = {name: fn(o, d, tm, *tables) for name, fn in fns.items()}
    overflows = kernels.stack_overflows()
    ref = outs["parent"]
    differ = {name: int(torch.stack([a != b for a, b in zip(out, ref)])
                        .any(0).sum())
              for name, out in outs.items() if name != "parent"}
    names = list(fns)
    samples: dict = {name: [] for name in names}
    for name in names + names[::-1]:
        samples[name].append(study.time_runs(
            lambda: fns[name](o, d, tm, *tables), runs, device))
    if kernel == "v1":
        bound = study.walk_bound(o, d, tm, *tables,
                                 traverse_v1.walk_footprint_v1, 16,
                                 study.MT_OPS)
    else:
        bound = study.walk_bound(o, d, tm, *tables, traverse.walk_footprint,
                                 24)
    res = dict(lanes=int(o.shape[0]), live=int((tm > 0).sum()),
               rays_differing_from_parent=differ, stack_overflows=overflows,
               bound_ms=bound[0], bound_by=bound[1])
    for name in names:
        ms = np.concatenate(samples[name])
        res[name] = dict(ms=float(np.median(ms)),
                         q1=float(np.percentile(ms, 25)),
                         q3=float(np.percentile(ms, 75)), n=int(ms.size))
    print(f"{card} | {kernel}/{label}: " + ", ".join(
        f"{name} {res[name]['ms']:.3f} ms ({res[name]['q1']:.3f} .. "
        f"{res[name]['q3']:.3f})" for name in names)
        + f"; bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"{res['lanes']} lanes, {res['live']} live; rays differing from "
        f"the parent {differ}, stack overflows {overflows}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--kernels", default="v1,stats")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--rays", type=int, default=1280 * 720)
    ap.add_argument("--wave-film", default="1280x720")
    ap.add_argument("--wave-spp", type=int, default=8)
    args = ap.parse_args(argv)

    from tracerboy_tpu_torch.accel.pack import pack_scene
    from tracerboy_tpu_torch.scene.compile import load_scene

    device = torch.device("cuda")
    card = study.card_line(device)
    print(card)
    cs = load_scene("shadertoy", film_size=(64, 64))
    pk, _ = pack_scene(cs.tri_v0, cs.tri_v1, cs.tri_v2, raw_rows=True)
    packed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in pk.items()}
    sets = study.make_ray_sets(cs, args.rays, np.random.default_rng(7))
    lo, hi = cs.tri_v0.min(0), cs.tri_v0.max(0)
    study_sets = {}
    for name in ("primary", "bounce", "shadow"):
        o, d, tm = sets[name]
        for order in ("none", "oct-org"):
            perm = study.coherence_sort(o, d, lo, hi, order, tm=tm)
            study_sets[f"{name}/{order}"] = tuple(
                torch.from_numpy(np.ascontiguousarray(x[perm])).to(device)
                for x in (o, d, tm))

    results: dict = dict(device=card, parent=str(args.parent),
                         rays=args.rays, runs=args.runs)
    bad = False
    for kernel in args.kernels.split(","):
        fns = variants(kernel, args.parent)
        tables = ((packed["nodes"], packed["tris"]) if kernel == "v1"
                  else (packed["nodes"], packed["tris_bw"]))
        groups = {"study": [(k, rays, tables)
                            for k, rays in study_sets.items()]}
        if kernel == "stats":
            film = tuple(int(x) for x in args.wave_film.split("x"))
            calls = study.record_stats_launches(
                "shadertoy", film, (1, args.wave_spp), device)
            groups["heatmap-wave"] = [(f"heatmap-wave/stats_{i}", c[:3],
                                       c[3:]) for i, c in enumerate(calls)]
        for group, items in groups.items():
            total = {name: 0.0 for name in fns}
            total["bound_ms"] = 0.0
            for label, rays, tabs in items:
                res = compare_set(kernel, fns, label, rays, tabs, args.runs,
                                  device, card)
                results[f"{kernel}/{label}"] = res
                bad |= (any(res["rays_differing_from_parent"].values())
                        or res["stack_overflows"] > 0)
                for name in fns:
                    total[name] += res[name]["ms"]
                total["bound_ms"] += res["bound_ms"]
            results[f"{kernel}/total_{group}"] = total
            print(f"{card} | {kernel}/total_{group} over {len(items)} "
                  f"launches: " + ", ".join(f"{k} {v:.3f} ms"
                                            for k, v in total.items()))
    print(json.dumps(results))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
