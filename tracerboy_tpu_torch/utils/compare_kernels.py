"""Time the v1 closest-hit kernel, the stats kernel and the cut path's
emit kernel of this tree beside the same kernels built from other source
trees, in turns, on the rays each kernel gets, and check that all of them
give the same outputs bit for bit.

    python -m tracerboy_tpu_torch.utils.compare_kernels --parent TREE \
        [--parent TREE ...] [--kernels v1,stats,emit] [--runs 10]
        [--rays 921600] [--wave-film 1280x720] [--wave-spp 8]

To compare a parent commit with the working tree on one card, unpack the
parent into an ignored directory (git archive HEAD | tar -x -C
build/parent) and pass --parent build/parent. Each further --parent adds
one more tree to the turns (a candidate kernel, for instance).

A tree's sources (TREE/tracerboy_tpu_torch/csrc/bvh_traverse_v1.cu,
bvh_traverse.cu and cut_emit.cu, with that tree's headers) are built with
this tree's nvcc flags under names of their own and called through the C
entries of the thread-per-ray kernels, which take no ray counter and no
stack size:
    tb_closest_hit_v1(o, d, t_max, nodes, tris, n, t, tri, u, v,
                      overflow, stream)
    tb_closest_hit_stats(o, d, t_max, nodes, tris, n, t, tri, u, v, pops,
                         clusters, overflow, stream)
    tb_emit_cuts(o, d, t_max, top, n, K, n_cuts, ids, overflow, stream)
or, for the emit kernel of a tree that has it, through this tree's entry
tb_emit_cut_rows (the compact table of cut.compact_rows, the counters of
cut.ray_counters).
Each kernel runs as each tree's and as this tree's
(traverse_v1.closest_hit_v1, traverse.closest_hit_stats, cut.emit_cuts).
Ray sets: the traversal study's primary, bounce and shadow rays
(bench_traverse.make_ray_sets, default_rng(7)), each unsorted and sorted
oct-org, on the study's tables (pack_scene with raw_rows=True); for the
stats kernel also its `heatmap-wave` launches (record_stats_launches: one
HEATMAP render_sample(1) and one render_sample(--wave-spp) at
--wave-film), which are the only launches a render gives it. The emit
kernel runs on its `cut-wave` launches (record_cut_launches: one TB_CUT=1
render_sample(1) and one render_sample(--wave-spp) at --wave-film, on the
main and shadow cut tables of that render) and on the study's primary and
bounce rays (main table) and shadow rays (shadow table), unsorted.

Per kernel and set: the tree's outputs against each other tree's (rays on
which any output differs, and 0 stack overflows), then all timed in turns
(trees then this tree, and back: parent, tree, tree, parent for one
parent), --runs CUDA-event timings a turn (for the emit kernel on the
card alone: bench_traverse.time_runs with ahead, since a 921,600-lane
launch takes the card less time than the host takes to issue it); a line
gives each side's median over its turns, the quartiles and the bound
(bench_traverse.walk_bound, emit_bound). Sums over the study's six sets, the heatmap-wave launches and
the cut-wave launches (in all and by table) follow. Prints the card's name
and power limit first and one JSON object last; exits 1 if any output
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

from tracerboy_tpu_torch.trace import cut, kernels, traverse, traverse_v1
from tracerboy_tpu_torch.utils import bench_traverse as study
from tracerboy_tpu_torch.utils.build import build_shared_library, nvcc_path

PARENT_ENTRIES = {
    # kernel: (source, C entry, argument types: p pointer, i int)
    "v1": ("bvh_traverse_v1.cu", "tb_closest_hit_v1", "pppppi" + "p" * 6),
    "stats": ("bvh_traverse.cu", "tb_closest_hit_stats", "pppppi" + "p" * 8),
    "emit": ("cut_emit.cu", "tb_emit_cuts", "ppppiiippp"),
}
# The emit entry of a tree that walks the compact table.
EMIT_ROWS_ENTRY = ("tb_emit_cut_rows", "ppppiiiiipppp")


def parent_library(tree: Path, kernel: str):
    """A tree's library of `kernel`, built with this tree's flags under a
    name of its own (the tree's path enters the name's hash through -I);
    returns (library, C entry name)."""
    source, entry, types = PARENT_ENTRIES[kernel]
    csrc = tree.resolve() / "tracerboy_tpu_torch" / "csrc"
    flags = [f for f in kernels.NVCC_FLAGS if not f.startswith("-I")]
    path = build_shared_library(
        f"parent_{kernel}", [csrc / source],
        [nvcc_path(), *flags, f"-I{csrc}"], headers=sorted(csrc.glob("*.cuh")))
    lib = ctypes.CDLL(str(path))
    if kernel == "emit" and hasattr(lib, EMIT_ROWS_ENTRY[0]):
        entry, types = EMIT_ROWS_ENTRY
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int if c == "i" else ctypes.c_void_p
                   for c in types]
    return lib, entry


def tree_function(kernel: str, tree: Path):
    """fn(o, d, t_max, *tables) -> outputs of `kernel` built from tree."""
    lib, entry = parent_library(tree, kernel)

    def emit(o, d, tm, top, n_cuts, K):
        n = o.shape[0]
        ids = torch.empty((n, K), dtype=torch.int32, device=o.device)
        if entry == EMIT_ROWS_ENTRY[0]:
            rows, entries = cut.compact_rows(top)
            kernels.launch(lib, entry, o.device, o, d, tm, rows,
                           rows.shape[0], entries, n, K, int(n_cuts), ids,
                           cut.ray_counters(o.device))
        else:
            kernels.launch(lib, entry, o.device, o, d, tm, top, n, K,
                           int(n_cuts), ids)
        return (ids,)

    def walk(o, d, tm, nodes, tris):
        n = o.shape[0]
        n_out = 4 if kernel == "v1" else 6
        out = [torch.empty(n, dtype=torch.int32 if j in (1, 4, 5)
                           else torch.float32, device=o.device)
               for j in range(n_out)]
        kernels.launch(lib, entry, o.device, o, d, tm, nodes, tris, n, *out)
        return tuple(out)

    return emit if kernel == "emit" else walk


def variants(kernel: str, trees):
    """{name: fn(o, d, t_max, *tables) -> outputs} of one kernel: each
    tree's (the first "parent", the others by directory name), then this
    tree's ("tree")."""
    fns = {}
    for j, tree in enumerate(trees):
        name = "parent" if j == 0 else Path(tree).name
        fns[name] = tree_function(kernel, Path(tree))
    fns["tree"] = {"v1": traverse_v1.closest_hit_v1,
                   "stats": traverse.closest_hit_stats,
                   "emit": lambda *a: (cut.emit_cuts(*a),)}[kernel]
    return fns


def kernel_bound(kernel, o, d, tm, tables):
    """(bound ms, bound by) of one launch of `kernel` on these inputs."""
    if kernel == "v1":
        return study.walk_bound(o, d, tm, *tables,
                                traverse_v1.walk_footprint_v1, 16,
                                study.MT_OPS)[:2]
    if kernel == "stats":
        return study.walk_bound(o, d, tm, *tables, traverse.walk_footprint,
                                24)[:2]
    top, _, K = tables
    return study.bound(*study.emit_bound(o, d, tm, top, K)[:2])


def compare_set(kernel, fns, label, rays, tables, runs, device, card):
    """Outputs against the parent's, then the variants timed in turns."""
    o, d, tm = rays
    kernels.reset_counters()
    outs = {name: fn(o, d, tm, *tables) for name, fn in fns.items()}
    overflows = kernels.stack_overflows()
    ref = outs["parent"]
    differ = {name: int(torch.stack([(a != b).reshape(a.shape[0], -1)
                                     .any(1) for a, b in zip(out, ref)])
                        .any(0).sum())
              for name, out in outs.items() if name != "parent"}
    names = list(fns)
    samples: dict = {name: [] for name in names}
    for name in names + names[::-1]:
        samples[name].append(study.time_runs(
            lambda: fns[name](o, d, tm, *tables), runs, device,
            ahead=kernel == "emit"))
    bound = kernel_bound(kernel, o, d, tm, tables)
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
    ap.add_argument("--parent", type=Path, required=True, action="append",
                    help="a source tree; repeat for more trees")
    ap.add_argument("--kernels", default="v1,stats,emit")
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

    results: dict = dict(device=card, parent=[str(t) for t in args.parent],
                         rays=args.rays, runs=args.runs)
    bad = False
    for kernel in args.kernels.split(","):
        fns = variants(kernel, args.parent)
        tables = ((packed["nodes"], packed["tris"]) if kernel == "v1"
                  else (packed["nodes"], packed["tris_bw"]))
        groups = {"study": [(k, rays, tables)
                            for k, rays in study_sets.items()]}
        if kernel == "emit":
            film = tuple(int(x) for x in args.wave_film.split("x"))
            calls = study.record_cut_launches(
                "shadertoy", film, (1, args.wave_spp), device)
            seen = dict(main=0, shadow=0)
            items, tops = [], {}
            for table, _, c in calls:
                items.append((f"cut-wave/{table}_{seen[table]}", c[:3],
                              c[3:]))
                seen[table] += 1
                tops.setdefault(table, c[3:])
            groups = {"cut-wave": items, "study": [
                (f"{name}/none/{table}", study_sets[f"{name}/none"],
                 tops[table])
                for name, table in (("primary", "main"), ("bounce", "main"),
                                    ("shadow", "shadow"))]}
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
                  f"launches: " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in total.items()))
            if group == "cut-wave":
                for table in ("main", "shadow"):
                    part = {name: sum(results[f"{kernel}/{lb}"][name]["ms"]
                                      for lb, _, _ in items
                                      if f"/{table}_" in lb)
                            for name in fns}
                    results[f"{kernel}/total_{group}_{table}"] = part
                    print(f"{card} | {kernel}/total_{group}_{table}: "
                          + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in part.items()))
    print(json.dumps(results))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
