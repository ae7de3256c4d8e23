"""Time the slice's render_sample(8) in several source trees, in turns.

    python -m tracerboy_tpu_torch.utils.compare_trees TREE [TREE ...]
        [--order 0,1,1,0] [--reps 5] [--view LIT] [--env TB_CUT=1]

To compare a parent commit with the working tree on one card, unpack the
parent into an ignored directory (git archive HEAD | tar -x -C
build/parent) and pass `build/parent .` with the order 0,1,1,0.

Each turn is one process started in a tree, with that tree's package and
its own kernel build (build/ of the tree): "shadertoy" at 1280x720 on the
default path in the given view, a warm-up render_sample(1) and
render_sample(8), then REPS timed render_sample(8) calls (host clock
around work that ends in torch.cuda.synchronize()) and the peak device
memory of one more. Prints the card's name and power limit, one JSON
line per turn, then one JSON summary by tree: the median, quartiles, min
and max of ms per sample over all the tree's timed calls and its largest
peak. The opt-in variables (TB_CUT, TB_BINNED, ...) are unset for every
turn, then set as --env gives them (the path to time).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

CHILD = r"""
import dataclasses, json, sys, time
import torch
from tracerboy_tpu_torch import OutputType, Renderer
reps, view = int(sys.argv[1]), sys.argv[2]
r = Renderer("shadertoy", film_size=(1280, 720), device="cuda")
r.settings = dataclasses.replace(r.settings, output_type=OutputType[view])
r.render_sample(1)
r.render_sample(8)
ts = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_sample(8)
    torch.cuda.synchronize()
    ts.append(time.perf_counter() - t0)
torch.cuda.reset_peak_memory_stats()
r.render_sample(8)
torch.cuda.synchronize()
print(json.dumps(dict(ms_per_sample=[t / 8 * 1e3 for t in ts],
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30)))
"""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--order", default=None,
                    help="comma-separated tree indices (default 0,1,...)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--view", default="LIT")
    ap.add_argument("--env", action="append", default=[],
                    help="KEY=VALUE set in every turn, e.g. TB_BINNED=1")
    args = ap.parse_args(argv)
    trees = [t.resolve() for t in args.trees]
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(trees))))
    print(_card())
    env = {k: v for k, v in os.environ.items() if not k.startswith("TB_")}
    env.update(kv.split("=", 1) for kv in args.env)
    runs: dict = {i: [] for i in set(order)}
    for turn, i in enumerate(order):
        res = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.reps), args.view],
            cwd=trees[i], env=dict(env, PYTHONPATH=str(trees[i])),
            capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"turn {turn} in {trees[i]} failed:\n"
                             f"{res.stdout}{res.stderr}")
        out = json.loads(res.stdout.strip().splitlines()[-1])
        runs[i].append(out)
        print(json.dumps(dict(turn=turn, tree=str(args.trees[i]), **out)))
    summary = {}
    for i, outs in runs.items():
        ms = np.concatenate([o["ms_per_sample"] for o in outs])
        summary[str(args.trees[i])] = dict(
            view=args.view, env=args.env, n=int(ms.size),
            median=float(np.median(ms)),
            q1=float(np.percentile(ms, 25)), q3=float(np.percentile(ms, 75)),
            min=float(ms.min()), max=float(ms.max()),
            peak_gib=max(o["peak_gib"] for o in outs))
    print(json.dumps(dict(card=_card(), ms_per_sample_by_tree=summary)))


if __name__ == "__main__":
    main()
