"""Time the slice's render_sample(8) in several source trees, in turns.

    python -m tracerboy_tpu_torch.utils.compare_trees TREE [TREE ...]
        [--order 0,1,1,0] [--reps 5] [--view LIT] [--env TB_CUT=1]
        [--what sample8|sample1|realtime]

To compare a parent commit with the working tree on one card, unpack the
parent into an ignored directory (git archive HEAD | tar -x -C
build/parent) and pass `build/parent .` with the order 0,1,1,0.

Each turn is one process started in a tree, with that tree's package and
its own kernel build (build/ of the tree): "shadertoy" at 1280x720 on the
default path in the given view, a warm-up render_sample(1) and
render_sample(8), then REPS timed render_sample(8) calls (host clock
around work that ends in torch.cuda.synchronize()) and the peak device
memory of one more. With --what sample1 the timed call is render_sample(1)
(one 921,600-lane wave: launch-bound), with --what realtime one
render_realtime_frame_fused() of a RealTime-mode renderer after three
warm-up frames; both are host-bound, so read them only in turns. Prints
the card's name and power limit, one JSON
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
from tracerboy_tpu_torch import (OutputSettings, OutputType, RenderMode,
                                 Renderer)
reps, view, what = int(sys.argv[1]), sys.argv[2], sys.argv[3]
if what == "realtime":
    r = Renderer("shadertoy", film_size=(1280, 720), device="cuda",
                 settings=OutputSettings(render_mode=RenderMode.REAL_TIME))
    call, per = r.render_realtime_frame_fused, 1
    for _ in range(3):
        call()
else:
    r = Renderer("shadertoy", film_size=(1280, 720), device="cuda")
    r.settings = dataclasses.replace(r.settings,
                                     output_type=OutputType[view])
    per = 1 if what == "sample1" else 8
    call = lambda: r.render_sample(per)
    r.render_sample(1)
    r.render_sample(8)
ts = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    ts.append(time.perf_counter() - t0)
torch.cuda.reset_peak_memory_stats()
call()
torch.cuda.synchronize()
print(json.dumps(dict(ms_per_sample=[t / per * 1e3 for t in ts],
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
    ap.add_argument("--what", default="sample8",
                    choices=("sample8", "sample1", "realtime"),
                    help="the timed call: render_sample(8), render_sample(1) "
                         "or one RealTime frame (ms per sample or frame)")
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
            [sys.executable, "-c", CHILD, str(args.reps), args.view,
             args.what],
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
            view=args.view, env=args.env, what=args.what, n=int(ms.size),
            median=float(np.median(ms)),
            q1=float(np.percentile(ms, 25)), q3=float(np.percentile(ms, 75)),
            min=float(ms.min()), max=float(ms.max()),
            peak_gib=max(o["peak_gib"] for o in outs))
    print(json.dumps(dict(card=_card(), ms_per_sample_by_tree=summary)))


if __name__ == "__main__":
    main()
