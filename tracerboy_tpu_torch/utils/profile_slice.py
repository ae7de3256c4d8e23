"""Time and profile the slice on one CUDA device.

    python -m tracerboy_tpu_torch.utils.profile_slice [--out DIR]
        [--scene SCENE]

--scene (default "shadertoy"; any name load_scene takes, such as a .pbrt
file) at 1280x720 (on the path the environment selects: TB_CUT=1
and/or TB_BINNED=1 profile the cut or binned slice): after a warm-up
render_sample(1) and
render_sample(8), REPS timed calls of each (host clock around work that ends
in torch.cuda.synchronize(); median, quartiles, min, max), the peak
memory of an 8-sample wave, the time of current_image(), and one
torch.profiler trace of each call. From a trace's device events it
reports the device span (first kernel start to last kernel end), the
busy time (union of kernel intervals), the idle share of the span, the
busy time by kernel class (the cut path's emit kernel and the binned
path's selection and dense kernels each a class of their own), each
traversal kernel launch in order (closest hit and any hit alternate, one
pair per bounce on the default path; the HEATMAP view's primary wave is
closest_hit_stats) and, printed as lines after the card's name, the
closest-hit and any-hit time of each bounce with their sums (in a scene
with alpha cutouts each closest-hit launch, main wave, re-fire or shadow
round, opens a row of its own: there is no any-hit launch). Then
"shadertoy:cornell" at 512x512 on the brute-force path, and RealTime mode
on "shadertoy" at 1280x720: REPS timed frames of
render_realtime_frame_fused after three warm-up frames, and the same
device summary of one more frame (a 1-spp demodulated wave and the post
chain).

Prints the card's name and power limit, then one JSON object; writes the
JSON and the Chrome traces into --out (default build/profile/).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from tracerboy_tpu_torch import OutputSettings, RenderMode, Renderer
from tracerboy_tpu_torch.trace import binned, cut, traverse
from tracerboy_tpu_torch.utils.build import REPO_ROOT

KERNEL_CLASSES = (
    ("traversal", ("octet_kernel", "traverse_")),
    ("emit", ("emit_kernel",)),
    ("select", ("select_kernel",)),
    ("dense", ("dense_kernel",)),
    ("gather_scatter", ("index", "gather", "scatter")),
    ("cat_stack", ("cat", "stack")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduce", ("reduce",)),
)
REPS = 10


def _timed(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _quartiles(xs):
    return dict(n=len(xs), median=float(np.median(xs)),
                q1=float(np.percentile(xs, 25)),
                q3=float(np.percentile(xs, 75)),
                min=float(min(xs)), max=float(max(xs)))


def _classify(name):
    name = name.lower()   # e.g. CatArrayBatchedCopy
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def _traversal_kind(name):
    """A kernel of csrc/bvh_traverse.cu (octet_kernel<kAnyHit>,
    traverse_stats_kernel) -> its wrapper's name."""
    if "stats" in name:
        return "closest_hit_stats"
    any_hit = any(k in name for k in ("<true", "<(bool)1"))
    return "any_hit" if any_hit else "closest_hit"


def _by_bounce(launches):
    """The traversal launches of one wave, in launch order, as rows
    [closest-hit ms, any-hit ms] per bounce: a closest hit (or the stats
    kernel) opens a bounce, the any hits up to the next one are its
    shadow waves."""
    rows = []
    for kind, ms in launches:
        if kind != "any_hit":
            rows.append([ms, 0.0])
        elif rows:
            rows[-1][1] += ms
    return rows


def _device_summary(prof):
    """Span, busy time, idle share and per-class time (ms) of the device
    events of one profile."""
    evs = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not evs:
        return dict(n_device_events=0)
    iv = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in iv) - iv[0][0]
    by_class: dict = {}
    for e in evs:
        k = _classify(e.name)
        by_class[k] = by_class.get(k, 0.0) + (e.time_range.end
                                              - e.time_range.start) / 1e3
    trav = sorted((e.time_range.start, e.name, e.time_range.end
                   - e.time_range.start) for e in evs
                  if _classify(e.name) == "traversal")
    launches = [(_traversal_kind(name), d / 1e3) for _, name, d in trav]
    return dict(
        n_device_events=len(evs), span_ms=span / 1e3, busy_ms=busy / 1e3,
        idle_share=1.0 - busy / span if span > 0 else 0.0,
        by_class_ms=by_class,
        traversal_launches_ms=launches,
        traversal_by_bounce_ms=_by_bounce(launches),
    )


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=REPO_ROOT / "build" / "profile")
    ap.add_argument("--scene", default="shadertoy",
                    help="the scene of the first cell (load_scene name)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    args.out.mkdir(parents=True, exist_ok=True)
    card = _card()
    print(card)
    for module in (traverse, cut, binned):
        module.build_kernels()

    res = dict(card=card, scene=args.scene)
    r = Renderer(args.scene, film_size=(1280, 720), device="cuda")
    r.render_sample(1)
    r.render_sample(8)
    cell = {}
    for n in (1, 8):
        rays0 = r.rays_traced
        ts = _timed(lambda: r.render_sample(n), REPS)
        rays = (r.rays_traced - rays0) / REPS
        med = float(np.median(ts))
        cell[f"render_sample_{n}_s"] = _quartiles(ts)
        cell[f"render_sample_{n}_rays"] = rays
        cell[f"render_sample_{n}_ms_per_sample"] = med / n * 1e3
        cell[f"render_sample_{n}_mrays_s"] = rays / med / 1e6
    torch.cuda.reset_peak_memory_stats()
    r.render_sample(8)
    torch.cuda.synchronize()
    cell["peak_gib_render_sample_8"] = (torch.cuda.max_memory_allocated()
                                        / 2**30)
    cell["current_image_s"] = _quartiles(_timed(r.current_image, 5))
    res["slice_1280x720"] = cell

    from torch.profiler import ProfilerActivity, profile

    for n in (8, 1):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r.render_sample(n)
            torch.cuda.synchronize()
        summary = _device_summary(prof)
        summary["wall_ms_profiled"] = (time.perf_counter() - w0) * 1e3
        rows = summary.get("traversal_by_bounce_ms", [])
        for b, (closest_ms, any_ms) in enumerate(rows):
            print(f"{card} | render_sample({n}) bounce {b}: closest hit "
                  f"{closest_ms:.3f} ms, any hit {any_ms:.3f} ms")
        print(f"{card} | render_sample({n}) traversal: closest hit "
              f"{sum(r[0] for r in rows):.3f} ms, any hit "
              f"{sum(r[1] for r in rows):.3f} ms over {len(rows)} bounces")
        res[f"profile_render_sample_{n}"] = summary
        prof.export_chrome_trace(str(args.out / f"trace_render_sample_{n}"
                                     ".json"))
    del r

    c = Renderer("shadertoy:cornell", film_size=(512, 512), device="cuda")
    c.render_sample(1)
    rays0 = c.rays_traced
    ts = _timed(lambda: c.render_sample(1), 5)
    res["cornell_512x512"] = dict(
        render_sample_1_s=_quartiles(ts),
        mrays_s=(c.rays_traced - rays0) / 5 / float(np.median(ts)) / 1e6)
    del c

    rt = Renderer("shadertoy", film_size=(1280, 720), device="cuda",
                  settings=OutputSettings(render_mode=RenderMode.REAL_TIME))
    for _ in range(3):
        rt.render_realtime_frame_fused()
    ts = _timed(rt.render_realtime_frame_fused, REPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.render_realtime_frame_fused()
        torch.cuda.synchronize()
    res["realtime_1280x720"] = dict(frame_s=_quartiles(ts),
                                    profile_frame=_device_summary(prof))
    prof.export_chrome_trace(str(args.out / "trace_realtime_frame.json"))
    res["card_after"] = _card()

    text = json.dumps(res, indent=1)
    (args.out / "profile_slice.json").write_text(text)
    print(text)


if __name__ == "__main__":
    main()
