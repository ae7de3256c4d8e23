"""The plain closest- and any-hit twins' (ray, cluster) pairing, timed: the
exhaustive pairing (every live ray against every cluster box, in chunks
of traverse.PAIR_BUDGET slab tests) against the top-down pairing
traverse._chunks makes through the node table's inner slots.

    python -m tracerboy_tpu_torch.utils.plain_pairing [--size 1280x720]
        [--spp 8] [--device cuda] [--out FILE.json]

writes the demo scene's env.pbrt (utils/demo_scene.py), runs the CLI on it
(--spp 8, environment NEE on by auto) recording every closest- and
any-hit launch, as chip_smoke.py's CLI phase records them, then for each
launch times on the device (synchronised wall clock, one run each): the
exhaustive pairing alone, the twin on it (closest_hit_plain or
anyhit_plain with traverse._chunks swapped for exhaustive_chunks), the
top-down pairing alone and the twin as it is; and checks that both twins
give torch.equal results from the same number of pairs (pair_sets, for
the tests, compares the pairs themselves).
Prints one JSON object (seconds summed by kind, per-launch rows) and
exits 1 where anything differs. The tests use exhaustive_chunks as the
oracle of the top-down pairing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import torch

from tracerboy_tpu_torch.trace import traverse


def exhaustive_pairs(o, inv, tmax, lo, hi):
    """(ray, cluster) index pairs whose cluster box (lo, hi, (C, 3)) the
    ray enters in t_max: every ray against every box."""
    hit = traverse._box_hit(o[:, None], inv[:, None], tmax[:, None],
                            lo[None], hi[None])
    return hit.nonzero(as_tuple=True)


def exhaustive_chunks(o, d, t_max, nodes, tris_bw):
    """traverse._chunks with the exhaustive pairing: chunks of at most
    PAIR_BUDGET (ray, cluster) slab tests."""
    C = tris_bw.shape[0]
    lo, hi = traverse.cluster_boxes(nodes, C)
    live = (t_max > 0).nonzero(as_tuple=True)[0]
    step = max(1, traverse.PAIR_BUDGET // max(C, 1))
    for s in range(0, live.shape[0], step):
        ids = live[s:s + step]
        oc, dc, tc = o[ids], d[ids], t_max[ids]
        ri, ci = exhaustive_pairs(oc, 1.0 / traverse.fix_dir(dc), tc, lo, hi)
        if ri.numel() == 0:
            continue
        t, u, v, ok = traverse._bw_tests(oc[ri], dc[ri], tris_bw[ci])
        ok = ok & (t < tc[ri][:, None])
        yield ids, ri, ci, t, u, v, ok


@contextlib.contextmanager
def exhaustive():
    """The plain twins with the exhaustive pairing."""
    real = traverse._chunks
    traverse._chunks = exhaustive_chunks
    try:
        yield
    finally:
        traverse._chunks = real


def pair_sets(o, d, t_max, nodes, tris_bw):
    """The (ray, cluster) pairs of both pairings, each as sorted keys
    ray * C + cluster over the live rays."""
    C = tris_bw.shape[0]
    keys = []
    for chunks in (exhaustive_chunks, traverse._chunks):
        k = [ids[ri] * C + ci for ids, ri, ci, *_ in
             chunks(o, d, t_max, nodes, tris_bw)]
        keys.append(torch.sort(torch.cat(k) if k else
                               torch.zeros(0, dtype=torch.int64,
                                           device=o.device))[0])
    return keys


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t


def _pairing_only(chunks, o, d, t_max, nodes, tris_bw):
    """Runs a pairing over every chunk, no twin reductions after it."""
    n = 0
    for ids, ri, *_ in chunks(o, d, t_max, nodes, tris_bw):
        n += ri.numel()
    return n


def measure(calls, any_hit: bool) -> dict:
    """Per recorded launch (o, d, t_max, nodes, tris_bw): the seconds of
    each pairing alone and of the twin on each, and whether both twins and
    both pair sets agree."""
    plain = traverse.anyhit_plain if any_hit else traverse.closest_hit_plain
    rows = []
    for o, d, tm, nodes, tris in calls:
        dev = o.device
        traverse.check_table(nodes, tris.shape[0])
        n_old, old_pair_s = _timed(lambda: _pairing_only(
            exhaustive_chunks, o, d, tm, nodes, tris), dev)
        n_new, new_pair_s = _timed(lambda: _pairing_only(
            traverse._chunks, o, d, tm, nodes, tris), dev)
        with exhaustive():
            old, old_s = _timed(lambda: plain(o, d, tm, nodes, tris), dev)
        new, new_s = _timed(lambda: plain(o, d, tm, nodes, tris), dev)
        old = old if isinstance(old, tuple) else (old,)
        new = new if isinstance(new, tuple) else (new,)
        rows.append(dict(
            live=int((tm > 0).sum()), pairs_exhaustive=n_old,
            pairs_top_down=n_new, exhaustive_pairing_s=old_pair_s,
            top_down_pairing_s=new_pair_s, plain_exhaustive_s=old_s,
            plain_top_down_s=new_s,
            equal=all(torch.equal(a, b) for a, b in zip(old, new))))
    keys = ("exhaustive_pairing_s", "top_down_pairing_s",
            "plain_exhaustive_s", "plain_top_down_s")
    res = {k: sum(r[k] for r in rows) for k in keys}
    res.update(launches=len(rows), live=sum(r["live"] for r in rows),
               equal=all(r["equal"] and r["pairs_exhaustive"]
                         == r["pairs_top_down"] for r in rows),
               pairing_share_of_exhaustive=res["exhaustive_pairing_s"]
               / max(res["plain_exhaustive_s"], 1e-9), per_launch=rows)
    return res


def record_env_run(tmp, size, spp, device):
    """The CLI on the demo scene's env.pbrt; returns its recorded
    closest- and any-hit launches."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    env_scene, _ = write_demo_scene(tmp)
    recorded = {"any_hit": [], "closest_hit": []}
    real = {key: getattr(traverse, key) for key in recorded}

    def recorder(key):
        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            recorded[key].append((o.clone(), d.clone(), t_max.clone(),
                                  nodes, tris_bw))
            return real[key](o, d, t_max, nodes, tris_bw, roots)
        return recording

    for key in recorded:
        setattr(traverse, key, recorder(key))
    try:
        rc = cli.main([env_scene, "--size", size, "--spp", str(spp),
                       "--out", os.path.join(tmp, "env.png"), "--quiet",
                       "--device", device])
    finally:
        for key, fn in real.items():
            setattr(traverse, key, fn)
    if rc != 0:
        raise SystemExit(f"CLI exit {rc}")
    return recorded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="tb_pairing_") as tmp:
        recorded = record_env_run(tmp, args.size, args.spp, args.device)
        res = {"size": args.size, "spp": args.spp, "device": args.device}
        if args.device.startswith("cuda"):
            res["card"] = torch.cuda.get_device_name(0)
        res["closest_hit"] = measure(recorded["closest_hit"], any_hit=False)
        res["any_hit"] = measure(recorded["any_hit"], any_hit=True)
    text = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    summary = {k: {kk: v for kk, v in res[k].items() if kk != "per_launch"}
               for k in ("closest_hit", "any_hit")}
    print(json.dumps(dict(res, **summary)))
    return 0 if res["closest_hit"]["equal"] and res["any_hit"]["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
