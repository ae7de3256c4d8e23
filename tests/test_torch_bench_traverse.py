"""The traversal study of the PyTorch port
(tracerboy_tpu_torch/utils/bench_traverse.py) against the JAX package's
scripts/bench_traverse.py.

- make_ray_sets (primary, bounce, shadow, dead) and every coherence_sort
  mode are numpy with the same seed: bit for bit equal to the script's
  (the script is imported by path; it imports jax only inside main()).
- The entry point on the CPU at 2,048 rays on shadertoy:cornell runs every
  variant through the wrappers' plain versions and prints its result
  lines and one JSON line last; no tolerance: the counts of hits of the
  closest-hit variants must be equal on these rays (checked against each
  other, all walks of the same triangles), and v1 must have been called
  through its wrapper.
- The `wave` ray set on the CPU at a 16x12 film: one launch recorded per
  bounce and kind, with the lanes of the wave, each timed in each order;
  the sorted rays give the same hits; the wrappers are put back.
- The `binned-wave` set on the CPU at a 16x12 film: the five selections
  and ten dense launches of one TB_BINNED=1 render_sample(2), each with
  its bound, run lengths and row stages (each stage passes no more rows
  than the one before, per pair-row and per warp-row, and a warp-row
  passes wherever one of its pair-rows does); the wrappers and TB_BINNED
  are put back.
- The `heatmap-wave` set and --stats timing on the CPU at a 16x12 film:
  the stats kernel's two launches of a HEATMAP render_sample(1) and
  render_sample(2), whose lanes are the view's primary waves (16 x 12
  and 16 x 12 x 2, the rays the stats wrapper was given), each with its
  time and bound, and the sum; the `stats` line of a ray set with its
  time, quartiles, Mrays/s and bound; v1's bound; the wrapper put back.
- The `cut-wave` set on the CPU at a 16x12 film: the emit launches of a
  TB_CUT=1 render_sample(1) and render_sample(2), two a bounce (the main
  table before each closest-hit wave, the shadow table before each shadow
  wave), each with its lanes, live rays, emits, rays over K, time and
  bound, the sums per table and the total; emit_cuts and TB_CUT are put
  back. emit_walk, moved here from chip_smoke.py, gives the counts that
  chip_smoke.py's copy gave on tests/test_torch_cut.py's scene (pinned),
  equal to a serial walk of each ray, and emits equal to the filled slots
  of a table wide enough for every ray.
- differ_outside_ties and time_runs (with and without ahead) on
  hand-made inputs.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.trace import kernels
from tracerboy_tpu_torch.utils import bench_traverse as study

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "bench_traverse.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_bench_traverse",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes():
    return {name: load_scene(name, film_size=(64, 64))
            for name in ("shadertoy:cornell", "shadertoy")}


@pytest.mark.parametrize("n_rays", [2048, 3001])
@pytest.mark.parametrize("name", ["shadertoy:cornell", "shadertoy"])
def test_ray_sets_equal_the_scripts(script, scenes, name, n_rays):
    cs = scenes[name]
    ref = script.make_ray_sets(cs, n_rays, np.random.default_rng(7))
    got = study.make_ray_sets(cs, n_rays, np.random.default_rng(7))
    assert set(got) == set(ref) == {"primary", "bounce", "shadow", "dead"}
    for key in ref:
        for a, b in zip(got[key], ref[key]):
            assert a.dtype == b.dtype == np.float32
            assert a.shape[0] == n_rays
            np.testing.assert_array_equal(a, b)
    assert (got["dead"][2] == 0).all()
    assert (got["shadow"][2] > 0).all() and (got["shadow"][2] < 1e30).all()


@pytest.mark.parametrize("mode", study.SORT_MODES)
def test_coherence_sort_equals_the_scripts(script, scenes, mode):
    cs = scenes["shadertoy"]
    sets = study.make_ray_sets(cs, 4096, np.random.default_rng(7))
    lo, hi = cs.tri_v0.min(0), cs.tri_v0.max(0)
    for name in ("primary", "bounce", "shadow"):
        o, d, tm = sets[name]
        tm = tm.copy()
        tm[np.random.default_rng(1).random(tm.shape[0]) < 0.3] = 0.0
        ref = script.coherence_sort(o, d, lo, hi, mode, tm=tm)
        got = study.coherence_sort(o, d, lo, hi, mode, tm=tm)
        np.testing.assert_array_equal(got, ref)
        assert sorted(got.tolist()) == list(range(o.shape[0]))
        if mode == "oct-org-compact":
            dead = tm[got] <= 0
            assert not dead[: int((~dead).sum())].any()     # dead last
    with pytest.raises(ValueError):
        study.coherence_sort(o, d, lo, hi, "nearest-first")


def test_entry_point_on_the_cpu(capsys):
    kernels.reset_counters()
    results = study.main([
        "--scene", "shadertoy:cornell", "--rays", "2048", "--device", "cpu",
        "--runs", "2", "--variants", "v1,v2,v2any,wide", "--sort",
        "none,oct-org", "--stats"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == results
    assert results["device"].startswith("cpu")
    for set_name in ("primary", "bounce", "shadow"):
        for sort in ("none", "oct-org"):
            prefix = f"shadertoy:cornell/{set_name}/{sort}"
            hits = {v: results[f"{prefix}/{v}"]["hits"]
                    for v in ("v1", "v2", "wide")}
            assert hits["v1"] == hits["v2"] == hits["wide"] > 0
            for v in hits:
                r = results[f"{prefix}/{v}"]
                assert r["n"] == 2 and r["q1"] <= r["ms"] <= r["q3"]
                assert r["mrays_s"] > 0
            diff = results[f"{prefix}/v1_vs_v2"]
            assert diff["rays"] == 2048
            assert diff["hit_set"] == diff["other_triangle"] == 0
            st = results[f"{prefix}/stats"]
            assert st["live"] == 2048 and st["pops_mean"] >= 1
            assert st["need_wide"] >= 8           # every ray pops the root
            assert (f"{prefix}/v2any" in results) == (set_name == "shadow")
            assert (f"{prefix}/reorder" in results) == (sort != "none")
            # Every line of numbers names the device first.
            assert any(ln.startswith(results["device"]) and prefix in ln
                       for ln in lines)
    # The sort changes the order of the rays, not the set: same hit count.
    for set_name in ("primary", "bounce", "shadow"):
        assert (results[f"shadertoy:cornell/{set_name}/none/v1"]["hits"]
                == results[f"shadertoy:cornell/{set_name}/oct-org/v1"]["hits"])
    assert kernels.TWIN_CALLS["closest_v1"] > 0
    assert kernels.LAUNCHES["closest_v1"] == 0


def test_dead_rays_and_unknown_variant(capsys):
    res = study.main(["--scene", "shadertoy:cornell", "--rays", "512",
                      "--device", "cpu", "--runs", "1", "--variants", "v1",
                      "--sets", "dead,primary", "--sort", "oct-org-compact",
                      "--dead-frac", "0.5"])
    capsys.readouterr()
    assert res["shadertoy:cornell/dead/oct-org-compact/v1"]["hits"] == 0
    hits = res["shadertoy:cornell/primary/oct-org-compact/v1"]["hits"]
    assert 0 < hits < 512
    with pytest.raises(SystemExit):
        study.main(["--scene", "shadertoy:cornell", "--device", "cpu",
                    "--variants", "v2ns"])


def test_wave_ray_set_on_the_cpu(capsys):
    from tracerboy_tpu_torch.trace import traverse

    wrappers = traverse.closest_hit, traverse.any_hit
    res = study.main(["--scene", "shadertoy", "--rays", "64", "--sets",
                      "wave", "--sort", "none,oct-org", "--runs", "1",
                      "--device", "cpu", "--wave-film", "16x12",
                      "--wave-spp", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    assert (traverse.closest_hit, traverse.any_hit) == wrappers
    n_closest = res["shadertoy/wave/total_closest/none"]["launches"]
    n_shadow = res["shadertoy/wave/total_shadow/none"]["launches"]
    assert n_closest >= 2 and n_shadow >= 1
    for kind, count, vname in (("closest", n_closest, "v2"),
                               ("shadow", n_shadow, "v2any")):
        sums = dict(none=0.0, reorder=0.0)
        sums["oct-org"] = 0.0
        for i in range(count):
            plain = res[f"shadertoy/wave/{kind}_{i}/none/{vname}"]
            ordered = res[f"shadertoy/wave/{kind}_{i}/oct-org/{vname}"]
            # One merged wave of 2 samples: every launch has its lanes.
            assert plain["live"] == ordered["live"] <= 16 * 12 * 2
            assert plain["mrays_s"] > 0 and plain["n"] == 1
            sums["none"] += plain["ms"]
            sums["oct-org"] += ordered["ms"]
            sums["reorder"] += res[
                f"shadertoy/wave/{kind}_{i}/oct-org/reorder"]["ms"]
            assert f"shadertoy/wave/{kind}_{i}/none/reorder" not in res
        assert res["shadertoy/wave/closest_0/none/v2"]["live"] == 16 * 12 * 2
        total = res[f"shadertoy/wave/total_{kind}/oct-org"]
        assert total["kernel_ms"] == pytest.approx(sums["oct-org"])
        assert total["reorder_ms"] == pytest.approx(sums["reorder"])
        assert res[f"shadertoy/wave/total_{kind}/none"][
            "kernel_ms"] == pytest.approx(sums["none"])


def test_binned_wave_set_on_the_cpu(capsys, monkeypatch):
    from tracerboy_tpu_torch.trace import binned

    monkeypatch.delenv("TB_BINNED", raising=False)
    real = binned.select_clusters, binned.dense_pairs
    kernels.reset_counters()
    res = study.main(["--scene", "shadertoy", "--rays", "64", "--sets",
                      "binned-wave", "--runs", "1", "--device", "cpu",
                      "--wave-film", "16x12", "--wave-spp", "2",
                      "--variants", "v2"])
    assert (binned.select_clusters, binned.dense_pairs) == real
    assert "TB_BINNED" not in os.environ
    assert kernels.TWIN_CALLS["select"] > 0 and kernels.TWIN_CALLS["dense"] > 0
    key = "shadertoy/binned-wave"
    assert res[f"{key}/total_select"]["launches"] == 5
    assert res[f"{key}/total_dense"]["launches"] == 10
    first = res[f"{key}/select_0"]
    assert first["lanes"] == 16 * 12 * 2 and 0 < first["live"] <= first["lanes"]
    for i in range(10):
        r = res[f"{key}/dense_{i}"]
        if not r["pairs"]:          # a late bounce with no pair at 16x12
            continue
        assert r["bound_ms"] > 0
        assert r["ops"] == r["pairs"] * (12 + 128 * 49)
        assert 1 <= r["run_min"] <= r["run_mean"] <= r["run_max"]
        stages = list(r["stages"].values())
        for per_pair, per_warp in stages:
            assert 0.0 <= per_pair <= per_warp <= 1.0
        for a, b in zip(stages, stages[1:]):
            assert b[0] <= a[0] and b[1] <= a[1]
    out = capsys.readouterr().out
    assert "binned-wave/total_dense" in out and "rows in" in out


def test_heatmap_wave_set_and_stats_timing_on_the_cpu(capsys):
    from tracerboy_tpu_torch.trace import traverse

    real = traverse.closest_hit_stats
    kernels.reset_counters()
    res = study.main(["--scene", "shadertoy", "--rays", "64", "--sets",
                      "heatmap-wave,primary", "--sort", "none", "--runs",
                      "2", "--device", "cpu", "--wave-film", "16x12",
                      "--wave-spp", "2", "--variants", "v1", "--stats"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    assert traverse.closest_hit_stats is real
    assert kernels.TWIN_CALLS["closest_stats"] > 0
    key = "shadertoy/heatmap-wave"
    launches = [res[f"{key}/stats_{i}"] for i in range(2)]
    assert f"{key}/stats_2" not in res
    # One primary wave a render_sample: every pixel of each sample.
    assert [r["lanes"] for r in launches] == [16 * 12, 16 * 12 * 2]
    for r in launches:
        assert r["live"] == r["lanes"] and r["n"] == 2
        assert r["q1"] <= r["ms"] <= r["q3"] and r["mrays_s"] > 0
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    total = res[f"{key}/total"]
    assert total["launches"] == 2 and total["lanes"] == 16 * 12 * 3
    assert total["ms"] == pytest.approx(sum(r["ms"] for r in launches))
    st = res["shadertoy/primary/none/stats"]
    assert st["n"] == 2 and st["q1"] <= st["ms"] <= st["q3"]
    assert st["mrays_s"] > 0 and st["bound_ms"] > 0 and st["live"] == 64
    v1 = res["shadertoy/primary/none/v1"]
    assert v1["bound_ms"] > 0 and v1["ops"] > 0
    assert any(ln.startswith(res["device"]) and f"{key}/stats_1" in ln
               for ln in lines)


def test_recorded_stats_launches_are_the_heatmap_waves():
    """record_stats_launches hands back what the HEATMAP wave gave the
    stats wrapper: camera rays of every lane, and the same hits again."""
    from tracerboy_tpu_torch.trace import traverse

    calls = study.record_stats_launches("shadertoy", (16, 12), (1, 2),
                                        torch.device("cpu"))
    assert [c[0].shape[0] for c in calls] == [16 * 12, 16 * 12 * 2]
    o, d, tm, nodes, tris = calls[1]
    assert bool((tm > 0).all())
    # A pinhole camera: every ray of a sample leaves the same point.
    assert torch.equal(o[:1].expand(16 * 12, 3), o[:16 * 12])
    out = traverse.closest_hit_stats(o, d, tm, nodes, tris)
    assert int((out[1] >= 0).sum()) > 0 and bool((out[4] >= 1).all())


def test_recorded_wave_rays_are_the_waves():
    """record_wave_rays hands back what the wave gave the wrappers: the
    primary launch holds camera rays of every lane, later launches have
    dead lanes, and sorted or not the rays hit the same."""
    from tracerboy_tpu_torch.trace import traverse

    calls = study.record_wave_rays("shadertoy", (16, 12), 2,
                                   torch.device("cpu"))
    kinds = [c[0] for c in calls]
    assert kinds[0] == "closest" and set(kinds) == {"closest", "shadow"}
    _, o, d, tm, nodes, tris = calls[0]
    assert o.shape == (16 * 12 * 2, 3) and bool((tm > 0).all())
    assert any(bool((c[3] <= 0).any()) for c in calls[1:])
    kind, o, d, tm, nodes, tris = calls[2]
    assert kind == "closest"
    cs = load_scene("shadertoy", film_size=(16, 12))
    lo, hi = cs.tri_v0.min(0), cs.tri_v0.max(0)
    perm = torch.from_numpy(study.coherence_sort(
        o.numpy(), d.numpy(), lo, hi, "oct-org", tm=tm.numpy()))
    a = traverse.closest_hit(o, d, tm, nodes, tris)
    b = traverse.closest_hit(o[perm].contiguous(), d[perm].contiguous(),
                             tm[perm].contiguous(), nodes, tris)
    assert torch.equal(a[0][perm], b[0]) and int((a[1] >= 0).sum()) > 0


def test_differ_outside_ties():
    t = torch.tensor
    a = (t([1.0, 2.0, 1e30, 4.0, 5.0]), t([3, 7, -1, 9, 2]))
    b = (t([1.0, 2.0, 3.0, 4.00001, 6.0]), t([3, 8, 5, 10, 1]))
    res = study.differ_outside_ties(a, b)
    assert res == dict(rays=5, hit_set=1, only_first=0, only_second=1,
                       other_triangle=1, ties=2)


def test_time_runs_on_the_cpu():
    calls = []
    ms = study.time_runs(lambda: calls.append(1), 5, torch.device("cpu"),
                         warmup=2)
    assert ms.shape == (5,) and len(calls) == 7 and (ms >= 0).all()


def test_cut_wave_set_on_the_cpu(capsys, monkeypatch):
    from tracerboy_tpu_torch.trace import cut

    monkeypatch.delenv("TB_CUT", raising=False)
    real = cut.emit_cuts
    kernels.reset_counters()
    res = study.main(["--scene", "shadertoy", "--rays", "64", "--sets",
                      "cut-wave", "--runs", "2", "--device", "cpu",
                      "--wave-film", "16x12", "--wave-spp", "2",
                      "--variants", "v2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    assert cut.emit_cuts is real and "TB_CUT" not in os.environ
    assert kernels.TWIN_CALLS["emit"] > 0 and kernels.LAUNCHES["emit"] == 0
    key = "shadertoy/cut-wave"
    totals = {t: res[f"{key}/{t}"] for t in ("main", "shadow", "total")}
    assert totals["main"]["launches"] == totals["shadow"]["launches"] >= 2
    n = totals["total"]["launches"]
    assert n == totals["main"]["launches"] + totals["shadow"]["launches"]
    launches = []
    for table in ("main", "shadow"):
        for i in range(totals[table]["launches"]):
            r = res[f"{key}/{table}_{i}"]
            launches.append(r)
            assert r["lanes"] == 16 * 12 * r["spp"] and r["spp"] in (1, 2)
            assert 0 <= r["live"] <= r["lanes"] and r["n"] == 2
            assert r["q1"] <= r["ms"] <= r["q3"]
            assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                          "operations")
            assert 0 <= r["over_k"] <= r["live"]
            if r["live"]:
                assert r["emits_per_live"] > 0 and r["visits_per_live"] >= 1
    assert f"{key}/main_{totals['main']['launches']}" not in res
    # The camera wave: every lane live.
    assert res[f"{key}/main_0"]["live"] == 16 * 12
    for k in ("ms", "bound_ms", "lanes", "live"):
        assert totals["total"][k] == pytest.approx(
            sum(r[k] for r in launches))
        assert totals["total"][k] == pytest.approx(
            totals["main"][k] + totals["shadow"][k])
    assert any(ln.startswith(res["device"]) and f"{key}/shadow_0" in ln
               for ln in lines)


def test_recorded_cut_launches_are_two_a_bounce(monkeypatch):
    """record_cut_launches hands back what the TB_CUT=1 waves gave
    emit_cuts: the main table before each closest-hit wave, the shadow
    table before each shadow wave, in turn, with the lanes of the wave."""
    from tracerboy_tpu_torch.trace import cut

    monkeypatch.setenv("TB_CUT", "0")
    calls = study.record_cut_launches("shadertoy", (16, 12), (1, 2),
                                      torch.device("cpu"))
    assert os.environ["TB_CUT"] == "0"
    tables = [c[0] for c in calls]
    per_render = len(calls) // 2
    assert per_render >= 2 and per_render % 2 == 0
    assert tables == ["main", "shadow"] * per_render
    assert [c[1] for c in calls] == [1] * per_render + [2] * per_render
    for table, spp, (o, d, tm, top, n_cuts, K) in calls:
        assert o.shape == (16 * 12 * spp, 3) and K == 8
        assert top.shape[1] == 128 and 0 < n_cuts < top.shape[0] * 8
    main_top, shadow_top = calls[0][2][3], calls[1][2][3]
    assert not torch.equal(main_top[:, 48:56], shadow_top[:, 48:56])
    assert all(c[2][3] is (main_top if c[0] == "main" else shadow_top)
               for c in calls)
    o, d, tm, top, n_cuts, K = calls[0][2]
    ids = cut.emit_cuts(o, d, tm, top, n_cuts, K)
    assert bool((tm > 0).all()) and int((ids >= 0).sum()) > 0


def test_emit_walk_keeps_chip_smokes_counts():
    from test_torch_cut import _t, make_rays, make_scene
    from tracerboy_tpu_torch.accel.bvh import INVALID
    from tracerboy_tpu_torch.accel.pack import pack_scene
    from tracerboy_tpu_torch.trace import cut, traverse

    v0, v1, v2 = make_scene()
    pk, bvh = pack_scene(v0, v1, v2)
    tc = cut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size, 512)
    top = _t(tc["top_nodes"])
    o, d, tm = (_t(x) for x in make_rays())
    visits, rows, emits = study.emit_walk(o, d, tm, top)
    # chip_smoke.py's emit_walk gave these on the same inputs.
    assert (visits, int(rows.sum())) == (2456, 9)
    # A serial walk of each ray, one node at a time.
    b = top[:, :48].view(torch.float32).reshape(-1, 6, 8)
    lo, hi = b[:, 0:3].permute(0, 2, 1), b[:, 3:6].permute(0, 2, 1)
    serial, seen = 0, set()
    for i in torch.nonzero(tm > 0)[:, 0].tolist():
        inv = 1.0 / traverse.fix_dir(d[i:i + 1])
        stack = [0]
        while stack:
            node = stack.pop()
            serial += 1
            seen.add(node)
            t_near, t_far = traverse.box_entry(o[i:i + 1, None],
                                               inv[:, None], lo[node:node + 1],
                                               hi[node:node + 1])
            for c in range(8):
                cid = int(top[node, 48 + c])
                if (cid >= 0 and cid != INVALID
                        and bool(t_far[0, c] >= max(float(t_near[0, c]), 0.0))
                        and bool(t_near[0, c] < tm[i])):
                    stack.append(cid)
    assert serial == visits and seen == set(torch.nonzero(rows)[:, 0].tolist())
    # Emits: every emit child entered, counted past K too.
    wide = cut.emit_cuts_plain(o, d, tm, top, tc["n_cuts"], 64)
    assert (wide[:, -1] == -1).all() and emits == int((wide >= 0).sum())


def test_time_runs_ahead_on_the_cpu():
    """ahead waits on a card only: on the CPU the calls are timed by the
    host clock as without it."""
    calls = []
    ms = study.time_runs(lambda: calls.append(1), 3, torch.device("cpu"),
                         warmup=1, ahead=True)
    assert ms.shape == (3,) and len(calls) == 4 and (ms >= 0).all()
    assert study.AHEAD_CYCLES > 0
