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
- differ_outside_ties and time_runs on hand-made inputs.
"""

import importlib.util
import json
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
