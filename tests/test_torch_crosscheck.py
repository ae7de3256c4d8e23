"""The JAX package's row-layout cross-check functions, ported for the
tests (the wave runs their SoA forms): core/rng.uniform2,
apply_lds_rotation and blue_noise_streams, trace/camera.
generate_primary_rays, shade/surface.fetch_material and
shade/nee.sample_one_light, each held against the JAX function on the
same numpy inputs and against the port's SoA form; and WaveConfig's
alpha_rounds and shadow_glass_rounds, set to 1 in both packages.

Tolerances: the randoms and the blue-noise streams bit for bit; the rays
to 1e-5 relative (the port's aperture offset is computed in float64);
materials bit for bit against the SoA form, to 1e-6 against JAX (its
one-hot table lookups); light samples to 1e-5 relative on >= 99% of
lanes (the JAX RIS pick is a cumulative sum, the port's a running sum);
the alpha stages and the wave as tests/test_torch_alpha.py bounds them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_alpha import JaxRenderer, _leaf_rays, assert_close, \
    write_leaf_field
from tracerboy_tpu_torch.core import rng as trng
from tracerboy_tpu_torch.core import vec3 as v3
from tracerboy_tpu_torch.trace import kernels
from tracerboy_tpu_torch.trace import wavefront as wf

torch.set_num_threads(2)

LANES = np.arange(0, 4096, 7, dtype=np.int64)


def _scene(name="shadertoy"):
    """The JAX scene pytree and the port's tensors of the same compile."""
    import jax

    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
    from tracerboy_tpu_torch.scene.compile import from_jax_pytree

    tree = jax_load_scene(name, film_size=(32, 24)).as_pytree(
        pack_pallas=True)
    return tree, from_jax_pytree(jax.tree_util.tree_map(np.asarray, tree),
                                 "cpu")


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_uniform2_row_layout(sampler):
    import jax.numpy as jnp

    from tracerboy_tpu.core import rng as jrng

    lanes = torch.from_numpy(LANES)
    for sample, bounce, stream, seed in ((0, 0, 0, 0), (7, 3, 4, 11),
                                         (1000, 31, 79, 12345)):
        got = trng.uniform2(lanes, sample, bounce, stream, seed, sampler)
        want = np.asarray(jrng.uniform2(jnp.asarray(LANES.astype(np.int32)),
                                        sample, bounce, stream, seed,
                                        sampler))
        assert got.shape == (len(LANES), 2)
        np.testing.assert_array_equal(got.numpy(), want)
        u, v = trng.uniform2_soa(lanes, sample, bounce, stream, seed,
                                 sampler)
        assert torch.equal(got, torch.stack([u, v], -1))


@pytest.mark.parametrize("frame", [0, 1, 5, 1023])
def test_blue_noise_streams(frame):
    import jax.numpy as jnp

    from tracerboy_tpu.core import rng as jrng

    rng = np.random.default_rng(frame)
    blue0, blue1 = (rng.random((256, 256, 4), np.float32) for _ in "01")
    px = rng.integers(0, 1280, 500)
    py = rng.integers(0, 720, 500)
    got = trng.blue_noise_streams(torch.from_numpy(blue0),
                                  torch.from_numpy(blue1),
                                  torch.from_numpy(px), torch.from_numpy(py),
                                  frame)
    want = jrng.blue_noise_streams(jnp.asarray(blue0), jnp.asarray(blue1),
                                   jnp.asarray(px), jnp.asarray(py), frame)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    noise = torch.from_numpy(blue0[py % 256, px % 256, 0:2])
    np.testing.assert_array_equal(
        trng.apply_lds_rotation(noise, frame).numpy(),
        np.asarray(jrng.apply_lds_rotation(jnp.asarray(noise.numpy()),
                                           frame)))


@pytest.mark.parametrize("dof", [False, True])
def test_generate_primary_rays(dof):
    import jax.numpy as jnp

    from tracerboy_tpu.trace.camera import generate_primary_rays as jax_gen
    from tracerboy_tpu_torch.trace.camera import (
        generate_primary_rays,
        generate_primary_rays_soa,
    )

    tree, scene = _scene()
    W, H = 64, 48
    rng = np.random.default_rng(3)
    ids = rng.integers(0, W * H, 700)
    jit = rng.random((700, 2), np.float32)
    djit = rng.random((700, 2), np.float32) if dof else None
    kw = dict(dof_focus_distance=4.0 if dof else 0.0,
              dof_aperture_width=0.1, filter_width=1.5)
    o, d = generate_primary_rays(
        scene["camera"], W, H, torch.from_numpy(ids), torch.from_numpy(jit),
        dof_jitter=None if djit is None else torch.from_numpy(djit), **kw)
    jo, jd = jax_gen(tree["camera"], W, H, jnp.asarray(ids),
                     jnp.asarray(jit),
                     dof_jitter=None if djit is None else jnp.asarray(djit),
                     **kw)
    assert o.shape == d.shape == (700, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    so, sd = generate_primary_rays_soa(
        scene["camera"], W, H, torch.from_numpy(ids),
        torch.from_numpy(jit[:, 0]), torch.from_numpy(jit[:, 1]),
        kw["dof_focus_distance"], kw["dof_aperture_width"],
        *((None, None) if djit is None else (torch.from_numpy(djit[:, 0]),
                                             torch.from_numpy(djit[:, 1]))),
        filter_width=kw["filter_width"])
    assert torch.equal(o, v3.to_rows(so)) and torch.equal(d, v3.to_rows(sd))


def test_fetch_material():
    import jax.numpy as jnp

    from tracerboy_tpu.shade.surface import fetch_material as jax_fetch
    from tracerboy_tpu_torch.shade.surface import (
        fetch_material,
        fetch_material_soa,
    )

    tree, scene = _scene()
    M = scene["materials"]["flags"].shape[0]
    rng = np.random.default_rng(4)
    n = 600
    mid = rng.integers(-1, M + 1, n)
    uv = rng.random((n, 2), np.float32) * 3 - 1
    back = rng.random(n) < 0.3
    args = (torch.from_numpy(mid), torch.from_numpy(uv),
            torch.from_numpy(back), torch.arange(n), 5, 2)
    got = fetch_material(scene, *args, seed=3)
    want = jax_fetch(tree, jnp.asarray(mid.astype(np.int32)),
                     jnp.asarray(uv), jnp.asarray(back),
                     jnp.asarray(args[3].numpy().astype(np.int32)), 5, 2,
                     seed=3)
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
    soa = fetch_material_soa(scene, args[0], args[1][:, 0], args[1][:, 1],
                             *args[2:], seed=3)
    assert set(got) == set(soa) | {"alpha_tex"}
    for k, v in soa.items():
        want_k = v3.to_rows(v) if isinstance(v, v3.V3) else v
        assert torch.equal(got[k], want_k), k


@pytest.mark.parametrize("use_ris", [False, True])
def test_sample_one_light(use_ris):
    import jax.numpy as jnp

    from tracerboy_tpu.shade.nee import sample_one_light as jax_sample
    from tracerboy_tpu_torch.shade.nee import (
        sample_one_light,
        sample_one_light_soa,
    )

    tree, scene = _scene("shadertoy:cornell")
    n_lights = int(scene["lights"]["ltype"].shape[0])
    assert n_lights > 0
    rng = np.random.default_rng(5)
    pos = (rng.random((len(LANES), 3), np.float32) * 2 - 1).astype(
        np.float32)
    lanes = torch.from_numpy(LANES)
    got = sample_one_light(scene["lights"], n_lights, torch.from_numpy(pos),
                           lanes, 3, 1, use_ris=use_ris, seed=7)
    want = jax_sample(tree["lights"], n_lights, jnp.asarray(pos),
                      jnp.asarray(LANES.astype(np.int32)), 3, 1,
                      use_ris=use_ris, seed=7)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        close = close.all(-1) if close.ndim > 1 else close
        assert close.mean() >= 0.99, (k, close.mean())
    soa = sample_one_light_soa(scene["lights"], n_lights,
                               v3.V3(*torch.from_numpy(pos.T.copy())), lanes,
                               3, 1, use_ris, 7)
    for k, v in soa.items():
        want_k = v3.to_rows(v) if isinstance(v, v3.V3) else v
        assert torch.equal(got[k], want_k), k


@pytest.mark.parametrize("stage", ["closest", "occluded", "transmittance"])
def test_one_round_alpha_stages_match_jax(tmp_path, stage):
    """alpha_rounds = shadow_glass_rounds = 1 in both packages: the alpha
    stages on the leaf field (tests/test_torch_alpha.py's comparison, the
    port's "wide" backend against the JAX "jnp" one) agree, and differ
    from the default three rounds."""
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as jv3
    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
    from tracerboy_tpu.trace import wavefront as jwf
    from tracerboy_tpu_torch.scene.compile import load_scene

    path = write_leaf_field(tmp_path)
    cs = load_scene(path, use_cache=False)
    scene = cs.as_tensors("cpu")
    ref_scene = jax_load_scene(path, use_cache=False).as_pytree()
    o, d, tm = _leaf_rays(cs, 4096, seed=11)
    one = dict(alpha_rounds=1, shadow_glass_rounds=1)
    jcfg = jwf.WaveConfig(width=8, height=8, traversal="jnp", has_alpha=True,
                          leaf_size=cs.leaf_size, **one)
    cfg = wf.WaveConfig(width=8, height=8, traversal="wide", has_alpha=True,
                        leaf_size=cs.leaf_size, **one)
    jargs = (jv3.V3(*jnp.asarray(o.T)), jv3.V3(*jnp.asarray(d.T)),
             jnp.asarray(tm))
    args = (v3.V3(*torch.from_numpy(o.T.copy())),
            v3.V3(*torch.from_numpy(d.T.copy())), torch.from_numpy(tm))
    fn = {"closest": "_closest_dispatch", "occluded": "_occluded_dispatch",
          "transmittance": "_shadow_transmittance"}[stage]
    want = jwf.__dict__[fn](ref_scene, *jargs, jcfg)
    got = wf.__dict__[fn](scene, *args, cfg)
    three = wf.__dict__[fn](scene, *args, dataclasses.replace(
        cfg, alpha_rounds=3, shadow_glass_rounds=3))
    if stage == "closest":
        want, got, three = ([np.asarray(x) for x in r[:2]]
                            for r in (want, got, three))
        hit = want[1] >= 0
        np.testing.assert_array_equal(got[1] >= 0, hit)
        np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
        assert (hit & (got[1] == want[1])).sum() >= 0.999 * hit.sum()
        assert (got[1] != three[1]).sum() > 10
    elif stage == "occluded":
        want, got, three = (np.asarray(x) for x in (want, got, three))
        assert (got == want).mean() >= 0.999
        assert (got != three).sum() > 10
    else:
        want, got, three = (np.asarray(x) for x in (want, got, three))
        assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() >= 0.999
        assert (np.abs(got - three) > 1e-6).sum() > 10


def test_one_round_wave_matches_jax(tmp_path, monkeypatch):
    """A whole wave on the leaf field with alpha_rounds =
    shadow_glass_rounds = 1 in both packages (the port's twin backend, the
    JAX jnp one): radiance within tests/test_torch_alpha.py's bound, and
    the port traces at most 1 + 1 main closest-hit rounds and 1 + 1
    shadow rounds a bounce."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import wavefront as jwf
    from tracerboy_tpu_torch import Renderer

    path = write_leaf_field(tmp_path)
    monkeypatch.setenv("TB_TRAVERSAL", "jnp")
    ref = JaxRenderer(path, film_size=(24, 18))
    jcfg = dataclasses.replace(ref.wave_config(), alpha_rounds=1,
                               shadow_glass_rounds=1)
    jout = jwf.render_wave(ref.scene_pytree, ref.frame_params(),
                           jnp.arange(24 * 18, dtype=jnp.int32),
                           jnp.int32(0), jcfg)
    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    r = Renderer(path, film_size=(24, 18), device="cpu")
    r.traversal = "twin"
    cfg = dataclasses.replace(r.wave_config(), alpha_rounds=1,
                              shadow_glass_rounds=1)
    kernels.reset_counters()
    out = wf.render_wave(r.scene, r.frame_params(), r.pixel_ids, 0, cfg)
    assert kernels.TWIN_CALLS["closest"] <= cfg.max_bounces * 4
    assert_close(out["radiance"].numpy(), np.asarray(jout["radiance"]))
