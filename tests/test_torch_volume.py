"""Heterogeneous volumes in the port (shade/volumetric.py, the volume leaves
of scene/compile.py, the wave's volume paths) against the JAX package, on
the same seeded numpy inputs.

- Each volumetric function on seeded rays through procedural_cloud(16):
  ray_box_overlap, the nearest and trilinear density taps and
  transmittance to 1e-6 relative (+1e-7), hg_pdf and sample_hg to 2e-6
  (XLA's pow rounds unlike torch's in the last place), delta_track with
  a fixed rng2 table: the real/null decisions that flip are counted and
  reported, at most 1 in 1000 rays may scatter on one side only, and
  where both agree t_scatter and the weights match to 1e-5.
- The compiled leaves vol_oct, vol_majorant, vol_dims, tri_area and
  pk_tri_area bit for bit; the .npz cache's vol.* keys read by both
  packages; from_jax_pytree of the JAX leaves.
- A procedural_cloud(16) render on shadertoy:cornell at 16x12 under a
  seeded sky with environment NEE on, two bounces, volume_light_mis on
  and off, against the JAX renderer: accum |d| <= 1e-3 (1 + |ref|) on >=
  99% of the values and the mean to 1e-4 relative. Both renderers also
  run the tent splat and split_early = 0 (estimator_pair), so that these
  files compile three JAX wave configurations in all (this file's two
  and the residual wave of tests/test_torch_estimators.py).
- A PBRT MakeNamedMedium "heterogeneous" scene end to end in the port.

The new launch kinds on the card: tests/test_torch_volume_cuda.py.
"""

import dataclasses
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracerboy_tpu import Renderer as JaxRenderer
from tracerboy_tpu.core.vec3 import V3 as JaxV3
from tracerboy_tpu.scene import compile as jax_compile
from tracerboy_tpu.scene.volume import procedural_cloud as jax_cloud
from tracerboy_tpu.shade import volumetric as jax_vol
from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.core.vec3 import V3
from tracerboy_tpu_torch.scene import compile as port_compile
from tracerboy_tpu_torch.scene.volume import procedural_cloud
from tracerboy_tpu_torch.shade import volumetric

torch.set_num_threads(2)

FILM = (16, 12)
SPLIT_EARLY = 0


def sky():
    """A seeded 16x8 sky, so that cornell has an environment to NEE."""
    rng = np.random.default_rng(3)
    return (0.2 + rng.random((8, 16, 3))).astype(np.float32)


def cornell_with_sky(load_scene):
    cs = load_scene("shadertoy:cornell", film_size=FILM)
    return dataclasses.replace(cs, has_env=True, env_map=sky())


def _with_estimators(r, cls, mis):
    """Two bounces, environment NEE on, the tent splat, phase/light MIS on
    or off; the wave config also splits at SPLIT_EARLY (no setting does:
    the JAX package's bench sets it by hand)."""
    perf = dataclasses.replace(r.settings.performance_settings,
                               max_bounces=2, volume_light_mis=mis,
                               environment_nee="on")
    cam = dataclasses.replace(r.settings.camera_settings, filter_splat=True)
    r.settings = dataclasses.replace(r.settings, performance_settings=perf,
                                     camera_settings=cam)
    cfg = dataclasses.replace(cls.wave_config(r), split_early=SPLIT_EARLY)
    r.wave_config = lambda: cfg
    return r


def estimator_pair(mis=True):
    """(JAX renderer, port renderer on the CPU) of shadertoy:cornell with
    the seeded sky and procedural_cloud(16), brute force in both."""
    ref = JaxRenderer(cornell_with_sky(jax_compile.load_scene),
                      film_size=FILM, volume=jax_cloud(16))
    r = Renderer(cornell_with_sky(port_compile.load_scene), film_size=FILM,
                 volume=procedural_cloud(16), device="cpu")
    assert ref.traversal == r.traversal == "brute"
    return _with_estimators(ref, JaxRenderer, mis), _with_estimators(
        r, Renderer, mis)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    close = np.abs(got - want) <= 1e-3 * (1 + np.abs(want))
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * max(abs(want.mean()),
                                                       1e-12)


# -- the volumetric functions ----------------------------------------------

@pytest.fixture(scope="module")
def vol_scenes():
    """The volume leaves of cornell + procedural_cloud(16), g = 0.4, for
    both packages (numpy from the port's compile, which the next test
    holds bit-equal to the JAX one)."""
    vol = procedural_cloud(16)
    cs = dataclasses.replace(
        port_compile.load_scene("shadertoy:cornell", film_size=FILM),
        vol_density=vol.density, vol_lo=vol.lo, vol_hi=vol.hi,
        vol_sigma_a=vol.sigma_a, vol_sigma_s=vol.sigma_s, vol_g=0.4)
    leaves = cs.volume_tables()
    return ({k: jnp.asarray(v) for k, v in leaves.items()},
            port_compile.from_jax_pytree(leaves, "cpu"))


def seeded_rays(n=4096, seed=5):
    """Origins around the cloud's box, directions into it, some parallel
    to an axis (the slab test's guarded division)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = tgt - o
    d[: n // 16, 1:] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def both_v3(a):
    return (JaxV3(*(jnp.asarray(a[:, i]) for i in range(3))),
            V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))))


@pytest.fixture
def one_thread():
    """The port's ops on one thread for the duration of a test. torch's
    first parallel SLEEF call in a process (sin, exp, log over more than
    2,048 elements, split across threads) can compute the worker
    thread's share to ~1e-4 (ROADMAP Queue 3); these tests hold the port
    to 1e-6."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_box_overlap_and_density_match_jax(vol_scenes, one_thread):
    js, ps = vol_scenes
    o, d = seeded_rays()
    (jo, po), (jd, pd) = both_v3(o), both_v3(d)
    t0j, t1j = jax_vol.ray_box_overlap(jo, jd, js["vol_lo"], js["vol_hi"])
    t0p, t1p = volumetric.ray_box_overlap(po, pd, ps["vol_lo"],
                                          ps["vol_hi"])
    close(t0p, t0j, 1e-6, 1e-7)
    close(t1p, t1j, 1e-6, 1e-7)
    pts = np.random.default_rng(6).uniform(-1.2, 1.2, (8192, 3)).astype(
        np.float32)
    jp, pp = both_v3(pts)
    for jf, pf in ((jax_vol.sample_density, volumetric.sample_density),
                   (jax_vol.sample_density_trilinear,
                    volumetric.sample_density_trilinear),
                   (jax_vol.density_at, volumetric.density_at)):
        close(pf(ps, *pp), jf(js, *jp), 1e-6, 1e-7)
    # Without the stencil table, density_at is the nearest tap.
    no_oct = {k: v for k, v in ps.items() if k != "vol_oct"}
    assert torch.equal(volumetric.density_at(no_oct, *pp),
                       volumetric.sample_density(ps, *pp))


@pytest.mark.parametrize("g", [0.0, 0.4, -0.6])
def test_phase_functions_match_jax(g, one_thread):
    rng = np.random.default_rng(8)
    n = 4096
    cos_t = rng.uniform(-1, 1, n).astype(np.float32)
    close(volumetric.hg_pdf(torch.from_numpy(cos_t), torch.tensor(g)),
          jax_vol.hg_pdf(jnp.asarray(cos_t), jnp.float32(g)), 2e-6, 1e-7)
    _, d = seeded_rays(n, seed=9)
    jd, pd = both_v3(d)
    u1, u2 = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    want = jax_vol.sample_hg(jd, jnp.float32(g), jnp.asarray(u1),
                             jnp.asarray(u2))
    got = volumetric.sample_hg(pd, torch.tensor(g), torch.from_numpy(u1),
                               torch.from_numpy(u2))
    for a, b in zip(got, want):
        close(a, b, 2e-6, 2e-6)


def test_transmittance_matches_jax(vol_scenes, one_thread):
    js, ps = vol_scenes
    o, d = seeded_rays(seed=10)
    (jo, po), (jd, pd) = both_v3(o), both_v3(d)
    rng = np.random.default_rng(11)
    t_max = rng.uniform(0.0, 6.0, o.shape[0]).astype(np.float32)
    active = rng.random(o.shape[0]) < 0.8
    jit = rng.random(o.shape[0], dtype=np.float32)
    want = jax_vol.transmittance(js, jo, jd, jnp.asarray(t_max),
                                 jnp.asarray(active), jnp.asarray(jit), 8)
    got = volumetric.transmittance(ps, po, pd, torch.from_numpy(t_max),
                                   torch.from_numpy(active),
                                   torch.from_numpy(jit), 8)
    for a, b in zip(got, want):
        close(a, b, 1e-6, 1e-7)


def test_delta_track_matches_jax(vol_scenes, record_property, one_thread):
    """A fixed rng2 table (steps, N, 2) in both walks. The walks run the
    same expressions; the decisions that flip (one side scatters, the
    other not) come from log/exp rounding and are counted."""
    js, ps = vol_scenes
    n, steps = 4096, 64
    o, d = seeded_rays(n, seed=12)
    (jo, po), (jd, pd) = both_v3(o), both_v3(d)
    rng = np.random.default_rng(13)
    table = rng.random((steps, 2, n), dtype=np.float32)
    t_lim = rng.uniform(1.0, 8.0, n).astype(np.float32)
    t_lim[: n // 8] = 1e30
    active = rng.random(n) < 0.9
    j_sc, j_t, j_w = jax_vol.delta_track(
        js, jo, jd, jnp.asarray(t_lim), jnp.asarray(active),
        lambda k: (jnp.asarray(table)[k, 0], jnp.asarray(table)[k, 1]),
        steps)
    calls = []

    def rng2(k):
        calls.append(k)
        return (torch.from_numpy(table[k, 0]), torch.from_numpy(table[k, 1]))

    p_sc, p_t, p_w = volumetric.delta_track(
        ps, po, pd, torch.from_numpy(t_lim), torch.from_numpy(active), rng2,
        steps)
    # The walk draws steps 0, 1, ... in order, as the JAX loop does, and
    # stops before the cap once no lane is mid-volume.
    assert calls == list(range(len(calls))) and 0 < len(calls) < steps
    j_sc = np.asarray(j_sc)
    flips = int((j_sc != p_sc.numpy()).sum())
    record_property("delta_track_flips", flips)
    record_property("delta_track_scattered", int(j_sc.sum()))
    print(f"delta_track: {flips} flipped decisions in {n} rays "
          f"({int(j_sc.sum())} scattered)")
    assert j_sc.sum() > n // 10 and flips <= n // 1000
    agree = j_sc == p_sc.numpy()
    close(p_t.numpy()[agree], np.asarray(j_t)[agree], 1e-5, 1e-6)
    for a, b in zip(p_w, j_w):
        close(a.numpy()[agree], np.asarray(b)[agree], 1e-5, 1e-6)


# -- the compiled leaves and the cache ----------------------------------------

@pytest.fixture(scope="module")
def compiled_pair():
    """cornell + procedural_cloud(16), g = 0.3, compiled by each package."""
    out = []
    for load, cloud in ((jax_compile.load_scene, jax_cloud),
                        (port_compile.load_scene, procedural_cloud)):
        vol = cloud(16)
        out.append(dataclasses.replace(
            load("shadertoy:cornell", film_size=FILM),
            vol_density=vol.density, vol_lo=vol.lo, vol_hi=vol.hi,
            vol_sigma_a=vol.sigma_a, vol_sigma_s=vol.sigma_s, vol_g=0.3))
    return out


VOLUME_KEYS = ("vol_density", "vol_oct", "vol_dims", "vol_lo", "vol_hi",
               "vol_sigma_a", "vol_sigma_s", "vol_g", "vol_majorant",
               "tri_area", "pk_tri_area")


def test_volume_leaves_match_jax(compiled_pair):
    ref, cs = compiled_pair
    assert ref.has_volume and cs.has_volume
    want = ref.as_pytree(pack_pallas=True)
    got = cs.as_numpy()
    for key in VOLUME_KEYS:
        a, b = np.asarray(want[key]), got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)
    assert got["vol_oct"].shape == (16 ** 3, 8)
    # A scene without a volume carries none of these leaves.
    plain = port_compile.load_scene("shadertoy:cornell", film_size=FILM)
    assert not plain.has_volume
    assert not set(VOLUME_KEYS) & set(plain.as_numpy())


def test_from_jax_pytree_carries_volume(compiled_pair):
    ref, cs = compiled_pair
    pytree = {k: np.asarray(v) for k, v in
              ref.as_pytree(pack_pallas=True).items()
              if k in VOLUME_KEYS}
    got = port_compile.from_jax_pytree(pytree, "cpu")
    want = cs.as_tensors("cpu")
    for key in VOLUME_KEYS:
        assert torch.equal(got[key], want[key]), key


def test_volume_cache_read_by_both_packages(compiled_pair, tmp_path):
    """The vol.* keys of the .npz cache: the port's file read by both
    packages, the JAX package's read by the port."""
    ref, cs = compiled_pair
    port_path, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    port_compile.save_compiled(port_path, cs)
    jax_compile.save_compiled(jax_path, ref)
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in (k for k in a.files if k.startswith("vol.")):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for path in (port_path, jax_path):
        back = port_compile.load_compiled(path)
        other = jax_compile.load_compiled(path)
        assert back.has_volume and other.has_volume
        assert back.vol_g == other.vol_g == pytest.approx(0.3)
        for f in ("density", "lo", "hi", "sigma_a", "sigma_s"):
            np.testing.assert_array_equal(getattr(back, "vol_" + f),
                                          getattr(other, "vol_" + f))
        np.testing.assert_array_equal(back.as_numpy()["vol_oct"],
                                      cs.as_numpy()["vol_oct"])


# -- renders ------------------------------------------------------------------

@pytest.mark.parametrize("mis", [True, False], ids=["mis", "nee_only"])
def test_volume_render_matches_jax(mis):
    ref, r = estimator_pair(mis)
    cfg = r.wave_config()
    assert cfg.has_volume and cfg.env_nee and cfg.num_lights > 0
    assert cfg.volume_light_mis == mis and cfg.filter_splat
    ref.render_sample(1)
    r.render_sample(1)
    assert_close(r.state.accum.numpy(), ref.state.accum)
    assert_close(r.state.accum_jittered.numpy(), ref.state.accum_jittered)
    assert r.state.accum[..., :3].sum() > 0


MEDIUM_SCENE = """
    LookAt 0 1 -6  0 1 0  0 1 0
    Camera "perspective" "float fov" [ 40 ]
    Film "image" "integer xresolution" [ 24 ] "integer yresolution" [ 16 ]
    Integrator "path" "integer maxdepth" [ 3 ]
    WorldBegin
    MakeNamedMedium "smoke" "string type" "heterogeneous"
      "integer nx" [ 2 ] "integer ny" [ 2 ] "integer nz" [ 2 ]
      "point p0" [ -1 0 -1 ] "point p1" [ 1 2 1 ]
      "float density" [ 0.5 1 1.5 2 2.5 3 3.5 4 ]
      "rgb sigma_a" [ 0.1 0.2 0.3 ] "rgb sigma_s" [ 1 1 1 ]
      "float g" [ 0.3 ]
    AttributeBegin
      AreaLightSource "diffuse" "rgb L" [ 6 6 6 ]
      Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
        "point P" [ -1 3 -1  1 3 -1  1 3 1  -1 3 1 ]
    AttributeEnd
    Material "matte" "rgb Kd" [ 0.6 0.6 0.6 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -5 0 -5  5 0 -5  5 0 5  -5 0 5 ]
    WorldEnd
"""


def test_pbrt_heterogeneous_medium_end_to_end(tmp_path):
    """MakeNamedMedium "heterogeneous" through load_scene (it was turned
    away by the compiler before volumes were ported): the compiled grid
    and coefficients equal the JAX package's, the .tbcache.npz keeps
    them, and the render is finite and changed by the medium (the
    light's scatter in it against the clear render)."""
    path = tmp_path / "medium.pbrt"
    path.write_text(textwrap.dedent(MEDIUM_SCENE))
    cs = port_compile.load_scene(str(path))
    ref = jax_compile.load_scene(str(path), use_cache=False)
    assert cs.has_volume and ref.has_volume
    for f in ("density", "lo", "hi", "sigma_a", "sigma_s"):
        np.testing.assert_array_equal(getattr(cs, "vol_" + f),
                                      getattr(ref, "vol_" + f))
    assert cs.vol_g == pytest.approx(0.3)
    cached = port_compile.load_scene(str(path))      # from the cache
    np.testing.assert_array_equal(cached.vol_density, cs.vol_density)
    r = Renderer(cs, device="cpu")
    assert r.wave_config().has_volume
    r.render_sample(2)
    img = r.current_image()
    assert np.isfinite(img).all() and 0 <= img.min() and img.max() <= 1
    clear = Renderer(dataclasses.replace(cs, vol_density=None),
                     device="cpu")
    assert not clear.wave_config().has_volume
    clear.render_sample(2)
    lit = r.resolve_radiance().mean().item()
    base = clear.resolve_radiance().mean().item()
    assert lit > 0 and abs(lit - base) > 0.01 * base
