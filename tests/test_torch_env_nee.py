"""Environment NEE of the port (trace/wavefront.py, WaveConfig.env_nee and
env_nee_samples) against the JAX package's, on the two scenes of
tests/test_env_nee.py at 16x16: a Lambertian plane under a white sky,
and the same with a blocker above it (its env-NEE shadow rays are
occluded in the blocker's footprint).

The JAX renderer runs brute force (its CPU default on the plane scenes);
the port runs brute force, and the kernel path (TB_TRAVERSAL=pallas: on
the CPU the traversal kernels' plain versions, packed ids), whose
render_sample(2) is one merged wave of 2 x 256 lanes. Tolerances,
tests/test_torch_renderer.py's: accum |d| <= 1e-3 (1 + |ref|) on >= 99%
of pixels and its mean to 1e-4 relative, after render_sample(1) and after
render_sample(2), at M = 1 and M = 3 env-NEE samples.

The furnace check runs on the port alone: under a unit sky a Lambertian
plane reads back its albedo exactly per sample, whatever M (NEE adds
a * w, the MIS-weighted escape a * (1 - w)).
"""

import dataclasses
import textwrap

import numpy as np
import pytest
import torch

from tracerboy_tpu import Renderer as JaxRenderer
from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.trace import kernels
from tracerboy_tpu_torch.trace.wavefront import WaveConfig, render_wave

torch.set_num_threads(2)

FILM = (16, 16)

PLANE_UNDER_SKY = """
    LookAt 0 5 0  0 0 0  0 0 1
    Camera "perspective" "float fov" [ 30 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 32 ]
    Integrator "path" "integer maxdepth" [ 4 ]
    WorldBegin
    LightSource "infinite" "rgb L" [ 1 1 1 ]
    Material "matte" "rgb Kd" [ 0.3 0.5 0.7 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -50 0 -50  50 0 -50  50 0 50  -50 0 50 ]
    WorldEnd
"""

PLANE_WITH_BLOCKER = """
    LookAt 0 5 0  0 0 0  0 0 1
    Camera "perspective" "float fov" [ 30 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 32 ]
    Integrator "path" "integer maxdepth" [ 4 ]
    WorldBegin
    LightSource "infinite" "rgb L" [ 1 1 1 ]
    Material "matte" "rgb Kd" [ 0.3 0.5 0.7 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -50 0 -50  50 0 -50  50 0 50  -50 0 50 ]
    Material "matte" "rgb Kd" [ 0.1 0.1 0.1 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -0.4 1 -0.4  0.4 1 -0.4  0.4 1 0.4  -0.4 1 0.4 ]
    WorldEnd
"""

# Glossy materials under a non-uniform map: the metal and plastic
# branches of the env-NEE BSDF (the GGX pdf in the balance denominator,
# Fresnel, the plastic's diffuse and specular terms) and the quad lookup
# of a written .hdr map, rotated by the light's transform.
GLOSSY_UNDER_MAP = """
    LookAt 0 3 6  0 0.6 0  0 1 0
    Camera "perspective" "float fov" [ 45 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 32 ]
    Integrator "path" "integer maxdepth" [ 4 ]
    WorldBegin
    AttributeBegin
      Rotate -90 1 0 0
      LightSource "infinite" "string mapname" [ "sky.hdr" ]
        "rgb L" [ 1 1 1 ]
    AttributeEnd
    Material "matte" "rgb Kd" [ 0.5 0.45 0.4 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -20 0 -20  -20 0 20  20 0 20  20 0 -20 ]
    AttributeBegin
      Translate -1.1 1 0
      Material "metal" "float roughness" [ 0.2 ]
      Shape "sphere" "float radius" [ 1 ]
    AttributeEnd
    AttributeBegin
      Translate 1.1 1 0
      Material "plastic" "rgb Kd" [ 0.2 0.4 0.6 ] "rgb Ks" [ 0.5 0.5 0.5 ]
        "float roughness" [ 0.1 ]
      Shape "sphere" "float radius" [ 1 ]
    AttributeEnd
    WorldEnd
"""

SCENES = {"under_sky": PLANE_UNDER_SKY, "with_blocker": PLANE_WITH_BLOCKER,
          "glossy_under_map": GLOSSY_UNDER_MAP}


def write_scene(tmp_path, body):
    """The scene file, and beside it sky.hdr: a 32x16 map, seeded, with a
    bright spot (only GLOSSY_UNDER_MAP reads it)."""
    from tracerboy_tpu_torch.core.image_io import write_hdr

    rng = np.random.default_rng(11)
    sky = 0.2 + rng.random((16, 32, 3)).astype(np.float32)
    sky[3:5, 20:23] = 30.0
    write_hdr(str(tmp_path / "sky.hdr"), sky)
    p = tmp_path / "scene.pbrt"
    p.write_text(textwrap.dedent(body))
    return str(p)


def with_samples(r, M, mode="auto"):
    r.settings = r.settings.replace(
        performance_settings=dataclasses.replace(
            r.settings.performance_settings, environment_nee=mode,
            environment_nee_samples=M))
    return r


def assert_close(acc, ref):
    close = (np.abs(acc - ref) <= 1e-3 * (1 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("scene", list(SCENES))
def test_env_nee_matches_jax(tmp_path, monkeypatch, scene, M):
    path = write_scene(tmp_path, SCENES[scene])
    # Brute force in both packages (the glossy scene's 2050 triangles are
    # over the default's 2048).
    monkeypatch.setenv("TB_TRAVERSAL", "brute")
    ref = with_samples(JaxRenderer(path, film_size=FILM), M)
    assert ref.wave_config().env_nee
    ref.render_sample(1)
    ref_acc1 = np.asarray(ref.state.accum)
    ref.render_sample(2)
    ref_acc2 = np.asarray(ref.state.accum)

    ports = {"brute": with_samples(Renderer(path, film_size=FILM,
                                            device="cpu"), M)}
    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    ports["kernel"] = with_samples(Renderer(path, film_size=FILM,
                                            device="cpu"), M)
    for backend, r in ports.items():
        assert r.traversal == backend
        cfg = r.wave_config()
        assert cfg.env_nee and cfg.env_nee_samples == M and cfg.has_env
        r.render_sample(1)
        assert_close(r.state.accum.numpy(), ref_acc1)
        kernels.reset_counters()
        r.render_sample(2)
        assert r.state.spp == ref.state.spp == 3
        acc = r.state.accum.numpy()
        assert np.isfinite(acc).all() and acc[..., :3].mean() > 0
        assert_close(acc, ref_acc2)
        if backend == "kernel":
            # One merged wave; each bounce traces its M env directions
            # as ONE shadow wave.
            assert 1 <= kernels.TWIN_CALLS["anyhit"] <= cfg.max_bounces


@pytest.mark.parametrize("M", [1, 3, 8])
def test_uniform_sky_reads_back_the_albedo_exactly(tmp_path, M):
    path = write_scene(tmp_path, PLANE_UNDER_SKY)
    r = with_samples(Renderer(path, film_size=FILM, device="cpu"), M, "on")
    r.render_sample(2)
    img = r.resolve_radiance().numpy()
    np.testing.assert_allclose(img, np.broadcast_to([0.3, 0.5, 0.7],
                                                    img.shape), atol=1e-5)


def test_env_nee_counts_its_shadow_rays(tmp_path):
    """rays_traced counts each env-NEE direction traced: more rays with
    M = 3 than with M = 1 on the same samples, and none without env NEE's
    shadow rays when it is off."""
    path = write_scene(tmp_path, PLANE_WITH_BLOCKER)
    counts = {}
    for M, mode in ((1, "on"), (3, "on"), (1, "off")):
        r = with_samples(Renderer(path, film_size=FILM, device="cpu"), M,
                         mode)
        r.render_sample(1)
        counts[(M, mode)] = r.rays_traced
    assert counts[(1, "off")] < counts[(1, "on")] < counts[(3, "on")]
    # The plane's 256 primary hits each add M env rays at bounce 0.
    assert counts[(3, "on")] - counts[(1, "on")] >= 2 * 256 - 16


@pytest.mark.parametrize("samples", [0, 9])
def test_env_nee_samples_out_of_range_raise(tmp_path, samples):
    path = write_scene(tmp_path, PLANE_UNDER_SKY)
    r = Renderer(path, film_size=FILM, device="cpu")
    cfg = dataclasses.replace(r.wave_config(), env_nee=True,
                              env_nee_samples=samples)
    assert isinstance(cfg, WaveConfig)
    with pytest.raises(ValueError, match="env_nee_samples"):
        render_wave(r.scene, r.frame_params(), r.pixel_ids, 0, cfg)


def test_wave_config_clamps_samples_like_jax(tmp_path):
    path = write_scene(tmp_path, PLANE_UNDER_SKY)
    r = Renderer(path, film_size=FILM, device="cpu")
    for asked, got in ((0, 1), (4, 4), (20, 8)):
        assert with_samples(r, asked).wave_config().env_nee_samples == got


def test_row_layout_environment_lookup_matches_jax():
    """shade/env.py sample_environment ((N, 3) rows against the (H, W, 3)
    map) on seeded directions, a seeded map, transform and colour scale:
    within 1e-5 (1 + |ref|) of the JAX lookup, and of the port's V3
    lookup over the flat planes (the same taps, summed in another
    order)."""
    import jax.numpy as jnp

    from tracerboy_tpu.shade.env import sample_environment as jax_lookup
    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.shade.env import (
        sample_environment,
        sample_environment_soa,
    )

    rng = np.random.default_rng(7)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    env = rng.random((9, 14, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = q.astype(np.float32)
    scale = np.array([1.5, 0.7, 2.0], np.float32)
    ref = np.asarray(jax_lookup(jnp.asarray(d), jnp.asarray(env),
                                jnp.asarray(m), jnp.asarray(scale)))
    got = sample_environment(torch.from_numpy(d), torch.from_numpy(env),
                             torch.from_numpy(m), torch.from_numpy(scale))
    assert got.shape == (4096, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    flat = torch.from_numpy(env.reshape(-1, 3))
    soa = sample_environment_soa(
        v3.V3(*torch.from_numpy(d).T), flat[:, 0], flat[:, 1], flat[:, 2],
        9, 14, torch.from_numpy(m), torch.from_numpy(scale))
    np.testing.assert_allclose(v3.to_rows(soa).numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M", [1, 3])
def test_decoupled_env_nee_wave_matches_jax(tmp_path, monkeypatch, M):
    """One wave with decouple_albedo on the glossy scene (brute force in
    both packages): radiance and radiance_d, whose env-NEE share at the
    first vertex is weighted by the env direction's own diffuse fraction,
    against the JAX wave; tests/test_torch_demod.py's tolerance, |d| <=
    1e-3 (1 + |ref|) on >= 99% of lanes."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import wavefront as jwf

    path = write_scene(tmp_path, GLOSSY_UNDER_MAP)
    monkeypatch.setenv("TB_TRAVERSAL", "brute")
    ref = with_samples(JaxRenderer(path, film_size=FILM), M)
    cfg = dataclasses.replace(ref.wave_config(), decouple_albedo=True)
    assert cfg.env_nee and cfg.env_nee_samples == M
    n = FILM[0] * FILM[1]
    want = jwf.render_wave(ref.scene_pytree, ref.frame_params(),
                           jnp.arange(n, dtype=jnp.int32), jnp.int32(2), cfg)
    r = with_samples(Renderer(path, film_size=FILM, device="cpu"), M)
    cfg = dataclasses.replace(r.wave_config(), decouple_albedo=True)
    got = render_wave(r.scene, r.frame_params(), r.pixel_ids, 2, cfg)
    for key in ("radiance", "radiance_d", "filter_weight"):
        g, w = got[key].numpy(), np.asarray(want[key])
        close = (np.abs(g - w) <= 1e-3 * (1 + np.abs(w))).reshape(n, -1)
        assert close.all(-1).mean() >= 0.99, (key, close.all(-1).mean())
    rad_d = got["radiance_d"].numpy()
    # Glossy lanes keep part of their radiance out of D.
    assert 0 < rad_d.sum() < got["radiance"].numpy().sum()
