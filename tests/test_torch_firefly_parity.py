"""The fireflies of utils/demo_scene.py's textured_lit.pbrt, held against
the JAX package: the three pixels where the CLI's radiance peaks at
1280x720 and 2 spp on the card ((271, 552), (271, 808), (598, 1064);
utils/radiance_peaks.py) and their 3x3 neighbourhoods, 27 pixels, traced
through both packages' render_wave_merged on the CPU with the CLI's
settings (each package's CLI builds them) and its two sample indices (0
and 1: app/cli.py's first render_sample(2) at spp 0).

Both sides take the BVH oracle (TB_TRAVERSAL=jnp: the JAX package's
jnp walk, the port's "wide" backend): the Pallas kernels would run in
interpret mode over 150,338 triangles, and the port's brute force loops
over them in Python. Most of the time here is the JAX wave's compile.

Outcome: the two packages agree, lane by lane, within float32 noise
amplified by the GGX lobe (relative 2e-3; measured 7.8e-4 at the
(598, 1064) firefly, whose sum is 26,158.88). So the fireflies are the
reference's, not a fault of the port (ROADMAP, faults of the reference).
Two of them lie 256 columns apart: make_blue_noise_params indexes the
blue noise by (py % 256, px % 256), so those pixels draw the same
blue-noise values, while the per-lane PCG streams still differ.
"""

import os

import numpy as np
import pytest
import torch

FILM = (1280, 720)
PEAKS = [(271, 552), (271, 808), (598, 1064)]
# The CLI's radiance at (271, 808), its largest channel, on an NVIDIA H100
# 80GB HBM3 (700.00 W), as utils/radiance_peaks.py's PNG run printed it
# (PERF.md section 6).
CARD_PEAK = 49810.52
REL = 2e-3


def _pixel_ids():
    return np.array([(y + dy) * FILM[0] + x + dx for y, x in PEAKS
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)], np.int64)


def _jax_cli_settings(scene):
    """The OutputSettings the JAX CLI builds for `scene --spp 2`: its
    Renderer is replaced by one that keeps them and stops."""
    import tracerboy_tpu
    from tracerboy_tpu.app import cli as jcli

    kept = {}

    class Stop(Exception):
        pass

    def keep(scene, settings=None, **kwargs):
        kept["settings"] = settings
        raise Stop

    real = tracerboy_tpu.Renderer
    tracerboy_tpu.Renderer = keep
    try:
        jcli.main([scene, "--size", "x".join(map(str, FILM)), "--spp", "2",
                   "--out", os.devnull])
    except Stop:
        pass
    finally:
        tracerboy_tpu.Renderer = real
    return kept["settings"]


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """(JAX outputs, port outputs) of the merged wave over the 27 pixels:
    per pixel the radiance summed over both samples and the filter
    weight."""
    import jax.numpy as jnp

    from tracerboy_tpu.renderer import Renderer as JaxRenderer
    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
    from tracerboy_tpu.trace import wavefront as jwf
    from tracerboy_tpu_torch.app import cli as tcli
    from tracerboy_tpu_torch.renderer import Renderer
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import wavefront as twf
    from tracerboy_tpu_torch.utils.demo_scene import write_textured_scene

    _, lit = write_textured_scene(str(tmp_path_factory.mktemp("tex")))
    old = os.environ.get("TB_TRAVERSAL")
    os.environ["TB_TRAVERSAL"] = "jnp"
    try:
        jr = JaxRenderer(jax_load_scene(lit, use_cache=False,
                                        film_size=FILM),
                         settings=_jax_cli_settings(lit), film_size=FILM)
        args = tcli.build_parser().parse_args(
            [lit, "--spp", "2", "--out", os.devnull])
        r = Renderer(load_scene(lit, use_cache=False, film_size=FILM),
                     settings=tcli._settings(args), film_size=FILM,
                     device="cpu")
    finally:
        if old is None:
            del os.environ["TB_TRAVERSAL"]
        else:
            os.environ["TB_TRAVERSAL"] = old
    jcfg, cfg = jr.wave_config(), r.wave_config()
    assert jcfg.traversal == "jnp" and cfg.traversal == "wide"
    assert jcfg.has_alpha and jcfg.has_normal_maps and jcfg.enable_nee
    ids = _pixel_ids()
    jp, tp = jr.frame_params(), r.frame_params()
    jids = jnp.asarray(ids.astype(np.int32))
    tids = torch.from_numpy(ids)
    jp["bn"] = jwf.make_blue_noise_params(jr.scene_pytree, jids, FILM[0])
    tp["bn"] = twf.make_blue_noise_params(r.scene, tids, FILM[0])
    jout = jwf.render_wave_merged(jr.scene_pytree, jp, jids, 0, 2, jcfg)
    tout = twf.render_wave_merged(r.scene, tp, tids, 0, 2, cfg)
    return ({k: np.asarray(jout[k]) for k in ("radiance", "filter_weight")},
            {k: tout[k].numpy() for k in ("radiance", "filter_weight")})


@pytest.mark.parametrize("peak", range(len(PEAKS)))
def test_firefly_lanes_match_jax(lanes, peak):
    """Each pixel of the neighbourhood, summed over the two samples,
    within 2e-3 of max(|JAX|, 1); the filter weights equal."""
    ref, got = lanes
    sl = slice(9 * peak, 9 * peak + 9)
    a, b = ref["radiance"][sl], got["radiance"][sl]
    assert np.isfinite(b).all()
    np.testing.assert_array_less(np.abs(b - a),
                                 REL * np.maximum(np.abs(a), 1.0))
    assert np.array_equal(ref["filter_weight"][sl],
                          got["filter_weight"][sl])


def test_fireflies_are_the_references(lanes):
    """In both packages the centre pixel of each neighbourhood is a
    firefly (a mean above 1,000) and its 8 neighbours are not (below 10):
    the same three pixels the card's CLI run found."""
    for out in lanes:
        mean = out["radiance"] / np.maximum(out["filter_weight"],
                                            1e-8)[:, None]
        peak = mean.max(-1).reshape(3, 9)
        assert (peak[:, 4] > 1000).all()
        assert (np.delete(peak, 4, axis=1) < 10).all()


def test_card_peak_is_reproduced(lanes):
    """The port's CPU lanes give the CLI's resolved radiance at
    (271, 808) (accumulated radiance over accumulated filter weight, the
    --hdr-out image radiance_peaks reads) within 1e-3 of the card's
    49,810.52."""
    _, got = lanes
    i = 9 + 4
    mean = got["radiance"][i] / max(float(got["filter_weight"][i]), 1e-8)
    assert abs(mean.max() - CARD_PEAK) <= 1e-3 * CARD_PEAK
