"""The demodulated wave of the port (trace/wavefront.py render_wave and
render_wave_merged with WaveConfig.decouple_albedo, the wave's
fixed_pixel_offset and active_mask parameters) against the JAX package's
wave, at 32x18.

- "shadertoy:cornell" on brute force in both packages and "shadertoy"
  (the JAX CPU default, its lock-step traversal, against the port's kernel
  path through the plain twins): radiance, radiance_d, filter weight and
  the AOV planes the RealTime chain reads.
- render_wave_merged with fold_aovs (3 samples): the folded radiance
  planes and the summed albedo, normal, emissive and diffuse_contrib.
- fixed_pixel_offset (a Halton offset) and active_mask (a checkerboard):
  the same planes; masked lanes return filter weight 0 and radiance 0.
- The identity that makes the two planes checkable, in the port alone and
  with russian roulette off (its decisions differ once the first albedo is
  taken as white): albedo * D + (I - D) + E * fw equals the plain wave's
  radiance per sample, to 1e-4 absolute.

Tolerance against JAX (tests/test_torch_renderer.py's): |d| <= 1e-3
(1 + |ref|) on >= 99% of lanes for every float plane (a float32
difference between XLA and PyTorch can flip a lane's russian roulette or
lobe choice, which moves that lane's radiance by its whole value);
>= 98% for diffuse_contrib, dm / (dm + fresnel * spec_w) with the albedo
taken as white: on the glossy black materials of "shadertoy" the GGX
weight spec_w at low roughness amplifies the rsqrt difference between XLA
and PyTorch to 0.5-25% on 6 of 576 lanes (measured), where the radiance
itself stays inside the bound; >= 95% for its sum over the 3 samples of
the merged wave, where a pixel is off if any of its samples is (13 of 576
measured).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.trace.wavefront import (
    render_wave,
    render_wave_batch,
    render_wave_merged,
)

torch.set_num_threads(2)

FILM = (32, 18)
N = FILM[0] * FILM[1]
PLANES = ("radiance", "radiance_d", "filter_weight", "albedo", "normal",
          "emissive", "world_pos", "neighbor_dist", "diffuse_contrib")
OFFSET = (0.3125, 0.7037037)     # halton23(5)


def _assert_close(got, ref, keys=PLANES, dc_share=0.98):
    for key in keys:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, key
        close = (np.abs(g - r) <= 1e-3 * (1 + np.abs(r))).reshape(len(g), -1)
        share = dc_share if key == "diffuse_contrib" else 0.99
        assert close.all(-1).mean() >= share, (key, close.all(-1).mean())


def _mask():
    ids = np.arange(N)
    return ((ids % FILM[0]) + (ids // FILM[0])) % 2 == 0


def _jax_wave(name, merged=False, offset=None, mask=None):
    import jax.numpy as jnp

    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.trace import wavefront as jwf

    ref = JaxRenderer(name, film_size=FILM)
    cfg = dataclasses.replace(ref.wave_config(), decouple_albedo=True)
    params = ref.frame_params(
        fixed_offset=None if offset is None else jnp.asarray(offset))
    if mask is not None:
        params["active_mask"] = jnp.asarray(mask)
    ids = jnp.arange(N, dtype=jnp.int32)
    if merged:
        out = jwf.render_wave_merged(ref.scene_pytree, params, ids,
                                     jnp.int32(2), 3, cfg, fold_aovs=True)
    else:
        out = jwf.render_wave(ref.scene_pytree, params, ids, jnp.int32(2),
                              cfg)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_wave(name, merged=False, offset=None, mask=None):
    r = Renderer(name, film_size=FILM, device="cpu")
    cfg = dataclasses.replace(r.wave_config(), decouple_albedo=True)
    params = r.frame_params(fixed_offset=offset)
    if mask is not None:
        params["active_mask"] = torch.from_numpy(mask)
    if merged:
        out = render_wave_merged(r.scene, params, r.pixel_ids, 2, 3, cfg,
                                 fold_aovs=True)
    else:
        out = render_wave(r.scene, params, r.pixel_ids, 2, cfg)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", ["shadertoy:cornell", "shadertoy"])
def test_decoupled_wave_matches_jax(name):
    ref, got = _jax_wave(name), _port_wave(name)
    _assert_close(got, ref)
    assert np.abs(got["radiance_d"]).sum() > 0
    # D is a share of I, channel by channel.
    assert (got["radiance_d"] <= got["radiance"] * (1 + 1e-5) + 1e-6).all()


@pytest.mark.parametrize("name", ["shadertoy:cornell", "shadertoy"])
def test_merged_fold_aovs_matches_jax(name):
    ref = _jax_wave(name, merged=True)
    got = _port_wave(name, merged=True)
    _assert_close(got, ref, dc_share=0.95)
    # Summed over 3 samples: a lit pixel's albedo sum exceeds one sample's.
    assert got["albedo"].max() > 1.5


@pytest.mark.parametrize("what", ["offset", "mask", "both"])
def test_offset_and_mask_match_jax(what):
    offset = OFFSET if what in ("offset", "both") else None
    mask = _mask() if what in ("mask", "both") else None
    ref = _jax_wave("shadertoy:cornell", offset=offset, mask=mask)
    got = _port_wave("shadertoy:cornell", offset=offset, mask=mask)
    _assert_close(got, ref)
    if mask is not None:
        assert (got["filter_weight"][~mask] == 0).all()
        assert (got["radiance"][~mask] == 0).all()
        assert (got["filter_weight"][mask] == 1).all()
        assert (got["albedo"][~mask] == 0).all()


def test_fixed_offset_replaces_the_jitter():
    """Every lane gets the same sub-pixel offset: two frames with the same
    offset and other sample indices see the same first hit."""
    r = Renderer("shadertoy:cornell", film_size=FILM, device="cpu")
    cfg = r.wave_config()
    params = r.frame_params(fixed_offset=OFFSET)
    a = render_wave(r.scene, params, r.pixel_ids, 0, cfg)
    b = render_wave(r.scene, params, r.pixel_ids, 7, cfg)
    assert torch.equal(a["world_pos"], b["world_pos"])
    free = render_wave(r.scene, r.frame_params(), r.pixel_ids, 7, cfg)
    assert not torch.equal(free["world_pos"], b["world_pos"])


@pytest.mark.parametrize("name", ["shadertoy:cornell", "shadertoy"])
def test_composite_identity(name):
    from tracerboy_tpu_torch.post.realtime import composite_albedo
    from tracerboy_tpu_torch.renderer import _demod_ratio

    r = Renderer(name, film_size=FILM, device="cpu")
    cfg = dataclasses.replace(r.wave_config(), use_russian_roulette=False)
    params = r.frame_params()
    plain = render_wave(r.scene, params, r.pixel_ids, 1, cfg)
    d = render_wave(r.scene, params, r.pixel_ids, 1,
                    dataclasses.replace(cfg, decouple_albedo=True))
    assert "radiance_d" not in plain
    fw = d["filter_weight"][:, None]
    comp = (d["albedo"] * d["radiance_d"]
            + (d["radiance"] - d["radiance_d"]) + d["emissive"] * fw)
    np.testing.assert_allclose(comp.numpy(), plain["radiance"].numpy(),
                               atol=1e-4)
    # The same through the ratio the RealTime chain carries.
    ratio = _demod_ratio(d["radiance_d"], d["radiance"])
    comp2 = composite_albedo(d["albedo"], ratio, d["radiance"],
                             d["emissive"] * fw)
    np.testing.assert_allclose(comp2.numpy(), plain["radiance"].numpy(),
                               atol=1e-4)
    assert float(plain["radiance"].mean()) > 0


def test_batch_sums_radiance_d():
    r = Renderer("shadertoy:cornell", film_size=(16, 12), device="cpu")
    cfg = dataclasses.replace(r.wave_config(), decouple_albedo=True)
    params = r.frame_params()
    batch = render_wave_batch(r.scene, params, r.pixel_ids, 0, 2, cfg)
    one = [render_wave(r.scene, params, r.pixel_ids, j, cfg)
           for j in range(2)]
    np.testing.assert_allclose(
        batch["radiance_d"].numpy(),
        (one[0]["radiance_d"] + one[1]["radiance_d"]).numpy(), atol=1e-6)
