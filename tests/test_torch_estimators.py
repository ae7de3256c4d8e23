"""The estimators of the port's renderer against the JAX package's:
adaptive sampling in Unbiased mode (ADAPTIVE_MIN_SPP, active_pixel_mask,
the masked render_sample), the adaptive burst (render_sample_adaptive,
_waterfill, render_wave_merged(fold_var=True)), split planes
(WaveConfig.split_early), live material edits (set_material) and
current_image(tonemapped=).

Tolerances: _waterfill's counts and render_sample_adaptive's counts are
equal exactly (float64 numpy in both); the accumulators, the fold_var
moments (XLA's pow rounds unlike torch's in the last place) and the split
planes under tests/test_torch_volume.py's assert_close; active_pixel_mask
equal on the same accumulators; the split's saturation (split_early >=
max_bounces - 1) exact. The renders use estimator_pair
(tests/test_torch_volume.py): shadertoy:cornell with a seeded sky and a
cloud, brute force, the tent splat and split_early = 0, whose JAX wave
configuration the other files share.

The adaptive burst's residual wave on the card:
tests/test_torch_volume_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env_nee import PLANE_UNDER_SKY
from test_torch_volume import FILM, assert_close, estimator_pair
from tracerboy_tpu import Renderer as JaxRenderer
from tracerboy_tpu.trace.wavefront import render_wave_merged as jax_merged
from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

torch.set_num_threads(2)


# -- _waterfill ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["smooth", "spiky", "capped", "zero",
                                  "nan"])
def test_waterfill_counts_equal_jax(case):
    rng = np.random.default_rng(21)
    n, pilot, budget, cap = 3000, 2, 7001, 256
    t = rng.random(n) ** 2
    if case == "spiky":
        t[rng.choice(n, 20, replace=False)] *= 500.0
    elif case == "capped":
        t[:5] = 1e6
        cap = 9
    elif case == "zero":
        t[:] = 0.0
    elif case == "nan":
        t[::7] = np.nan
    want = JaxRenderer._waterfill(t, pilot, budget, cap)
    got = Renderer._waterfill(t, pilot, budget, cap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == budget and got.min() >= 0


# -- the merged wave's moments and split planes -----------------------------

@pytest.fixture(scope="module")
def pair():
    return estimator_pair(mis=True)


@pytest.fixture(scope="module")
def merged_outputs(pair):
    """The pilot's wave of render_sample_adaptive(4, pilot=2): a merged
    2-sample wave with fold_var, from each package."""
    ref, r = pair
    N = r.width * r.height
    want = jax_merged(ref.scene_pytree, ref.frame_params(),
                      jnp.arange(N, dtype=jnp.int32), jnp.int32(0), 2,
                      ref.wave_config(), fold_var=True)
    got = render_wave_merged(r.scene, r.frame_params(), r.pixel_ids, 0, 2,
                             r.wave_config(), fold_var=True)
    return want, got


def test_fold_var_moments_match_jax(merged_outputs):
    want, got = merged_outputs
    for key in ("lum", "lum_sq"):
        assert_close(got[key].numpy(), want[key])
    # Per-pixel sums of two samples' tonemapped luma in [0, 1].
    assert 0 <= got["lum"].min() and got["lum"].max() <= 2
    assert (got["lum_sq"] <= got["lum"] + 1e-6).all()


def test_split_planes_match_jax(merged_outputs):
    want, got = merged_outputs
    early = np.stack([np.asarray(want["radiance_early_" + c]) for c in "rgb"],
                     -1)
    assert_close(got["radiance_early"].numpy(), early)
    total = got["radiance"].numpy()
    got_e = got["radiance_early"].numpy()
    assert (got_e >= -1e-6).all() and (got_e <= total + 1e-5).all()
    assert 0 < got_e.sum() < total.sum()


@pytest.mark.parametrize("max_bounces", [2, 3])
def test_split_saturates_at_the_last_bounce(max_bounces):
    """split_early >= max_bounces - 1 puts every contribution in the early
    plane: early equals the total bit for bit (the clamp and NaN policy
    are the total's); split_early = -1 leaves the total untouched."""
    r = Renderer("shadertoy:cornell", film_size=(16, 16), device="cpu")
    base = dataclasses.replace(r.wave_config(), max_bounces=max_bounces)
    out = {s: render_wave_merged(r.scene, r.frame_params(), r.pixel_ids, 0,
                                 2, dataclasses.replace(base, split_early=s))
           for s in (-1, 0, max_bounces - 1, 99)}
    for s in (max_bounces - 1, 99):
        assert torch.equal(out[s]["radiance_early"], out[s]["radiance"])
        assert torch.equal(out[s]["radiance"], out[-1]["radiance"])
    assert "radiance_early" not in out[-1]
    e0 = out[0]["radiance_early"]
    assert 0 < e0.sum() < out[0]["radiance"].sum()


# -- the adaptive burst -------------------------------------------------------

@pytest.fixture(scope="module")
def adaptive_pair(pair):
    """pair after render_sample_adaptive(4, pilot=2) in each package."""
    ref, r = pair
    for x in (ref, r):
        x.invalidate_history()
        x.render_sample_adaptive(4, pilot=2)
    return ref, r


def test_render_sample_adaptive_matches_jax(adaptive_pair):
    """render_sample_adaptive(4, pilot=2): equal counts, close
    accumulators; and the port's burst twice gives bit-equal
    accumulators (its segment sum runs in a fixed order)."""
    ref, r = adaptive_pair
    np.testing.assert_array_equal(r._last_adaptive_counts,
                                  ref._last_adaptive_counts)
    N = FILM[0] * FILM[1]
    assert int(r._last_adaptive_counts.sum()) == 2 * N
    assert r.state.spp == ref.state.spp == 4
    assert_close(r.state.accum.numpy(), ref.state.accum)
    assert_close(r.state.accum_jittered.numpy(), ref.state.accum_jittered)
    again = Renderer(r.compiled, film_size=FILM, device="cpu")
    again.settings, again.wave_config = r.settings, r.wave_config
    again.render_sample_adaptive(4, pilot=2)
    assert torch.equal(again.state.accum, r.state.accum)
    assert torch.equal(again.state.accum_jittered, r.state.accum_jittered)


def test_current_image_tonemapped_false_matches_jax(adaptive_pair):
    """current_image(tonemapped=False) takes the JAX signature; as there,
    the settings' post chain decides the image."""
    ref, r = adaptive_pair
    want = np.asarray(ref.current_image(tonemapped=False))
    got = r.current_image(tonemapped=False)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(got, r.current_image())


# -- adaptive sampling --------------------------------------------------------

def _adaptive(r):
    r.settings = r.settings.replace(performance_settings=dataclasses.replace(
        r.settings.performance_settings, enable_adaptive_sampling=True))
    return r


def test_active_pixel_mask_matches_jax():
    """The mask of the same accumulators in both packages, None before
    ADAPTIVE_MIN_SPP samples or with adaptive sampling off."""
    rng = np.random.default_rng(31)
    ref = _adaptive(JaxRenderer("shadertoy:cornell", film_size=FILM))
    r = _adaptive(Renderer("shadertoy:cornell", film_size=FILM, device="cpu"))
    assert r.ADAPTIVE_MIN_SPP == ref.ADAPTIVE_MIN_SPP == 64
    assert r.active_pixel_mask() is None and ref.active_pixel_mask() is None
    acc = rng.uniform(0, 2, (FILM[1], FILM[0], 4)).astype(np.float32)
    jit = acc * rng.uniform(0.99, 1.01, acc.shape).astype(np.float32)
    acc[..., 3], jit[..., 3] = 64.0, 32.0
    jit[:3, :3] = acc[:3, :3] / 2.0            # converged pixels
    for x in (ref, r):
        x.state.spp = 64
    ref.state.accum, ref.state.accum_jittered = (jnp.asarray(acc),
                                                 jnp.asarray(jit))
    r.state.accum, r.state.accum_jittered = (torch.from_numpy(acc),
                                             torch.from_numpy(jit))
    want = np.asarray(ref.active_pixel_mask())
    got = r.active_pixel_mask().numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    r.settings = r.settings.replace(performance_settings=dataclasses.replace(
        r.settings.performance_settings, enable_adaptive_sampling=False))
    assert r.active_pixel_mask() is None


def test_masked_pixels_gain_no_weight():
    """render_sample under the mask: pixels outside it trace nothing (no
    filter weight, no radiance), the live ones gain weight, and the mask
    is what current_image's live-pixel view reads."""
    r = _adaptive(Renderer("shadertoy:cornell", film_size=(12, 8),
                           device="cpu"))
    for _ in range(3):
        r.render_sample(1)
    assert r.active_pixel_mask() is None
    r.state.spp = r.ADAPTIVE_MIN_SPP     # as if warmed up
    mask = r.active_pixel_mask()
    assert mask is not None and mask.any() and not mask.all()
    before = r.state.accum.clone()
    r.render_sample(2)
    gained = (r.state.accum - before).reshape(-1, 4)
    assert torch.equal(r._live_pixels, mask)
    assert not gained[~mask].any()
    assert (gained[mask, 3] > 0).all()


# -- live material edits and the image ----------------------------------------

def test_set_material_matches_jax(pair):
    """An albedo edit of one cornell wall in both packages, then the
    merged 2-sample wave of each: close radiance, and the edit restarts
    accumulation. A flags edit refreshes tri_shadow_opaque as the JAX
    renderer does."""
    ref, r = pair
    N = r.width * r.height
    mid = int(r.compiled.tri_material[0])
    for x in (ref, r):
        x.render_sample_adaptive(2, pilot=2)
        x.set_material(mid, albedo=[0.9, 0.1, 0.1])
        assert x.state.spp == 0
    np.testing.assert_array_equal(r.get_material(mid)["albedo"],
                                  np.asarray(ref.get_material(mid)["albedo"]))
    assert torch.equal(r.scene["materials"]["albedo"][mid],
                       torch.tensor([0.9, 0.1, 0.1]))
    want = jax_merged(ref.scene_pytree, ref.frame_params(),
                      jnp.arange(N, dtype=jnp.int32), jnp.int32(0), 2,
                      ref.wave_config(), fold_var=True)
    got = render_wave_merged(r.scene, r.frame_params(), r.pixel_ids, 0, 2,
                             r.wave_config(), fold_var=True)
    assert_close(got["radiance"].numpy(), want["radiance"])
    flags = int(r.compiled.materials["flags"][mid]) | 0x10
    for x in (ref, r):
        x.set_material(mid, flags=flags)
    np.testing.assert_array_equal(
        r.scene["tri_shadow_opaque"].numpy(),
        np.asarray(ref.scene_pytree["tri_shadow_opaque"]))
    assert int(r.scene["materials"]["flags"][mid]) == flags


def test_material_edit_roundtrip(tmp_path):
    """tests/test_integrator.py's edit round trip in the port: the plane
    under a white sky reads back the new albedo."""
    import textwrap

    path = tmp_path / "plane.pbrt"
    path.write_text(textwrap.dedent(PLANE_UNDER_SKY))
    r = Renderer(str(path), device="cpu")
    r.render_sample(1)
    mid = r.select_pixel(16, 16)["material_id"]
    r.set_material(mid, albedo=[0.9, 0.1, 0.1])
    assert r.state.spp == 0
    r.render_sample(4)
    img = r.resolve_radiance().numpy()
    np.testing.assert_allclose(img[8:24, 8:24].mean(axis=(0, 1)),
                               [0.9, 0.1, 0.1], atol=0.01)
