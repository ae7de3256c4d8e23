"""RealTime mode of the port (post/realtime.py and the Renderer's
render_realtime_frame, render_realtime_frame_fused, trace_decoupled,
render_denoised) against the JAX package.

- composite_albedo (scalar and per-channel ratio), FrameRateGovernor
  (given frame times, no clock), adaptive_active_mask: equal to the JAX
  functions' values.
- Three frames of each entry point at 32x24 on "shadertoy:cornell" (brute
  force in both packages) with a move_camera between the first and the
  second, frame by frame, and the temporal histories after the last.
- One fused frame past the adaptive mask's warm-up: both renderers start
  from the same seeded history (Renderer.load_realtime_history carries the
  JAX renderer's over as numpy) at frame 9; the images, the live pixel
  count and the reuse of skipped pixels' lighting.
- trace_decoupled against the JAX package's; render_denoised with both
  packages' load_oidn patched to the same random weights
  (tests/test_torch_oidn.py), and refusing to run without archive=.
- The debug views RealTime feeds: LIVE_PIXELS shows the mask,
  MOTION_VECTORS the reprojection after a camera move.

Tolerance: |d| <= 1e-3 (1 + |ref|) on at least 99% of pixels for what a
wave returns (tests/test_torch_renderer.py's bound: a float32 difference
between XLA and PyTorch can flip a lane's first hit at a silhouette, its
lobe choice or its russian roulette), and on at least 97% of pixels for
the frames and their histories: the a-trous filter's 25 taps at dilations
1 to 8 and the 3x3 neighbourhood clamp spread one flipped lane over its
surroundings, and a validity threshold of the temporal pass can flip a
pixel's history tap (measured: 2 lanes of 768 differ in the first wave,
16 pixels in the second frame, 13 in the third).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import (
    OutputSettings,
    OutputType,
    PerformanceSettings,
    RenderMode,
    Renderer,
)
from tracerboy_tpu_torch.post import realtime as rt

torch.set_num_threads(2)

FILM = (32, 24)
H, W = FILM[1], FILM[0]
MOVE = dict(forward=0.15, strafe=0.05, yaw=0.02, pitch=-0.01)
HIST_KEYS = ("indirect", "moments", "final", "prev_world_pos")
WAVE_SHARE, FRAME_SHARE = 0.99, 0.97
f32 = np.float32


def _share(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    ok = np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))
    return ok.reshape(H * W, -1).all(-1).mean()


def _pair(name="shadertoy:cornell", **perf):
    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.utils import config as jcfg

    js = jcfg.OutputSettings(
        render_mode=jcfg.RenderMode.REAL_TIME,
        performance_settings=jcfg.PerformanceSettings(**perf))
    s = OutputSettings(render_mode=RenderMode.REAL_TIME,
                       performance_settings=PerformanceSettings(**perf))
    return (JaxRenderer(name, settings=js, film_size=FILM),
            Renderer(name, settings=s, film_size=FILM, device="cpu"))


def _tree_numpy(x):
    if isinstance(x, dict):
        return {k: _tree_numpy(v) for k, v in x.items()}
    return np.asarray(x)


# -- the functions ------------------------------------------------------------

def test_composite_albedo_matches_jax():
    import jax.numpy as jnp

    from tracerboy_tpu.post.realtime import composite_albedo as jc

    rng = np.random.default_rng(0)
    alb, ind, emi, dc3 = (rng.random((6, 5, 3), dtype=f32) for _ in range(4))
    dc1 = rng.random((6, 5), dtype=f32)
    for dc in (dc1, dc3):
        ref = jc(*(jnp.asarray(x) for x in (alb, dc, ind, emi)))
        got = rt.composite_albedo(*(torch.from_numpy(x)
                                    for x in (alb, dc, ind, emi)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
    one = rt.composite_albedo(torch.full((4, 4, 3), 0.5),
                              torch.ones(4, 4), torch.full((4, 4, 3), 2.0),
                              torch.full((4, 4, 3), 0.25))
    np.testing.assert_allclose(one.numpy(), 0.5 * 2.0 + 0.25)


@pytest.mark.parametrize("times", [
    [0.1] * 5, [0.01] * 5, [0.2] * 25 + [0.001] * 60,
    [0.03, 0.04, 0.02, 0.05, 0.033] * 8], ids=["slow", "fast", "dynamics",
                                               "near_target"])
def test_governor_matches_jax(times):
    from tracerboy_tpu.post.realtime import FrameRateGovernor as JG

    ref, got = JG(30.0, pad=0.1), rt.FrameRateGovernor(30.0, pad=0.1)
    pads = [(ref.update(t), got.update(t)) for t in times]
    assert all(a == b for a, b in pads)
    assert got.increment == ref.increment
    assert got.pad >= 0.0
    if times[0] == 0.1:
        assert got.pad > 0.1
    if times[0] == 0.01:
        assert got.pad < 0.1
    if len(times) == 85:
        grown = pads[24][1]
        assert grown > 0.1 and got.pad < grown


@pytest.mark.parametrize("frame", [3, 8, 20])
def test_adaptive_mask_matches_jax(frame):
    import jax.numpy as jnp

    from tracerboy_tpu.post.realtime import adaptive_active_mask as jm

    rng = np.random.default_rng(frame)
    mu = rng.random((H, W), dtype=f32)
    noise = np.where(rng.random((H, W)) < 0.5, 0.0,
                     rng.random((H, W)) * 0.05).astype(f32)
    moments = np.stack([mu, mu * mu + noise, np.full((H, W), 9, f32)], -1)
    ref = np.asarray(jm(jnp.asarray(moments), 0.05, 0.02, jnp.int32(frame)))
    got = rt.adaptive_active_mask(torch.from_numpy(moments), 0.05, 0.02,
                                  frame).numpy()
    assert got.shape == ref.shape == (H * W,) and got.dtype == bool
    assert (got == ref).mean() >= 0.999       # sqrt(var) / mu at the bound
    assert got.all() == (frame < 8)
    if frame >= 8:
        assert 0.2 < got.mean() < 0.8


# -- the frames ---------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["frame", "fused"])
def test_three_frames_match_jax(fused):
    ref, r = _pair()

    def step(x):
        if fused:
            return np.asarray(x.render_realtime_frame_fused(as_numpy=True))
        return np.asarray(x.render_realtime_frame())

    for frame in range(3):
        if frame == 1:
            ref.move_camera(**MOVE)
            r.move_camera(**MOVE)
            for key in ("position", "look_at", "right", "up"):
                np.testing.assert_allclose(
                    r.scene["camera"][key].numpy(),
                    np.asarray(ref.scene_pytree["camera"][key]), atol=1e-6)
        want, got = step(ref), step(r)
        assert got.shape == (H, W, 3) and got.dtype == np.float32
        assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
        assert _share(got, want) >= FRAME_SHARE, (frame, _share(got, want))
    jh = _tree_numpy(ref._rt_hist_fused if fused else ref._rt_history)
    ph = r._rt_hist_fused if fused else r._rt_history
    for key in HIST_KEYS:
        assert _share(ph[key].numpy(), jh[key]) >= FRAME_SHARE, key
    # Frame 2 blends a history: sample counts above 1 on geometry.
    count = ph["moments"][..., 2].numpy()
    assert (count > 1.5).mean() > 0.5
    assert r.state.spp == ref.state.spp == 2     # the move restarted it
    if fused:
        assert int(r._rt_live_pixels) == int(ref._rt_live_pixels) == H * W
        for key in ("raw",):
            assert _share(ph[key].numpy(), jh[key]) >= WAVE_SHARE
        for key, val in jh["aovs"].items():
            assert _share(ph["aovs"][key].numpy(), val) >= WAVE_SHARE, key
    else:
        # The moved frame reprojected the first frame's history.
        assert r._cam_prev is not None


def test_adaptive_frame_from_a_carried_history():
    """Frame 9, past the mask's warm-up: both renderers continue from the
    JAX renderer's history with seeded moments that mark about half of
    the pixels as converged."""
    import jax.numpy as jnp

    ref, r = _pair(target_frame_rate=30.0, min_convergence=0.05,
                   convergence_percent_pad=0.0)
    for _ in range(2):
        ref.render_realtime_frame_fused()
    hist = _tree_numpy(ref._rt_hist_fused)
    rng = np.random.default_rng(9)
    mu = hist["moments"][..., 0]
    noisy = rng.random((H, W)) < 0.5
    hist["moments"] = np.stack(
        [mu, mu * mu + np.where(noisy, (0.5 * mu) ** 2, 0.0),
         np.full((H, W), 9.0)], -1).astype(f32)
    cam_prev = _tree_numpy(ref._cam_prev)
    ref._rt_hist_fused = {
        k: ({a: jnp.asarray(b) for a, b in v.items()}
            if isinstance(v, dict) else jnp.asarray(v))
        for k, v in hist.items()}
    r.load_realtime_history(hist, cam_prev, fused=True)
    ref.state.spp = r.state.spp = 9
    want = np.asarray(ref.render_realtime_frame_fused(as_numpy=True))
    got = r.render_realtime_frame_fused(as_numpy=True)
    live = int(r._rt_live_pixels)
    assert live == int(ref._rt_live_pixels)
    assert 0.2 * H * W < live < 0.8 * H * W
    assert _share(got, want) >= FRAME_SHARE
    # Skipped pixels keep the history's lighting and AOVs.
    skipped = ~r._live_pixels.reshape(H, W).numpy()
    np.testing.assert_array_equal(
        r._rt_hist_fused["raw"].numpy()[skipped], hist["raw"][skipped])
    np.testing.assert_array_equal(
        r._rt_hist_fused["aovs"]["albedo"].numpy()[skipped],
        hist["aovs"]["albedo"][skipped])
    # The LIVE_PIXELS view shows the mask.
    r.settings = dataclasses.replace(r.settings,
                                     output_type=OutputType.LIVE_PIXELS)
    view = r.current_image()
    np.testing.assert_array_equal(view[..., 0] > 0.5, ~skipped)


def test_history_carry_over_unfused():
    ref, r = _pair()
    ref.render_realtime_frame()
    r.load_realtime_history(_tree_numpy(ref._rt_history),
                            _tree_numpy(ref._cam_prev), fused=False)
    r.state.spp = ref.state.spp
    want, got = ref.render_realtime_frame(), r.render_realtime_frame()
    assert _share(got, np.asarray(want)) >= FRAME_SHARE
    r.load_realtime_history(None, fused=False)
    assert r._rt_history == {} and r._cam_prev is None


def test_motion_vectors_view_after_a_move():
    _, r = _pair()
    r.render_realtime_frame()
    r.settings = dataclasses.replace(r.settings,
                                     output_type=OutputType.MOTION_VECTORS)
    assert not r.current_image().any()          # static camera
    r.move_camera(strafe=0.3)
    img = r.current_image()
    assert img[..., :2].max() > 0.05 and not img[..., 2].any()


def test_update_settings_restarts_accumulation():
    r = Renderer("shadertoy:cornell", film_size=(8, 8), device="cpu")
    r.render_sample(2)
    s = r.settings
    r.update_settings(s.replace(post_settings=dataclasses.replace(
        s.post_settings, exposure_multiplier=2.0)))
    assert r.state.spp == 2                     # post only: kept
    r.update_settings(r.settings.replace(fireflies_clamp=4.0))
    assert r.state.spp == 0 and not r.state.accum.any()
    # Adaptive sampling is taken; its mask waits for ADAPTIVE_MIN_SPP.
    r.update_settings(r.settings.replace(
        performance_settings=PerformanceSettings(
            enable_adaptive_sampling=True)))
    assert r.settings.performance_settings.enable_adaptive_sampling
    r.render_sample(1)
    assert r.active_pixel_mask() is None and r.state.spp == 1


# -- the batch form -----------------------------------------------------------

def test_trace_decoupled_matches_jax():
    from tracerboy_tpu import Renderer as JaxRenderer

    ref = JaxRenderer("shadertoy:cornell", film_size=FILM)
    r = Renderer("shadertoy:cornell", film_size=FILM, device="cpu")
    want, got = ref.trace_decoupled(3, clamp=5.0), r.trace_decoupled(
        3, clamp=5.0)
    assert set(got) == set(want)
    assert got["spp"] == want["spp"] == 3
    for key in want:
        if key != "spp":
            assert _share(got[key].numpy(),
                          np.asarray(want[key])) >= WAVE_SHARE, key
    assert r.state.spp == 0 and r.settings.fireflies_clamp == 0.0
    assert float(got["radiance"].max()) <= 3 * 5.0 + 1e-4


@pytest.mark.parametrize("demod", [True, False], ids=["demod", "plain"])
def test_render_denoised_matches_jax(monkeypatch, demod):
    from test_torch_oidn import _patch_weights
    from tracerboy_tpu import Renderer as JaxRenderer

    _patch_weights(monkeypatch)
    ref = JaxRenderer("shadertoy:cornell", film_size=FILM)
    r = Renderer("shadertoy:cornell", film_size=FILM, device="cpu")
    acc = ref.trace_decoupled(2)
    pacc = {k: (v if k == "spp" else torch.from_numpy(np.array(v)))
            for k, v in acc.items()}
    for model in ("rt_ldr", "rt_ldr_alb_nrm"):
        want = ref.render_denoised(model=model, demod=demod,
                                   filter_albedo=True, _acc=acc)
        got = r.render_denoised(model=model, demod=demod, filter_albedo=True,
                                _acc=pacc, archive=f"{model}.tza")
        assert got.shape == (H, W, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    traced = r.render_denoised(spp=2, archive="rt_ldr.tza")
    assert traced.shape == (H, W, 3) and traced.mean() > 0
    assert r.state.spp == 0


def test_render_denoised_needs_the_archive_path():
    r = Renderer("shadertoy:cornell", film_size=(16, 12), device="cpu")
    with pytest.raises(ValueError, match="rt_ldr.tza"):
        r.render_denoised(spp=1)
