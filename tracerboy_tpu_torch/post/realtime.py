"""The RealTime frame chain: temporal accumulation -> a-trous -> albedo
composite -> temporal accumulation (tracerboy_tpu/post/realtime.py; the
reference's TracerBoy.cpp:3062-3160).

The 1-spp demodulated lighting is accumulated over time (with luma
moments), wavelet-filtered, recombined with the first hit's albedo
(CompositeAlbedoCS.hlsl:17-26) and emission, and a second temporal pass
steadies the composite. Also the frame-rate governor
(TracerBoy.cpp:2691-2727) and the adaptive mask it feeds.
"""

from __future__ import annotations

import torch

from tracerboy_tpu_torch.post.denoise import denoise
from tracerboy_tpu_torch.post.temporal import temporal_accumulate


def composite_albedo(albedo, diffuse_contribution, indirect, emissive):
    """albedo * indirect * dc + indirect * (1 - dc) + emissive.
    diffuse_contribution is a per-pixel scalar (H, W) or the per-channel
    ratio D / I (H, W, 3) of the two-plane demodulated trace."""
    dc = diffuse_contribution
    if dc.dim() == indirect.dim() - 1:
        dc = dc[..., None]
    return albedo * indirect * dc + indirect * (1.0 - dc) + emissive


def realtime_frame(raw_indirect, aovs, history, cam_prev, lens_height,
                   denoiser_settings, history_weight: float = 0.95):
    """One RealTime frame. raw_indirect (H, W, 3): this frame's
    demodulated lighting; aovs: albedo, normal, world_pos (xyz and
    neighbour distance), emissive, diffuse_contrib, each (H, W, ...);
    history: dict of indirect, moments, final and prev_world_pos, empty
    before the first frame. Returns
    (display colour (H, W, 3), new history)."""
    first = history.get("indirect") is None
    zeros3 = torch.zeros_like(raw_indirect)
    prev_wp = history.get("prev_world_pos")
    hist = dict(
        indirect=zeros3 if first else history["indirect"],
        moments=zeros3 if first else history["moments"],
        final=zeros3 if first else history["final"],
        prev_world_pos=aovs["world_pos"] if prev_wp is None else prev_wp,
    )
    return frame_chain(raw_indirect, aovs, hist, cam_prev, lens_height,
                       denoiser_settings, history_weight,
                       ignore_history=first)


def frame_chain(raw_indirect, aovs, history, cam_prev, lens_height,
                denoiser_settings, history_weight: float,
                ignore_history: bool):
    """The post chain of one frame on a full history (the JAX package's
    _realtime_frame_jit). Returns (display, new history)."""
    ds = denoiser_settings
    catmull = bool(getattr(ds, "taa_catmull_rom", False))
    prev_wp = history["prev_world_pos"]

    # Temporal pass 1, on the lighting, with the variance in alpha.
    taa_ind, new_moments = temporal_accumulate(
        raw_indirect, aovs["world_pos"], aovs["normal"], prev_wp,
        history["indirect"], history["moments"], cam_prev, lens_height,
        history_weight=history_weight, ignore_history=ignore_history,
        output_moments=True, catmull_rom=catmull)

    if ds.enabled:
        indirect = denoise(
            taa_ind, raw_indirect, aovs["normal"], aovs["world_pos"],
            iterations=ds.wavelet_iterations,
            luma_weight_mult=ds.luminance_weight,
            normal_exp=ds.normal_weight_exponent,
            position_weight_mult=ds.intersection_position_weight_exponent,
        )[..., :3]
    else:
        indirect = taa_ind[..., :3]

    final = composite_albedo(aovs["albedo"], aovs["diffuse_contrib"],
                             indirect, aovs["emissive"])

    # Temporal pass 2, on the composite, without moments.
    taa_fin, _ = temporal_accumulate(
        final, aovs["world_pos"], aovs["normal"], prev_wp, history["final"],
        torch.zeros_like(final), cam_prev, lens_height,
        history_weight=history_weight, ignore_history=ignore_history,
        output_moments=False, catmull_rom=catmull)
    display = taa_fin[..., :3]
    return display, dict(indirect=taa_ind[..., :3], moments=new_moments,
                         final=display, prev_world_pos=aovs["world_pos"])


class FrameRateGovernor:
    """The adaptive-sampling throttle (TracerBoy.cpp:2691-2727): every
    FRAMES_PER_INCREMENT frames the mean frame time is held against the
    target, a signed increment flips or accelerates (capped at a quarter
    of the pad), and is added to the pad (kept >= 0). The pad is added to
    min_convergence, the threshold below which a pixel is skipped: fewer
    pixels stay active while the frame rate lags the target."""

    FRAMES_PER_INCREMENT = 5
    DEFAULT_INCREMENT = 0.0001

    def __init__(self, target_fps: float = 30.0, pad: float = 0.1):
        self.target_fps = target_fps
        self.pad = pad
        self.increment = self.DEFAULT_INCREMENT
        self._frames = 0
        self._accum = 0.0

    def update(self, frame_seconds: float) -> float:
        self._frames += 1
        self._accum += frame_seconds
        if self._frames >= self.FRAMES_PER_INCREMENT:
            frame_time = self._accum / self._frames
            target = 1.0 / max(self.target_fps, 1e-6)
            if frame_time < target and self.increment > 0.0:
                # Faster than the target: shrink the pad.
                self.increment = -self.DEFAULT_INCREMENT
            elif frame_time > target and self.increment < 0.0:
                self.increment = self.DEFAULT_INCREMENT
            else:
                mult = min(1.0 + 0.25 * abs(frame_time - target)
                           / max(frame_time, 1e-9), 2.0)
                self.increment *= mult
            cap = max(self.pad * 0.25, self.DEFAULT_INCREMENT)
            if abs(self.increment) > cap:
                self.increment = cap if self.increment > 0 else -cap
            self.pad = max(0.0, self.pad + self.increment)
            self._frames = 0
            self._accum = 0.0
        return self.pad


def adaptive_active_mask(moments, min_convergence, pad, frame_index,
                         warmup: int = 8):
    """The flat (H*W,) bool mask of pixels that stay active: those whose
    relative luma noise sqrt(var) / |mean|, from the moment buffer
    (H, W, 3) = (mean, mean of squares, count), exceeds min_convergence +
    pad; every pixel during the first warmup frames."""
    mu = moments[..., 0]
    var = torch.clamp_min(moments[..., 1] - mu * mu, 0.0)
    err = torch.sqrt(var) / torch.clamp_min(torch.abs(mu), 1e-4)
    active = err > (min_convergence + pad)
    if frame_index < warmup:
        active = torch.ones_like(active)
    return active.reshape(-1)
