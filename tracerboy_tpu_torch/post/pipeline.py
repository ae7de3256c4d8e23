"""Display post-processing (tracerboy_tpu/post/pipeline.py): resolve the
weighted accumulator, histogram auto-exposure, tonemap, gamma, and the
debug AOV views.

The reference's PostProcessCS (PostProcessCS.hlsl:23-43, the AOV
selector 148-196) and its auto-exposure chain (GenerateHistogramCS /
CalculateAveragedLuminanceCS: 256-bin log-luma histogram -> weighted
average -> LinearGray/avgLum).
"""

from __future__ import annotations

import torch

from tracerboy_tpu_torch.core import tonemap as tm
from tracerboy_tpu_torch.core.mathutil import luminance
from tracerboy_tpu_torch.utils.config import OutputSettings, OutputType

HISTOGRAM_BINS = 256
LINEAR_GRAY = 0.18


def resolve_accumulator(accum):
    """(H, W, 4) weighted accumulator -> (H, W, 3) mean radiance."""
    return accum[..., :3] / torch.clamp_min(accum[..., 3:4], 1e-8)


def luminance_histogram(color, bins: int = HISTOGRAM_BINS,
                        lum_range: float = 12.0):
    """256-bin log2-luminance histogram; bin 0 collects black pixels.
    The counts are exact, so bincount gives the JAX sort-based counts."""
    luma = luminance(color)
    t = (torch.log2(torch.clamp_min(luma, 1e-12)) + lum_range / 2.0) \
        / lum_range
    idx = torch.clamp((t * (bins - 2)).to(torch.int32) + 1, 1, bins - 1)
    idx = torch.where(luma < 1e-8, 0, idx)
    return torch.bincount(idx.reshape(-1).to(torch.int64), minlength=bins)


def average_luminance(hist, lum_range: float = 12.0):
    """Weighted average luminance, excluding the black bin."""
    bins = hist.shape[0]
    counts = hist[1:].to(torch.float32)
    t = (torch.arange(1, bins, dtype=torch.float32, device=hist.device)
         - 1) / (bins - 2)
    lum = torch.exp2(t * lum_range - lum_range / 2.0)
    total = torch.clamp_min(torch.sum(counts), 1.0)
    return torch.sum(counts * lum) / total


def auto_exposure_scale(color):
    """Exposure scale = LinearGray / average luminance."""
    avg = average_luminance(luminance_histogram(color))
    return LINEAR_GRAY / torch.clamp_min(avg, 1e-8)


def display_transform(color, exposure_multiplier: float, tonemap_type: int,
                      enable_gamma: bool = True,
                      enable_auto_exposure: bool = True):
    if enable_auto_exposure:
        color = color * auto_exposure_scale(color)
    color = color * exposure_multiplier
    color = tm.tonemap(tonemap_type, color)
    if enable_gamma:
        color = tm.gamma_correct(color)
    return torch.clamp(color, 0.0, 1.0)


def post_process(accum, settings: OutputSettings, aovs=None, width=0,
                 height=0):
    """The display image (H, W, 3) in [0, 1]: the lit image, or the AOV
    view settings.output_type selects (aovs: the wave's AOV planes plus
    optional "variance", "live_pixels" and "motion"; without aovs, the
    lit image)."""
    color = resolve_accumulator(accum)
    out_type = settings.output_type
    if out_type == OutputType.LIT or aovs is None:
        ps = settings.post_settings
        return display_transform(
            color, ps.exposure_multiplier, int(ps.tonemap_type),
            ps.enable_gamma_correction, ps.enable_auto_exposure,
        )

    h, w = height, width
    zeros = dict(dtype=torch.float32, device=color.device)
    if out_type == OutputType.ALBEDO:
        return torch.clamp(aovs["albedo"].reshape(h, w, 3), 0.0, 1.0)
    if out_type == OutputType.NORMAL:
        return aovs["normal"].reshape(h, w, 3) * 0.5 + 0.5
    if out_type == OutputType.DEPTH:
        d = aovs["depth"].reshape(h, w, 1)
        dmax = torch.clamp_min(torch.max(d), 1e-6)
        return (1.0 - torch.clamp(d / dmax, 0.0, 1.0)).repeat(1, 1, 3)
    if out_type == OutputType.LUMINANCE:
        lum = luminance(color)[..., None]
        return torch.clamp(lum, 0.0, 1.0).repeat(1, 1, 3)
    if out_type == OutputType.VARIANCE:
        v = aovs.get("variance")
        if v is None:
            return torch.zeros((h, w, 3), **zeros)
        return heatmap(v.reshape(h, w))
    if out_type == OutputType.HEATMAP:
        hm = aovs.get("heatmap")
        if hm is None:
            return torch.zeros((h, w, 3), **zeros)
        hm = hm.reshape(h, w)
        return heatmap(hm / torch.clamp_min(torch.max(hm), 1e-6))
    if out_type == OutputType.LIVE_PIXELS:
        lp = aovs.get("live_pixels")
        if lp is None:
            return torch.ones((h, w, 3), **zeros)
        return lp.reshape(h, w, 1).to(torch.float32).repeat(1, 1, 3)
    if out_type == OutputType.MOTION_VECTORS:
        mv = aovs.get("motion")
        if mv is None:
            return torch.zeros((h, w, 3), **zeros)
        mv = mv.reshape(h, w, 2)
        return torch.cat([torch.abs(mv) / 8.0, torch.zeros((h, w, 1),
                                                            **zeros)], -1)
    return torch.clamp(color, 0.0, 1.0)


def heatmap(x):
    """Green -> yellow -> red (PostProcessCS.hlsl:133-146 palette)."""
    x = torch.clamp(x, 0.0, 1.0)
    r = torch.clamp(2.0 * x, 0.0, 1.0)
    g = torch.clamp(2.0 * (1.0 - x), 0.0, 1.0)
    return torch.stack([r, g, torch.zeros_like(x)], dim=-1)
