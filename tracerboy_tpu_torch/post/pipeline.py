"""Display post-processing of the lit image (tracerboy_tpu/post/pipeline.py):
resolve the weighted accumulator, histogram auto-exposure, tonemap, gamma.

The reference's PostProcessCS (PostProcessCS.hlsl:23-43) and its
auto-exposure chain (GenerateHistogramCS / CalculateAveragedLuminanceCS:
256-bin log-luma histogram -> weighted average -> LinearGray/avgLum).
The debug AOV views of post_process are not ported yet.
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


def post_process(accum, settings: OutputSettings):
    """The lit display image (H, W, 3) in [0, 1]."""
    if settings.output_type != OutputType.LIT:
        raise NotImplementedError(
            f"output type {settings.output_type.name}: debug AOV views are "
            "not ported yet (ROADMAP.md, Queue 1: post/visualize.py)")
    ps = settings.post_settings
    return display_transform(
        resolve_accumulator(accum), ps.exposure_multiplier,
        int(ps.tonemap_type), ps.enable_gamma_correction,
        ps.enable_auto_exposure,
    )
