"""Pixel reconstruction filter weights (box / triangle / Gaussian)
(tracerboy_tpu/core/filters.py).

The reference evaluates the filter weight at the jittered sample offset
and stores it in the accumulator alpha channel as the sample weight
(TracerBoy/kernel.glsl:1840-1870); display divides RGB by alpha.
filter_weight returns the weight for an AA jitter in [0,1)^2. As in the
JAX package no module routes through it: the wave keeps its own inline
copy of these weights, which also scales the offset by filter_width.
"""

from __future__ import annotations

import torch

from tracerboy_tpu_torch.utils.config import FilterType


def gaussian(x, mu, sigma):
    a = (x - mu) / sigma
    return torch.exp(-0.5 * a * a)


def filter_weight(jitter: torch.Tensor, filter_type: int,
                  filter_width: float = 1.0):
    """Weight for samples jittered by `jitter` (..., 2) in [0,1)^2 about
    the pixel centre. filter_width is not read, as in the JAX function.
    Matches the reference's per-type weights (kernel.glsl:1843-1868)."""
    offset = jitter - 0.5
    if filter_type == FilterType.TRIANGLE:
        w = torch.maximum(0.5 - torch.abs(offset[..., 0]),
                          0.5 - torch.abs(offset[..., 1]))
        return torch.clamp_min(w, 0.0)
    if filter_type == FilterType.GAUSSIAN:
        sigma = 0.8
        edge = gaussian(torch.tensor(1.0), 0.0, sigma)
        wx = torch.clamp_min(
            gaussian(offset[..., 0] * 2.0, 0.0, sigma) - edge, 0.0)
        wy = torch.clamp_min(
            gaussian(offset[..., 1] * 2.0, 0.0, sigma) - edge, 0.0)
        return wx * wy
    return torch.ones(jitter.shape[:-1], dtype=torch.float32,
                      device=jitter.device)
