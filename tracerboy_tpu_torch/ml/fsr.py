"""FSR1-style spatial upscale: edge-adaptive upsampling + RCAS sharpening
(tracerboy_tpu/ml/fsr.py).

The reference's FidelityFX-SR1 pass (TracerBoy/FidelityFXSuperResolution.cpp
and its vendored ffx_fsr1.h: EASU edge-adaptive scaling, then RCAS robust
contrast-adaptive sharpening), as the JAX package rebuilds it: Catmull-Rom
resampling over EASU's 4x4 support, then RCAS's 5-tap adaptive sharpen
with its noise-safe clamp. Plain PyTorch on the device of the image: the
JAX package computes both stages with jnp, no Pallas kernel.

Images are float32 (H, W, 3) tensors. The sample positions, the tap order
and the accumulation order are the JAX function's, so a tap at a pixel
border falls on the same side in both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def _catmull_rom_weights(t):
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def _positions(n_in: int, n_out: int, device):
    """(arange + 0.5) * float32(n_in / n_out) - 0.5 in float32, as jnp
    evaluates it; its floor (int64) and the fraction."""
    step = torch.tensor(np.float32(n_in / n_out), device=device)
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * step - 0.5
    i0 = torch.floor(pos).to(torch.int64)
    return i0, pos - i0


def easu_upscale(img, out_h: int, out_w: int):
    """Edge-preserving upsample via separable Catmull-Rom (4x4 support);
    (H, W, C) -> (out_h, out_w, C), clamped at 0."""
    H, W = img.shape[:2]
    y0, ty = _positions(H, out_h, img.device)
    x0, tx = _positions(W, out_w, img.device)
    wy = _catmull_rom_weights(ty)   # each (out_h,)
    wx = _catmull_rom_weights(tx)

    out = torch.zeros((out_h, out_w, img.shape[2]), dtype=torch.float32,
                      device=img.device)
    for j in range(4):
        yy = torch.clamp(y0 + j - 1, 0, H - 1)
        row_acc = torch.zeros_like(out)
        for i in range(4):
            xx = torch.clamp(x0 + i - 1, 0, W - 1)
            row_acc = row_acc + img[yy[:, None], xx[None, :]] \
                * wx[i][None, :, None]
        out = out + row_acc * wy[j][:, None, None]
    return torch.clamp_min(out, 0.0)


def rcas_sharpen(img, sharpness: float = 0.87):
    """Robust contrast-adaptive sharpen (the RCAS stage).

    5-tap cross kernel; the negative lobe is limited by the local min/max
    so noise is not amplified. The neighbours wrap around the image edge
    (jnp.roll in the JAX package)."""
    n = torch.roll(img, 1, dims=0)
    s = torch.roll(img, -1, dims=0)
    w = torch.roll(img, 1, dims=1)
    e = torch.roll(img, -1, dims=1)

    mn = torch.minimum(torch.minimum(torch.minimum(n, s),
                                     torch.minimum(w, e)), img)
    mx = torch.maximum(torch.maximum(torch.maximum(n, s),
                                     torch.maximum(w, e)), img)
    # Limiter: how much negative lobe the local contrast allows.
    hit_min = mn / torch.clamp_min(4.0 * mx, 1e-4)
    hit_max = (1.0 - mx) / torch.clamp_min(4.0 * mn - 4.0, -1e4)
    lobe = torch.maximum(-hit_min, torch.clamp_max(hit_max, 0.0))
    lobe = torch.clamp(lobe, -0.1875, 0.0) * sharpness
    denom = 4.0 * lobe + 1.0
    out = (lobe * (n + s + w + e) + img) / torch.clamp_min(denom, 1e-4)
    return torch.clamp(out, 0.0, 1.0)


def fsr_upscale(img, scale: float = 2.0, sharpness: float = 0.87):
    """Full FSR-style chain: EASU upscale to int(H * scale) x
    int(W * scale), then RCAS sharpen of the result clipped to [0, 1]."""
    H, W = img.shape[:2]
    up = easu_upscale(img, int(H * scale), int(W * scale))
    return rcas_sharpen(torch.clamp(up, 0.0, 1.0), sharpness)
