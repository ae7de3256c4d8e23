"""Tonemap operators (tracerboy_tpu/core/tonemap.py; TracerBoy/Tonemap.h:
173-204): Reinhard, ACES (Stephen Hill fit), Clamp, Uncharted2, Khronos
PBR Neutral, AgX, AgX punchy and GT (Uchimura), over (..., 3) tensors.

The 3x3 colour matrices are applied as explicit sums of products in
float32: no matrix product, so no TF32 path can touch them.
"""

from __future__ import annotations

import numpy as np
import torch

TONEMAP_REINHARD = 0
TONEMAP_ACES = 1
TONEMAP_CLAMP = 2
TONEMAP_UNCHARTED = 3
TONEMAP_KHRONOS_PBR_NEUTRAL = 4
TONEMAP_AGX = 5
TONEMAP_AGX_PUNCHY = 6
TONEMAP_GT = 7


def _luma(c):
    return (0.212671 * c[..., 0] + 0.715160 * c[..., 1]
            + 0.072169 * c[..., 2])[..., None]


def _mat3(color, m: np.ndarray):
    """color @ m.T for a constant 3x3 float32 matrix."""
    m = [[float(v) for v in row] for row in np.asarray(m, np.float32)]
    r, g, b = color[..., 0], color[..., 1], color[..., 2]
    return torch.stack(
        [r * m[k][0] + g * m[k][1] + b * m[k][2] for k in range(3)], dim=-1)


def reinhard(color):
    return color / (1.0 + color)


def clamp_op(color):
    return torch.clamp(color, 0.0, 1.0)


_ACES_INPUT = np.array([[0.59719, 0.35458, 0.04823],
                        [0.07600, 0.90834, 0.01566],
                        [0.02840, 0.13383, 0.83777]], np.float32)
_ACES_OUTPUT = np.array([[1.60475, -0.53108, -0.07367],
                         [-0.10208, 1.10813, -0.00605],
                         [-0.00327, -0.07276, 1.07602]], np.float32)


def aces_fitted(color):
    c = _mat3(color, _ACES_INPUT)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return torch.clamp(_mat3(a / b, _ACES_OUTPUT), 0.0, 1.0)


def _uncharted2_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def uncharted2(color):
    curr = _uncharted2_partial(color * 2.0)
    white = _uncharted2_partial(
        torch.full((3,), 11.2, dtype=torch.float32, device=color.device))
    return curr * (1.0 / white)


def khronos_pbr_neutral(color):
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.amin(color, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = color - offset
    peak = torch.amax(c, dim=-1, keepdim=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (torch.clamp_min(peak, 1e-6) + d
                              - start_compression)
    scaled = c * (new_peak / torch.clamp_min(peak, 1e-6))
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    return torch.where(peak > start_compression,
                       scaled * (1.0 - g) + new_peak * g, c)


_AGX_TRANSFORM = np.array(
    [[0.842479062253094, 0.0423282422610123, 0.0423756549057051],
     [0.0784335999999992, 0.878468636469772, 0.0784336],
     [0.0792237451477643, 0.0791661274605434, 0.879142973793104]],
    np.float32)
_AGX_INV_TRANSFORM = np.array(
    [[1.19687900512017, -0.0528968517574562, -0.0529716355144438],
     [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
     [-0.0990297440797205, -0.0989611768448433, 1.15107367264116]],
    np.float32)
_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def _agx_contrast_approx(x):
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(color, punchy: bool = False):
    c = _mat3(color, _AGX_TRANSFORM)
    c = torch.clamp(torch.log2(torch.clamp_min(c, 1e-10)),
                    _AGX_MIN_EV, _AGX_MAX_EV)
    val = _agx_contrast_approx((c - _AGX_MIN_EV)
                               / (_AGX_MAX_EV - _AGX_MIN_EV))
    if punchy:
        luma = (val[..., 0:1] * float(np.float32(0.2126))
                + val[..., 1:2] * float(np.float32(0.7152))
                + val[..., 2:3] * float(np.float32(0.0722)))
        val = torch.pow(torch.clamp_min(val, 0.0), 1.35)
        val = luma + 1.4 * (val - luma)
    return torch.clamp(_mat3(val, _AGX_INV_TRANSFORM), 0.0, 1.0)


def _smooth01(x):
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def gt_tonemap(color):
    P, a, m, l, c, b = 1.0, 1.0, 0.22, 0.4, 1.33, 0.0
    x = color
    l0 = ((P - m) * l) / a
    S0 = m + l0
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P
    w0 = 1.0 - _smooth01(x / float(np.float32(m)))
    w2 = torch.where(x > m + l0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2
    T = m * torch.pow(torch.clamp_min(x, 1e-8) / m, c) + b
    S = P - (P - S1) * torch.exp(CP * (x - S0))
    L = m + a * (x - m)
    return T * w0 + L * w1 + S * w2


_OPERATORS = {
    TONEMAP_REINHARD: reinhard,
    TONEMAP_ACES: aces_fitted,
    TONEMAP_CLAMP: clamp_op,
    TONEMAP_UNCHARTED: uncharted2,
    TONEMAP_KHRONOS_PBR_NEUTRAL: khronos_pbr_neutral,
    TONEMAP_AGX: agx,
    TONEMAP_AGX_PUNCHY: lambda c: agx(c, punchy=True),
    TONEMAP_GT: gt_tonemap,
}


def tonemap(tonemap_type: int, color):
    """Apply operator `tonemap_type` to linear RGB."""
    return _OPERATORS[int(tonemap_type)](color)


def gamma_correct(color, gamma: float = 2.2):
    """Linear -> display gamma."""
    return torch.pow(torch.clamp_min(color, 0.0), 1.0 / gamma)


def gamma_to_linear(color, gamma: float = 2.2):
    return torch.pow(torch.clamp_min(color, 0.0), gamma)
