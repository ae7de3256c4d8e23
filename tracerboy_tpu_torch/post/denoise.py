"""Edge-avoiding a-trous wavelet denoiser
(tracerboy_tpu/post/denoise.py; the reference's DenoiserCS.hlsl).

A 5x5 B3-spline kernel with dilation 2^i in iteration i. A tap's weight
is the product of a luma weight normalised by the centre's luma standard
deviation, the normals' dot product to the power normal_exp, a
world-position weight whose tolerance grows with the tap's offset and the
centre's neighbour distance, and the spline weight; the variance in alpha
is filtered with the squared weights. Taps come from edge-replicated
paddings, and a tap outside the image gets weight 0. Pixels without
geometry (normal 0) pass through.
"""

from __future__ import annotations

import torch

from tracerboy_tpu_torch.core.mathutil import luminance
from tracerboy_tpu_torch.post.temporal import _pad_edge

EPSILON = 1e-4
_KERNEL_1D = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def atrous_iteration(color_var, undenoised, normals, positions, step: int,
                     luma_weight_mult=4.0, normal_exp=128.0,
                     position_weight_mult=1.0):
    """One iteration at dilation step. color_var (H, W, 4): colour and
    luma variance; undenoised (H, W, 3): the noisy frame, whose luma is
    the reference; normals (H, W, 3); positions (H, W, 4): world position
    and neighbour distance. Returns (H, W, 4)."""
    H, W = color_var.shape[:2]
    dev = color_var.device
    center_luma = luminance(undenoised)
    center_var_sqrt = torch.sqrt(torch.clamp_min(color_var[..., 3], 0.0))
    neighbor_dist = positions[..., 3]
    pos = positions[..., :3]
    valid = (normals != 0.0).any(dim=-1)

    pad = 2 * step
    p_luma = _pad_edge(center_luma, pad, pad)
    p_n = _pad_edge(normals, pad, pad)
    p_p = _pad_edge(pos, pad, pad)
    p_c = _pad_edge(color_var, pad, pad)

    def tap(p, oy, ox):
        y0 = pad + oy * step
        x0 = pad + ox * step
        return p[y0:y0 + H, x0:x0 + W]

    acc_c = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    acc_var = torch.zeros((H, W), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((H, W), dtype=torch.float32, device=dev)
    luma_div = torch.clamp_min(luma_weight_mult * center_var_sqrt, EPSILON)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    for oy in range(-2, 3):
        for ox in range(-2, 3):
            luma_w = torch.exp(
                -torch.abs(tap(p_luma, oy, ox) - center_luma) / luma_div)
            tn = tap(p_n, oy, ox)
            ndot = (normals[..., 0] * tn[..., 0] + normals[..., 1] * tn[..., 1]
                    + normals[..., 2] * tn[..., 2])
            normal_w = torch.pow(torch.clamp_min(ndot, 0.0), normal_exp)
            dp = tap(p_p, oy, ox) - pos
            dist = torch.sqrt(dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]
                              + dp[..., 2] * dp[..., 2])
            # offset-scaled tolerance (DenoiserCS.hlsl:41-44)
            off_mag = abs(ox * step) + abs(oy * step)
            pos_w = torch.exp(
                -dist / (position_weight_mult * off_mag * neighbor_dist
                         + EPSILON))
            w = (luma_w * normal_w * pos_w
                 * _KERNEL_1D[ox + 2] * _KERNEL_1D[oy + 2])
            yy = ys + oy * step
            xx = xs + ox * step
            inside = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)).to(
                torch.float32)
            w = w * inside
            tc = tap(p_c, oy, ox)
            acc_c = acc_c + tc[..., :3] * w[..., None]
            acc_var = acc_var + tc[..., 3] * w * w
            acc_w = acc_w + w

    inv_w = 1.0 / torch.clamp_min(acc_w, 1e-8)
    out = torch.cat([acc_c * inv_w[..., None],
                     (acc_var * inv_w * inv_w)[..., None]], dim=-1)
    return torch.where(valid[..., None], out, color_var)


def denoise(color_var, undenoised, normals, positions, iterations: int = 4,
            **weights):
    """iterations a-trous passes with doubling dilation
    (DenoiserPass.cpp:61-93)."""
    out = color_var
    for i in range(iterations):
        out = atrous_iteration(out, undenoised, normals, positions,
                               step=2 ** i, **weights)
    return out
