"""Temporal accumulation with camera reprojection and luma moments
(tracerboy_tpu/post/temporal.py; the reference's
TemporalAccumulationCS.hlsl).

A pixel's world position is projected through the previous camera's lens
plane to find its history; the four bilinear history taps are weighted by
world-position validity (a tap whose previous world position lies further
from this pixel's than the 3x3 neighbourhood's extent is rejected), the
history colour is clamped to the 3x3 neighbourhood of the current colour
and blended with weight history_weight (0.95), and a luma moment history
(mean, mean of squares, sample count, capped at 32 samples) gives the
variance that the a-trous filter reads from the output's alpha. The pass
runs twice per RealTime frame: on the demodulated lighting and on the
final composite.

Plain PyTorch on (H, W, C) tensors; cameras are dicts of tensors (the
scene's "camera" leaf: position, look_at, right, up, focal_distance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_edge(x, before: int, after: int):
    """Edge-replicated padding of the two leading (image) axes of
    (H, W) or (H, W, C)."""
    planes = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    out = F.pad(planes, (before, after, before, after), mode="replicate")
    return out[0, 0] if x.dim() == 2 else out[0].permute(1, 2, 0)


def _neighborhood_minmax(x):
    """Per-pixel min and max of (H, W, C) over the edge-clamped 3x3
    neighbourhood."""
    H, W = x.shape[:2]
    p = _pad_edge(x, 1, 1)
    lo, hi = x, x
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dx == 1 and dy == 1:
                continue
            sh = p[dy:dy + H, dx:dx + W]
            lo = torch.minimum(lo, sh)
            hi = torch.maximum(hi, sh)
    return lo, hi


def _dot3(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def project_to_prev_uv(world_pos, cam_prev, lens_height, width, height):
    """World positions (..., 3) -> (uv (..., 2), valid) in the previous
    frame, through the intersection with that camera's lens plane
    (TemporalAccumulationCS.hlsl:113-135)."""
    aspect = width / height
    lens_w = lens_height * aspect
    prev_pos = cam_prev["position"]
    prev_dir = cam_prev["look_at"] - prev_pos
    prev_dir = prev_dir / torch.sqrt(_dot3(prev_dir, prev_dir))
    focal = prev_pos - cam_prev["focal_distance"] * prev_dir

    ray = world_pos - focal
    denom = _dot3(ray, prev_dir)
    t = _dot3(prev_pos - focal, prev_dir) / torch.where(
        torch.abs(denom) > 1e-9, denom, 1e-9)
    lens_point = focal + ray * t[..., None]
    off = lens_point - prev_pos
    u = _dot3(off, cam_prev["right"]) / (lens_w / 2.0)
    v = _dot3(off, cam_prev["up"]) / (lens_height / 2.0)
    uv = torch.stack([(u + 1.0) / 2.0, 1.0 - (v + 1.0) / 2.0], dim=-1)
    valid = (t >= 0) & ((uv >= 0.0) & (uv <= 1.0)).all(dim=-1)
    return uv, valid


def _quad(x):
    """(H, W, C) -> the 2x2 neighbourhood of every texel, edge-clamped:
    [(y, x), (y, x+1), (y+1, x), (y+1, x+1)], each (H, W, C)."""
    H, W = x.shape[:2]
    p = _pad_edge(x, 0, 1)
    return [x, p[:H, 1:W + 1], p[1:H + 1, :W], p[1:H + 1, 1:W + 1]]


def _sample_history_catmull_rom(history, fx, fy, H, W):
    """Catmull-Rom resampling of the colour history in 9 bilinear taps
    (TemporalAccumulationCS.hlsl:24-72): (H, W, 3)."""
    pos_x = fx + 0.5
    pos_y = fy + 0.5
    t1x = torch.floor(pos_x - 0.5) + 0.5
    t1y = torch.floor(pos_y - 0.5) + 0.5
    f_x = pos_x - t1x
    f_y = pos_y - t1y

    def wgts(f):
        w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
        w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
        w2 = f * (0.5 + f * (2.0 - 1.5 * f))
        w3 = f * f * (-0.5 + 0.5 * f)
        return w0, w1, w2, w3

    w0x, w1x, w2x, w3x = wgts(f_x)
    w0y, w1y, w2y, w3y = wgts(f_y)
    w12x = w1x + w2x
    w12y = w1y + w2y
    off12x = w2x / torch.clamp_min(w12x, 1e-8)
    off12y = w2y / torch.clamp_min(w12y, 1e-8)
    quad = [q.reshape(H * W, 3) for q in _quad(history)]

    def bilinear(px, py):
        qx = torch.clamp(px - 0.5, 0.0, W - 1.001)
        qy = torch.clamp(py - 0.5, 0.0, H - 1.001)
        bx = torch.floor(qx).to(torch.int64)
        by = torch.floor(qy).to(torch.int64)
        rx = (qx - bx)[..., None]
        ry = (qy - by)[..., None]
        idx = by * W + bx
        return (quad[0][idx] * (1 - rx) * (1 - ry)
                + quad[1][idx] * rx * (1 - ry)
                + quad[2][idx] * (1 - rx) * ry
                + quad[3][idx] * rx * ry)

    xs = [(t1x - 1.0, w0x), (t1x + off12x, w12x), (t1x + 2.0, w3x)]
    ys = [(t1y - 1.0, w0y), (t1y + off12y, w12y), (t1y + 2.0, w3y)]
    acc = torch.zeros((H, W, 3), dtype=history.dtype, device=history.device)
    for py, wy in ys:
        for px, wx in xs:
            acc = acc + bilinear(px, py) * (wx * wy)[..., None]
    return acc


def temporal_accumulate(current, world_pos, normals, prev_world_pos, history,
                        moment_history, cam_prev, lens_height,
                        history_weight=0.95, ignore_history=False,
                        output_moments: bool = True,
                        catmull_rom: bool = False):
    """current (H, W, 3): this frame's colour; world_pos, prev_world_pos
    (H, W, 4): xyz and neighbour distance of this and the previous frame;
    normals (H, W, 3) (all zero = no geometry); history (H, W, 3): the
    colour history; moment_history (H, W, 3): luma mean, mean of squares,
    sample count. Returns (colour with the luma variance in alpha
    (H, W, 4), new moments (H, W, 3))."""
    H, W = current.shape[:2]
    wp = world_pos[..., :3]
    hit_valid = (normals != 0.0).any(dim=-1)
    uv, in_bounds = project_to_prev_uv(wp, cam_prev, lens_height, W, H)

    nmin_c, nmax_c = _neighborhood_minmax(current)
    nmin_w, nmax_w = _neighborhood_minmax(wp)
    ext = nmax_w - nmin_w
    ext2 = ext * ext
    dist_tol = torch.sqrt(ext2[..., 0] + ext2[..., 1] + ext2[..., 2])

    # The sample position is clamped into the texel grid, so the 2x2 tap
    # block never leaves the image.
    fx = torch.clamp(uv[..., 0] * W - 0.5, 0.0, W - 1.001)
    fy = torch.clamp(uv[..., 1] * H - 0.5, 0.0, H - 1.001)
    bx = torch.floor(fx).to(torch.int64)
    by = torch.floor(fy).to(torch.int64)
    frx = fx - bx
    fry = fy - by

    packed = torch.cat([history, moment_history, prev_world_pos[..., :3]],
                       dim=-1)
    taps = [q.reshape(H * W, 9)[by * W + bx] for q in _quad(packed)]
    prev_c = torch.zeros_like(current)
    prev_m = torch.zeros_like(current)
    weight_sum = torch.zeros((H, W), dtype=current.dtype,
                             device=current.device)
    for dx in (0, 1):
        for dy in (0, 1):
            rows = taps[dy * 2 + dx]
            dw = rows[..., 6:9] - wp
            dw2 = dw * dw
            dd = dw2[..., 0] + dw2[..., 1] + dw2[..., 2]
            ok = dd < dist_tol * dist_tol
            wx = (1.0 - frx) if dx == 0 else frx
            wy = (1.0 - fry) if dy == 0 else fry
            wgt = torch.where(ok, wx * wy, 0.0)
            prev_c = prev_c + rows[..., 0:3] * wgt[..., None]
            prev_m = prev_m + rows[..., 3:6] * wgt[..., None]
            weight_sum = weight_sum + wgt

    wdiv = torch.clamp_min(weight_sum, 1e-8)
    if catmull_rom:
        # Colour history by Catmull-Rom; validity and moments keep the
        # bilinear taps, and the neighbourhood clamp bounds any ringing.
        cr = _sample_history_catmull_rom(history, fx, fy, H, W)
        prev_c = torch.where((weight_sum > 0.0)[..., None],
                             cr * wdiv[..., None], prev_c)

    valid = in_bounds & hit_valid & (weight_sum > 0.0)
    if ignore_history:
        valid = torch.zeros_like(valid)
    prev_c = prev_c / wdiv[..., None]
    prev_m = prev_m / wdiv[..., None]

    out_alpha = torch.ones((H, W), dtype=current.dtype, device=current.device)
    new_moments = moment_history
    if output_moments:
        luma = (0.2126 * current[..., 0] + 0.7152 * current[..., 1]
                + 0.0722 * current[..., 2])
        sample_count = torch.where(valid, prev_m[..., 2], 0.0) + 1.0
        lerp = 1.0 / torch.clamp_max(sample_count, 32.0)
        mu = prev_m[..., 0] * (1 - lerp) + luma * lerp
        mu2 = prev_m[..., 1] * (1 - lerp) + luma * luma * lerp
        new_moments = torch.stack([mu, mu2, sample_count], dim=-1)
        out_alpha = torch.clamp_min(mu2 - mu * mu, 0.0)

    blend = torch.where(valid, history_weight, 0.0)[..., None]
    out_c = (current * (1 - blend)
             + torch.minimum(torch.maximum(prev_c, nmin_c), nmax_c) * blend)
    return torch.cat([out_c, out_alpha[..., None]], dim=-1), new_moments


def generate_motion_vectors(world_pos, cam_prev, cam_curr, lens_height,
                            width, height):
    """World positions (H, W, 3+) -> pixel-space motion vectors (H, W, 2)
    (GenerateMotionVectorsCS.hlsl:25-55)."""
    wp = world_pos[..., :3]
    uv_prev, v_prev = project_to_prev_uv(wp, cam_prev, lens_height, width,
                                         height)
    uv_curr, v_curr = project_to_prev_uv(wp, cam_curr, lens_height, width,
                                         height)
    size = torch.tensor([width, height], dtype=wp.dtype, device=wp.device)
    mv = (uv_prev - uv_curr) * size
    return torch.where((v_prev & v_curr)[..., None], mv, 0.0)
