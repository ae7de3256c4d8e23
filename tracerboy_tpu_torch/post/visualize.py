"""Ray-path visualization (tracerboy_tpu/post/visualize.py): draw the
selected pixel's bounce path over the display image.

The debug view of the reference's VisualizeRaysCS.hlsl: the wave records
per-bounce segments of the selected lane (render_wave's viz_rays), which
are projected through the camera and rasterized as 2D lines on the host
in numpy, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

# bounce index -> colour ramp (blue -> green -> yellow -> red)
_BOUNCE_COLORS = np.array(
    [
        [0.2, 0.4, 1.0],
        [0.2, 1.0, 0.6],
        [0.6, 1.0, 0.2],
        [1.0, 0.9, 0.1],
        [1.0, 0.5, 0.1],
        [1.0, 0.1, 0.1],
    ],
    np.float32,
)


def project_point(cam, width, height, p):
    """World point -> pixel coordinates through the thin-lens camera (the
    inverse of trace/camera.py's primary ray mapping); None behind it.
    cam: dict of numpy arrays (position, look_at, right, up, lens_height,
    focal_distance)."""
    pos = np.asarray(cam["position"])
    forward = np.asarray(cam["look_at"]) - pos
    forward = forward / np.linalg.norm(forward)
    right = np.asarray(cam["right"])
    up = np.asarray(cam["up"])
    lens_h = float(cam["lens_height"])
    focal = pos - float(cam["focal_distance"]) * forward

    ray = p - focal
    denom = np.dot(ray, forward)
    if abs(denom) < 1e-9:
        return None
    t = np.dot(pos - focal, forward) / denom
    if t < 0:
        return None
    lens_pt = focal + ray * t
    off = lens_pt - pos
    aspect = width / height
    u = np.dot(off, right) / (lens_h * aspect / 2.0)
    v = np.dot(off, up) / (lens_h / 2.0)
    x = (u + 1.0) / 2.0 * width
    y = (1.0 - (v + 1.0) / 2.0) * height
    return x, y


def draw_line(img, x0, y0, x1, y1, color, alpha=0.85):
    """DDA line rasterization into an (H, W, 3) float image, in place."""
    H, W = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip((x0 + (x1 - x0) * ts).astype(int), 0, W - 1)
    ys = np.clip((y0 + (y1 - y0) * ts).astype(int), 0, H - 1)
    img[ys, xs] = img[ys, xs] * (1 - alpha) + np.asarray(color) * alpha
    return img


def overlay_ray_path(img, viz_rays, cam, width, height):
    """A copy of the display image with the recorded bounce segments
    drawn on it. viz_rays: (max_bounces, 8) rows [origin(3), hit(3), t,
    valid], numpy."""
    img = np.array(img, np.float32, copy=True)
    for i, row in enumerate(np.asarray(viz_rays)):
        if row[7] <= 0.0:
            continue
        a = project_point(cam, width, height, row[0:3])
        b = project_point(cam, width, height, row[3:6])
        if a is None or b is None:
            continue
        color = _BOUNCE_COLORS[min(i, len(_BOUNCE_COLORS) - 1)]
        draw_line(img, a[0], a[1], b[0], b[1], color)
    return img
