"""Bezier curve tessellation into triangle tubes.

The capability of the reference's curve path (TracerBoy.cpp:1425-1524 +
Curves.cpp: cubic bezier -> 3-vert rings, 3 rings per curve, batches of
<=10 curves merged into one mesh). We tessellate each cubic segment into
`rings` cross-sections of `sides` vertices swept along the curve with a
rotation-minimizing frame, with linearly interpolated width — same
capability, cleaner construction.

A numpy copy of tracerboy_tpu/scene/curves.py.
"""

from __future__ import annotations

import numpy as np


def eval_cubic_bezier(p: np.ndarray, t: np.ndarray):
    """Evaluate cubic bezier (4, 3) at params (S,). Returns (pos, tangent)."""
    t = t[:, None]
    u = 1.0 - t
    pos = (
        u * u * u * p[0]
        + 3 * u * u * t * p[1]
        + 3 * u * t * t * p[2]
        + t * t * t * p[3]
    )
    tan = (
        3 * u * u * (p[1] - p[0])
        + 6 * u * t * (p[2] - p[1])
        + 3 * t * t * (p[3] - p[2])
    )
    return pos, tan


def tessellate_curve(
    control_points: np.ndarray,
    width0: float,
    width1: float,
    rings: int = 4,
    sides: int = 3,
):
    """Tessellate a chain of cubic bezier segments into a triangle tube.

    control_points: (4 + 3k, 3). Returns (positions (V,3), indices (T,3),
    normals (V,3)).
    """
    cp = np.asarray(control_points, np.float32)
    n_seg = max((cp.shape[0] - 1) // 3, 1)

    all_pos, all_tan, all_t = [], [], []
    for s in range(n_seg):
        seg = cp[3 * s : 3 * s + 4]
        if seg.shape[0] < 4:
            seg = np.concatenate([seg, np.repeat(seg[-1:], 4 - seg.shape[0], 0)])
        t = np.linspace(0.0, 1.0, rings, dtype=np.float32)
        if s > 0:
            t = t[1:]  # avoid duplicating the shared ring
        pos, tan = eval_cubic_bezier(seg, t)
        all_pos.append(pos)
        all_tan.append(tan)
        all_t.append((s + t) / n_seg)
    pos = np.concatenate(all_pos)
    tan = np.concatenate(all_tan)
    tglob = np.concatenate(all_t)
    R = pos.shape[0]

    # Rotation-minimizing frames via sequential projection.
    tan = tan / np.maximum(np.linalg.norm(tan, axis=1, keepdims=True), 1e-9)
    normals = np.zeros_like(tan)
    ref = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(tan[0], ref))) > 0.95:
        ref = np.array([1.0, 0.0, 0.0], np.float32)
    n = ref - tan[0] * np.dot(ref, tan[0])
    n /= np.linalg.norm(n)
    normals[0] = n
    for i in range(1, R):
        n = normals[i - 1] - tan[i] * np.dot(normals[i - 1], tan[i])
        ln = np.linalg.norm(n)
        normals[i] = n / ln if ln > 1e-9 else normals[i - 1]
    binormals = np.cross(tan, normals)

    widths = (width0 * (1 - tglob) + width1 * tglob) / 2.0  # radius

    ang = 2 * np.pi * np.arange(sides) / sides
    circ = np.stack([np.cos(ang), np.sin(ang)], axis=1)  # (sides, 2)

    verts = (
        pos[:, None, :]
        + normals[:, None, :] * (circ[None, :, 0:1] * widths[:, None, None])
        + binormals[:, None, :] * (circ[None, :, 1:2] * widths[:, None, None])
    ).reshape(R * sides, 3)
    vnormals = (
        normals[:, None, :] * circ[None, :, 0:1]
        + binormals[:, None, :] * circ[None, :, 1:2]
    ).reshape(R * sides, 3)

    tris = []
    for r in range(R - 1):
        for s in range(sides):
            a = r * sides + s
            b = r * sides + (s + 1) % sides
            c = (r + 1) * sides + s
            d = (r + 1) * sides + (s + 1) % sides
            tris.append((a, b, c))
            tris.append((b, d, c))
    return (
        verts.astype(np.float32),
        np.asarray(tris, np.int32),
        vnormals.astype(np.float32),
    )
