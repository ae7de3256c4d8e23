"""Temporal accumulation of the port (post/temporal.py) against the JAX
package (tracerboy_tpu/post/temporal.py), on seeded planes.

The G-buffer is synthetic but shaped like a frame: a 48x36 view of a floor
with a raised block (a depth discontinuity), a sky band without geometry
(normal 0), world positions from the camera's own lens geometry, seeded
colours, histories and moments; the previous camera is the same (static)
or moved and turned.

temporal_accumulate: bilinear and Catmull-Rom history, static and moved
camera, with and without moments, and ignore_history; project_to_prev_uv
and generate_motion_vectors. Everything is float32. Tolerance: |d| <= 5e-5
(1 + |ref|) (5e-4 (1 + |ref|) for Catmull-Rom, whose 9 taps of cubic
weights carry more rounding) on at least 99.5% of pixels, all channels.
Relative to the value, and not 1e-5, because the tap weights come from
fx = uv * W - 0.5, which carries an absolute rounding of 4e-6 at x = 45
and more near the horizon, where world positions reach 60 units: the
bilinear blend of colours up to 2 and sample counts up to 40 moves by up
to 1.9e-5 (1 + |ref|) on 33 of 1,728 pixels (measured; Catmull-Rom
1.05e-4 on one). Under a static camera a pixel projects onto its own
centre, fx = x +- 4e-6: where that pixel's own tap is rejected, only taps
of weight ~1e-6 remain and their ratio is rounding noise (2 of 1,728
pixels, up to 1e-4 (1 + |ref|)). The share also because the validity tests
(dd < dist_tol^2, uv inside [0, 1], weight_sum > 0) and floor() are
discontinuous, so a one-ulp difference between XLA and PyTorch may flip a
pixel's tap. Motion vectors and uv: 1e-3 pixels on every valid pixel.
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.post import temporal

torch.set_num_threads(2)

H, W = 36, 48
LENS_H = 2.0
f32 = np.float32


def camera(position, look_at, focal_distance=2.4):
    position = np.asarray(position, f32)
    look_at = np.asarray(look_at, f32)
    view = look_at - position
    view = view / np.linalg.norm(view)
    right = np.cross(view, [0.0, 1.0, 0.0])
    right = right / np.linalg.norm(right)
    up = np.cross(right, view)
    return dict(position=position, look_at=(position + view).astype(f32),
                right=right.astype(f32), up=up.astype(f32),
                focal_distance=f32(focal_distance), lens_height=f32(LENS_H))


CAM = camera([0.0, 2.0, 6.0], [0.0, 0.5, 0.0])
CAM_MOVED = camera([0.35, 2.1, 5.8], [0.1, 0.45, 0.0])


def make_gbuffer(rng, cam=CAM, h=H, w=W):
    """world_pos (h, w, 4) with the neighbour distance, normals (h, w, 3):
    rays from the focal point through the lens rectangle onto the floor
    y = 0, a block of height 1 over |x| < 1, |z| < 1, sky above the
    horizon."""
    pos, view = cam["position"].astype(np.float64), None
    view = cam["look_at"].astype(np.float64) - pos
    focal = pos - float(cam["focal_distance"]) * view
    u = ((np.arange(w) + 0.5) / w * 2 - 1) * (LENS_H * w / h / 2)
    v = (1 - (np.arange(h) + 0.5) / h * 2) * (LENS_H / 2)
    lens = (pos + u[None, :, None] * cam["right"].astype(np.float64)
            + v[:, None, None] * cam["up"].astype(np.float64))
    d = lens - focal
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def plane(y):
        t = (y - focal[1]) / np.where(np.abs(d[..., 1]) > 1e-9, d[..., 1],
                                      1e-9)
        return t, focal + d * t[..., None]

    t0, p0 = plane(0.0)
    t1, p1 = plane(1.0)
    on_block = (t1 > 0) & (np.abs(p1[..., 0]) < 1) & (np.abs(p1[..., 2]) < 1)
    hit = on_block | ((t0 > 0) & (t0 < 60))
    p = np.where(on_block[..., None], p1, p0)
    p = p + rng.normal(0, 1e-3, p.shape)           # surface roughness
    p = np.where(hit[..., None], p, 0.0)
    n = np.where(hit[..., None], np.array([0.0, 1.0, 0.0]), 0.0)
    nxt = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    nd = np.where(hit, np.linalg.norm(nxt - p, axis=-1) + 1e-3, 0.0)
    wp = np.concatenate([p, nd[..., None]], axis=-1)
    return wp.astype(f32), n.astype(f32)


def make_inputs(seed, moved):
    rng = np.random.default_rng(seed)
    wp, n = make_gbuffer(rng)
    prev_wp, _ = make_gbuffer(rng, CAM_MOVED if moved else CAM)
    current = rng.random((H, W, 3), dtype=f32) * 2
    history = rng.random((H, W, 3), dtype=f32) * 2
    mu = rng.random((H, W), dtype=f32)
    moments = np.stack([mu, mu * mu + rng.random((H, W), dtype=f32) * 0.1,
                        rng.integers(1, 40, (H, W)).astype(f32)], -1)
    return dict(current=current, world_pos=wp, normals=n,
                prev_world_pos=prev_wp, history=history,
                moment_history=moments.astype(f32),
                cam_prev=CAM_MOVED if moved else CAM)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.asarray(x, f32))


def _share_close(got, ref, atol):
    ok = (np.abs(got - ref) <= atol * (1 + np.abs(ref))).reshape(
        H * W, -1).all(-1)
    return ok.mean()


@pytest.mark.parametrize("catmull", [False, True], ids=["bilinear",
                                                        "catmull"])
@pytest.mark.parametrize("moved", [False, True], ids=["static", "moved"])
@pytest.mark.parametrize("moments", [True, False], ids=["moments",
                                                        "plain"])
def test_temporal_accumulate_matches_jax(moved, catmull, moments):
    import jax.numpy as jnp

    from tracerboy_tpu.post.temporal import temporal_accumulate as jax_taa

    inp = make_inputs(11 + moved, moved)
    kw = dict(history_weight=0.9, output_moments=moments,
              catmull_rom=catmull)
    ref = jax_taa(*(jnp.asarray(inp[k]) for k in (
        "current", "world_pos", "normals", "prev_world_pos", "history",
        "moment_history")), {k: jnp.asarray(v)
                             for k, v in inp["cam_prev"].items()},
        LENS_H, **kw)
    t = _t(inp)
    got = temporal.temporal_accumulate(
        t["current"], t["world_pos"], t["normals"], t["prev_world_pos"],
        t["history"], t["moment_history"], t["cam_prev"], LENS_H, **kw)
    atol = 5e-4 if catmull else 5e-5
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        assert _share_close(g.numpy(), np.asarray(r), atol) >= 0.995
    # The history is used: with it the output differs from the input.
    blended = np.abs(got[0][..., :3].numpy() - inp["current"]).max(-1) > 1e-3
    assert 0.3 < blended.mean() < 1.0
    assert (got[0][..., :3].numpy()[inp["normals"].any(-1) == 0]
            == inp["current"][inp["normals"].any(-1) == 0]).all()
    if moments:
        count = got[1][..., 2].numpy()
        assert ((count > 1.5) == blended)[inp["normals"].any(-1)].mean() > 0.98


def test_ignore_history_matches_jax():
    import jax.numpy as jnp

    from tracerboy_tpu.post.temporal import temporal_accumulate as jax_taa

    inp = make_inputs(5, False)
    ref = jax_taa(*(jnp.asarray(inp[k]) for k in (
        "current", "world_pos", "normals", "prev_world_pos", "history",
        "moment_history")), {k: jnp.asarray(v)
                             for k, v in inp["cam_prev"].items()},
        LENS_H, ignore_history=True)
    t = _t(inp)
    got = temporal.temporal_accumulate(
        t["current"], t["world_pos"], t["normals"], t["prev_world_pos"],
        t["history"], t["moment_history"], t["cam_prev"], LENS_H,
        ignore_history=True)
    for g, r in zip(got, ref):
        assert _share_close(g.numpy(), np.asarray(r), 5e-5) >= 0.995
    np.testing.assert_array_equal(got[0][..., :3].numpy(), inp["current"])
    np.testing.assert_array_equal(got[1][..., 2].numpy(), 1.0)


@pytest.mark.parametrize("moved", [False, True], ids=["static", "moved"])
def test_projection_and_motion_vectors_match_jax(moved):
    import jax.numpy as jnp

    from tracerboy_tpu.post import temporal as jt

    rng = np.random.default_rng(3)
    wp, n = make_gbuffer(rng)
    prev = CAM_MOVED if moved else CAM
    jcam = {k: jnp.asarray(v) for k, v in prev.items()}
    uv_r, ok_r = jt.project_to_prev_uv(jnp.asarray(wp[..., :3]), jcam,
                                       LENS_H, W, H)
    uv_g, ok_g = temporal.project_to_prev_uv(_t(wp[..., :3]), _t(prev),
                                             LENS_H, W, H)
    hit = n.any(-1)
    agree = np.asarray(ok_r) == ok_g.numpy()
    assert agree[hit].mean() >= 0.995
    both = hit & np.asarray(ok_r) & ok_g.numpy()
    np.testing.assert_allclose(uv_g.numpy()[both], np.asarray(uv_r)[both],
                               atol=1e-3 / W)
    if not moved:
        # A static camera projects every pixel onto its own centre.
        px = uv_g.numpy()[both] * [W, H]
        yy, xx = np.nonzero(both)
        np.testing.assert_allclose(px, np.stack([xx, yy], 1) + 0.5,
                                   atol=0.05)
    mv_r = jt.generate_motion_vectors(
        jnp.asarray(wp), jcam, {k: jnp.asarray(v) for k, v in CAM.items()},
        LENS_H, W, H)
    mv_g = temporal.generate_motion_vectors(_t(wp), _t(prev), _t(CAM),
                                            LENS_H, W, H)
    assert mv_g.shape == (H, W, 2)
    np.testing.assert_allclose(mv_g.numpy()[both], np.asarray(mv_r)[both],
                               atol=1e-3)
    assert (np.abs(mv_g.numpy()[both]).max() > 1.0) == moved
