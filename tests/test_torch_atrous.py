"""The a-trous wavelet filter of the port (post/denoise.py) against the
JAX package (tracerboy_tpu/post/denoise.py), on seeded planes over
tests/test_torch_temporal.py's synthetic G-buffer (a floor, a raised
block, a sky band without geometry).

atrous_iteration at steps 1, 2, 4 and 8, with the default weights and with
others, and denoise (4 iterations). Float32; tolerance |d| <= 1e-5
(1 + |ref|) on at least 99.9% of pixels, all four channels: the weights
are smooth (exp, pow), so no pixel can flip, but pow(ndot, 128) and the
exponentials differ in the last bits between XLA and PyTorch and the
filter sums 25 taps (the share covers a stray pixel; none was measured).
"""

import numpy as np
import pytest
import torch

from test_torch_temporal import H, W, make_gbuffer
from tracerboy_tpu_torch.post import denoise as pd

torch.set_num_threads(2)

f32 = np.float32


def make_planes(seed):
    rng = np.random.default_rng(seed)
    wp, n = make_gbuffer(rng)
    # Normals that vary a little, still unit length, 0 in the sky.
    tilt = rng.normal(0, 0.05, (H, W, 3))
    nn = n + tilt * n.any(-1, keepdims=True)
    nn = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-12)
    base = rng.random((H, W, 3), dtype=f32)
    noisy = np.clip(base + rng.normal(0, 0.2, (H, W, 3)), 0, None)
    var = rng.random((H, W, 1), dtype=f32) * 0.05
    color_var = np.concatenate([noisy, var], -1)
    return (color_var.astype(f32), noisy.astype(f32), nn.astype(f32),
            wp.astype(f32))


def _assert_close(got, ref):
    g, r = got.numpy(), np.asarray(ref)
    assert g.shape == r.shape == (H, W, 4)
    ok = (np.abs(g - r) <= 1e-5 * (1 + np.abs(r))).all(-1)
    assert ok.mean() >= 0.999, ok.mean()


@pytest.mark.parametrize("weights", [
    {}, dict(luma_weight_mult=1.5, normal_exp=32.0,
             position_weight_mult=3.0)], ids=["default", "other"])
@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_atrous_iteration_matches_jax(step, weights):
    import jax.numpy as jnp

    from tracerboy_tpu.post.denoise import atrous_iteration as jax_atrous

    planes = make_planes(7 + step)
    ref = jax_atrous(*(jnp.asarray(p) for p in planes), step=step, **weights)
    got = pd.atrous_iteration(*(torch.from_numpy(p) for p in planes),
                              step=step, **weights)
    _assert_close(got, ref)
    sky = ~planes[2].any(-1)
    assert sky.any()
    np.testing.assert_array_equal(got.numpy()[sky], planes[0][sky])
    # It filters: the colour moves, and the variance falls on geometry.
    assert np.abs(got.numpy()[~sky, :3] - planes[0][~sky, :3]).mean() > 1e-2
    assert got.numpy()[~sky, 3].mean() < planes[0][~sky, 3].mean()


@pytest.mark.parametrize("iterations", [1, 4])
def test_denoise_matches_jax(iterations):
    import jax.numpy as jnp

    from tracerboy_tpu.post.denoise import denoise as jax_denoise

    planes = make_planes(21)
    ref = jax_denoise(*(jnp.asarray(p) for p in planes),
                      iterations=iterations)
    got = pd.denoise(*(torch.from_numpy(p) for p in planes),
                     iterations=iterations)
    _assert_close(got, ref)


def test_denoise_smooths_a_flat_region():
    """On the floor, away from the block, the filtered colour of a
    constant signal plus noise lies closer to the signal."""
    rng = np.random.default_rng(4)
    wp, n = make_gbuffer(rng)
    signal = np.full((H, W, 3), 0.5, f32)
    noisy = (signal + rng.normal(0, 0.1, (H, W, 3))).astype(f32)
    cv = np.concatenate([noisy, np.full((H, W, 1), 0.01, f32)], -1)
    out = pd.denoise(torch.from_numpy(cv), torch.from_numpy(noisy),
                     torch.from_numpy(n), torch.from_numpy(wp)).numpy()
    floor = np.zeros((H, W), bool)
    floor[28:, :] = True
    before = np.abs(noisy[floor] - 0.5).mean()
    after = np.abs(out[floor, :3] - 0.5).mean()
    assert after < 0.8 * before
