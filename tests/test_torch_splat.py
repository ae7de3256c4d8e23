"""The tent splat of the port (trace/wavefront.py: WaveConfig.filter_splat,
splat_fold_tent, render_wave_merged's fold; Renderer.render_sample's
merged path on every backend) against the JAX package.

- splat_fold_tent on seeded (k, H, W) planes against the JAX function:
  the same sums in the same order (over k first, then nine shifted adds,
  dy outer, dx inner), to one float32 rounding per add (rtol 1e-6); and
  against tests/test_splat.py's numpy loop over each sample's 2x2
  nearest pixel centres.
- Partition of unity (tests/test_splat.py's check): a constant field
  reconstructs to that constant everywhere, borders included.
- The merged filter_splat wave of estimator_pair (tests/test_torch_volume.py:
  shadertoy:cornell with a seeded sky and a cloud, brute force) against
  the JAX wave at k = 1 and k = 3: the tent planes, the filter weight and
  the box-folded radiance under tests/test_torch_volume.py's
  assert_close; render_sample(1) takes the merged path on brute force.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_splat import _numpy_splat
from test_torch_volume import assert_close, estimator_pair
from tracerboy_tpu.trace.wavefront import render_wave_merged as jax_merged
from tracerboy_tpu.trace.wavefront import splat_fold_tent as jax_fold
from tracerboy_tpu_torch.trace.wavefront import (
    render_wave_merged,
    splat_fold_tent,
)

torch.set_num_threads(2)


def _planes(k, H, W, seed):
    rng = np.random.default_rng(seed)
    rad = rng.uniform(0, 4, size=(3, k, H, W)).astype(np.float32)
    ju = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
    jv = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
    return rad, ju, jv


@pytest.mark.parametrize("k,H,W", [(1, 5, 4), (3, 6, 7), (8, 12, 16)])
def test_splat_fold_matches_jax(k, H, W):
    rad, ju, jv = _planes(k, H, W, seed=5 + k)
    want = jax_fold(*(jnp.asarray(c.reshape(-1)) for c in rad),
                    jnp.asarray(ju.reshape(-1)), jnp.asarray(jv.reshape(-1)),
                    W, H, k)
    got = splat_fold_tent(*(torch.from_numpy(c.reshape(-1)) for c in rad),
                          torch.from_numpy(ju.reshape(-1)),
                          torch.from_numpy(jv.reshape(-1)), W, H, k)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    ref_r, ref_fw = _numpy_splat(rad[0], ju, jv, W, H)
    np.testing.assert_allclose(got[0].numpy().reshape(H, W), ref_r,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy().reshape(H, W), ref_fw,
                               rtol=1e-5, atol=1e-5)


def test_partition_of_unity_constant_field():
    """A constant radiance field reconstructs to that constant after the
    filter-weight division, everywhere including the borders; away from
    them each pixel collects k on average."""
    rng = np.random.default_rng(9)
    k, H, W = 4, 8, 8
    C = 2.5
    rad = torch.full((k * H * W,), C)
    ju = torch.from_numpy(rng.uniform(0, 1, k * H * W).astype(np.float32))
    jv = torch.from_numpy(rng.uniform(0, 1, k * H * W).astype(np.float32))
    rr, gg, bb, fw = splat_fold_tent(rad, rad, rad, ju, jv, W, H, k)
    assert fw.min() > 0
    for c in (rr, gg, bb):
        np.testing.assert_allclose((c / fw).numpy(), C, rtol=1e-5)
    assert abs(fw.reshape(H, W)[2:-2, 2:-2].mean().item() - k) < 0.35
    # Each sample deposits weight 1: the film keeps k N less its border.
    assert k * H * W - 0.75 * k * (2 * H + 2 * W) < fw.sum() <= k * H * W


@pytest.fixture(scope="module")
def merged_pair():
    return estimator_pair(mis=True)


@pytest.mark.parametrize("k", [1, 3])
def test_merged_splat_wave_matches_jax(merged_pair, k):
    ref, r = merged_pair
    cfg, jcfg = r.wave_config(), ref.wave_config()
    assert cfg.filter_splat and jcfg.filter_splat
    N = r.width * r.height
    want = jax_merged(ref.scene_pytree, ref.frame_params(),
                      jnp.arange(N, dtype=jnp.int32), jnp.int32(4), k, jcfg)
    got = render_wave_merged(r.scene, r.frame_params(), r.pixel_ids, 4, k,
                             cfg)
    tent = np.stack([np.asarray(want["radiance_" + c]) for c in "rgb"], -1)
    assert_close(got["radiance_splat"].numpy(), tent)
    assert_close(got["filter_weight"].numpy(), want["filter_weight"])
    assert_close(got["radiance"].numpy(), want["radiance"])
    # The tent's weights: each sample deposits 1 on the film but for
    # what falls off its border.
    fw = got["filter_weight"].sum().item()
    W, H = r.width, r.height
    assert k * N - 0.75 * k * (2 * W + 2 * H) < fw <= k * N * (1 + 1e-6)


def test_render_sample_splats_on_brute_force(merged_pair):
    """render_sample(1) on brute force goes through the merged fold, as
    the JAX renderer's does (a wave of k = 1), and accumulates what the
    JAX renderer accumulates."""
    ref, r = merged_pair
    assert r.traversal == "brute"
    ref.invalidate_history()
    r.invalidate_history()
    ref.render_sample(1)
    r.render_sample(1)
    assert "radiance_splat" in r._last_aovs
    assert_close(r.state.accum.numpy(), ref.state.accum)


def test_splat_needs_a_full_film_and_no_demodulation(merged_pair):
    import dataclasses

    _, r = merged_pair
    cfg = r.wave_config()
    with pytest.raises(ValueError, match="full-film"):
        render_wave_merged(r.scene, r.frame_params(), r.pixel_ids[:10], 0,
                           2, cfg)
    with pytest.raises(ValueError, match="demodulated"):
        render_wave_merged(r.scene, r.frame_params(), r.pixel_ids, 0, 2,
                           dataclasses.replace(cfg, decouple_albedo=True))
