"""Bit-exactness of the port's counter-based randoms (core/rng.py) against
the JAX package on a grid of (lane, sample, bounce, stream, seed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracerboy_tpu.core import rng as jrng
from tracerboy_tpu_torch.core import rng as trng

torch.set_num_threads(2)

LANES = np.concatenate([np.arange(64), [921_599, 2**24 + 3, 2**31 - 1]])
GRID = [
    (sample, bounce, stream, seed)
    for sample in (0, 1, 7, 1000, 2**20 + 5)
    for bounce in (0, 1, 5, 31)
    for stream in (0, 2, 9, 50, 64, 79)
    for seed in (0, 3, 12345)
]


def _same(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_uniform2_soa_exact_on_grid(sampler):
    lanes_j = jnp.asarray(LANES.astype(np.int32))
    lanes_t = torch.from_numpy(LANES.astype(np.int64))
    for sample, bounce, stream, seed in GRID:
        ju, jv = jrng.uniform2_soa(lanes_j, sample, bounce, stream, seed,
                                   sampler)
        tu, tv = trng.uniform2_soa(lanes_t, sample, bounce, stream, seed,
                                   sampler)
        _same(ju, tu)
        _same(jv, tv)


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_per_lane_sample_indices_exact(sampler):
    """Merged waves pass one sample index per lane."""
    rng = np.random.default_rng(5)
    lanes = rng.integers(0, 2**31 - 1, 4096)
    samples = rng.integers(0, 2**24, 4096)
    for bounce, stream, seed in ((0, 2, 0), (3, 8, 7), (6, 64, 99)):
        j = jrng.uniform(jnp.asarray(lanes.astype(np.int32)),
                         jnp.asarray(samples.astype(np.int32)), bounce,
                         stream, seed, sampler)
        t = trng.uniform(torch.from_numpy(lanes), torch.from_numpy(samples),
                         bounce, stream, seed, sampler)
        _same(j, t)


def test_pcg3d_and_pcg4d_exact():
    rng = np.random.default_rng(9)
    v = rng.integers(0, 2**32, (1000, 4), dtype=np.uint64).astype(np.uint32)
    j3 = np.asarray(jrng.pcg3d(jnp.asarray(v[:, :3])))
    j4 = np.asarray(jrng.pcg4d(jnp.asarray(v)))
    cols = [torch.from_numpy(v[:, k].astype(np.int64)) for k in range(4)]
    t3 = trng.pcg3d(*cols[:3])
    t4 = trng.pcg4d(*cols)
    for k in range(3):
        np.testing.assert_array_equal(j3[:, k].astype(np.int64),
                                      t3[k].numpy())
    for k in range(4):
        np.testing.assert_array_equal(j4[:, k].astype(np.int64),
                                      t4[k].numpy())


@pytest.mark.parametrize("base", [2, 3, 5])
def test_halton_exact(base):
    idx = np.concatenate([np.arange(300), [4095, 65537, 10**6, 2**30]])
    j = jrng.halton(base, jnp.asarray(idx.astype(np.int32)))
    t = trng.halton(base, torch.from_numpy(idx))
    _same(j, t)


def test_halton23_exact_scalar_and_vector():
    for i in (0, 1, 2, 17, 1023, 10**5):
        _same(jrng.halton23(jnp.int32(i)), trng.halton23(torch.tensor(i)))
    idx = np.arange(0, 5000, 7)
    _same(jrng.halton23(jnp.asarray(idx.astype(np.int32))),
          trng.halton23(torch.from_numpy(idx)))
