"""The port's upscalers (ml/fsr.py, ml/superres.py) against the JAX
package's, on seeded numpy inputs on the CPU.

Tolerances:
- easu_upscale, rcas_sharpen, fsr_upscale: 4e-6 absolute. The sample
  positions, taps and sums are the JAX function's in the same order, but
  XLA contracts the multiply-adds of the Catmull-Rom weights and the
  16-tap sum into fused multiply-adds (a weight differs by 6e-8), and
  the sum of 16 taps of values up to 1 carries those roundings: the
  measured max is 1.85e-6 (24x36 -> 37x53). Inputs hold exact 0 and 1
  and values an ulp from them, where RCAS's limiter switches. Where a
  pixel and its four neighbours are all exactly 1, the JAX RCAS divides
  0 by 0 (ROADMAP.md, Queue 3): NaN there in both packages, and
  nowhere else.
- read_weights_bin: equal arrays (bit for bit); load_superres's folding
  and state_dict_from_superres: equal to the JAX package's folded HWIO
  kernels, transposed.
- upscale2x (bf16 network): >= 0.99 of pixels within 1/255, max |d|
  <= 2^-8 (a bf16 rounding that falls the other way where the float32
  sums differ in their last bit; measured 2^-10), and >= 0.75 of the
  output values bit-equal to the JAX package's (measured 0.92 and 0.99
  on these weights, at 1, 2 and 4 threads; the residual's base taken
  from the float32 input instead of the bf16-rounded one gives 0.05,
  the bias added after the bf16 rounding 0.17).
"""

import struct

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.ml import fsr, superres

torch.set_num_threads(2)

FSR_ATOL = 4e-6


def fsr_input(h, w, seed):
    """Random colours with rows of exact 0 and 1 and values an ulp from
    them."""
    img = np.random.default_rng(seed).random((h, w, 3), np.float32)
    img[0, : w // 2] = 0.0
    img[1, : w // 2] = 1.0
    img[2, : w // 2] = np.float32(1e-7)
    img[3, : w // 2] = np.nextafter(np.float32(1), np.float32(0))
    img[5:9, 3:7] = 1.0        # a bright block: RCAS's limiter at work
    return img


@pytest.mark.parametrize("src,dst", [((24, 36), (48, 72)),
                                     ((24, 36), (37, 53)),
                                     ((17, 9), (40, 21))])
def test_easu_matches_jax(src, dst):
    import jax.numpy as jnp

    from tracerboy_tpu.ml.fsr import easu_upscale

    img = fsr_input(*src, seed=sum(dst))
    want = np.asarray(easu_upscale(jnp.asarray(img), *dst))
    got = fsr.easu_upscale(torch.from_numpy(img), *dst).numpy()
    assert got.shape == want.shape == (*dst, 3)
    assert got.dtype == np.float32 and got.min() >= 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FSR_ATOL)


@pytest.mark.parametrize("sharpness", [0.87, 0.2])
def test_rcas_matches_jax(sharpness):
    import jax.numpy as jnp

    from tracerboy_tpu.ml.fsr import rcas_sharpen

    img = fsr_input(24, 36, seed=3)
    want = np.asarray(rcas_sharpen(jnp.asarray(img), sharpness))
    got = fsr.rcas_sharpen(torch.from_numpy(img), sharpness).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FSR_ATOL)
    # The neighbours wrap around the edges, as jnp.roll's do: an edge
    # pixel sees the opposite edge.
    edge = np.zeros((8, 8, 3), np.float32)
    edge[-1] = 1.0
    out = fsr.rcas_sharpen(torch.from_numpy(edge), sharpness).numpy()
    np.testing.assert_allclose(
        out, np.asarray(rcas_sharpen(jnp.asarray(edge), sharpness)),
        rtol=0, atol=FSR_ATOL)


@pytest.mark.parametrize("scale", [2.0, 1.5, 1.37])
def test_fsr_upscale_matches_jax(scale):
    import jax.numpy as jnp

    from tracerboy_tpu.ml.fsr import fsr_upscale

    img = fsr_input(24, 36, seed=int(scale * 100))
    want = np.asarray(fsr_upscale(jnp.asarray(img), scale))
    got = fsr.fsr_upscale(torch.from_numpy(img), scale).numpy()
    assert got.shape == want.shape == (int(24 * scale), int(36 * scale), 3)
    assert np.nanmin(got) >= 0 and np.nanmax(got) <= 1
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=FSR_ATOL)


def saturated_plateau(img):
    """Where a pixel and its four wrapped neighbours are all exactly 1."""
    one = img == 1.0
    return (one & np.roll(one, 1, 0) & np.roll(one, -1, 0)
            & np.roll(one, 1, 1) & np.roll(one, -1, 1))


def test_rcas_is_nan_on_saturated_plateaus_as_in_jax():
    """The reference's fault, kept for parity: hit_max = (1 - mx) /
    max(4 mn - 4, -1e4) is 0 / 0 where mn = mx = 1, and NaN passes
    through the clamps; everywhere else the output is in [0, 1]."""
    import jax.numpy as jnp

    from tracerboy_tpu.ml.fsr import rcas_sharpen

    img = np.ones((6, 7, 3), np.float32)
    img[0, 0] = 0.5
    img[3, 4, 1] = np.nextafter(np.float32(1), np.float32(0))
    want = np.asarray(rcas_sharpen(jnp.asarray(img)))
    got = fsr.rcas_sharpen(torch.from_numpy(img)).numpy()
    plateau = saturated_plateau(img)
    assert plateau.any() and not plateau.all()
    np.testing.assert_array_equal(np.isnan(want), plateau)
    np.testing.assert_array_equal(np.isnan(got), plateau)
    np.testing.assert_allclose(got, want, rtol=0, atol=FSR_ATOL)
    assert got[~plateau].min() >= 0 and got[~plateau].max() <= 1


def test_catmull_rom_weights_sum_to_one():
    t = torch.linspace(0, 1, 101)
    w = fsr._catmull_rom_weights(t)
    np.testing.assert_allclose(sum(w).numpy(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# The super-resolution network
# ---------------------------------------------------------------------------

BN_LAYERS = ("conv1", "conv3", "conv_up1/conv", "conv5")


def write_weights_bin(path, seed, bn_layers=BN_LAYERS):
    """A weights.bin (DirectMLSuperResolution.cpp:93-145's format) of
    He-scaled random kernels; BatchNorm scale and shift for bn_layers
    only. Returns the tensors written."""
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, k, cin, cout, _relu, _up in superres._LAYERS:
        gain = 0.3 if name == "conv6" else 1.0
        tensors[f"{name}/weights"] = (
            rng.normal(size=k * k * cin * cout) * gain
            * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        if name in bn_layers:
            tensors[f"{name}/BatchNorm/scale"] = rng.uniform(
                0.5, 1.5, cout).astype(np.float32)
            tensors[f"{name}/BatchNorm/shift"] = (
                rng.normal(size=cout) * 0.05).astype(np.float32)
    blob = bytearray(struct.pack("<i", len(tensors)))
    for name, arr in tensors.items():
        raw = name.encode("ascii")
        blob += struct.pack("<I", len(raw)) + raw
        blob += struct.pack("<I", arr.size) + arr.astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return tensors


def test_read_weights_bin_matches_jax(tmp_path):
    from tracerboy_tpu.ml.superres import read_weights_bin

    path = str(tmp_path / "weights.bin")
    written = write_weights_bin(path, seed=1)
    got, want = superres.read_weights_bin(path), read_weights_bin(path)
    assert list(got) == list(want) == list(written)
    for key, arr in got.items():
        assert arr.dtype == want[key].dtype == np.float32
        assert arr.tobytes() == want[key].tobytes() == written[key].tobytes()


def test_load_superres_folds_as_jax(tmp_path):
    from tracerboy_tpu.ml.superres import load_superres

    path = str(tmp_path / "weights.bin")
    write_weights_bin(path, seed=2)
    params = load_superres(path)
    net = superres.load_superres(path)
    sd = net.state_dict()
    assert sd.keys() == superres.state_dict_from_superres(params).keys()
    for name, (w, b) in params.items():
        key = name.replace("/", "_")
        np.testing.assert_array_equal(
            sd[f"{key}.weight"].numpy(),
            np.asarray(w).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{key}.bias"].numpy(),
                                      np.asarray(b))
        if name not in BN_LAYERS:
            assert not sd[f"{key}.bias"].any()
    assert sd["conv_up1_conv.weight"].shape == (32, 64, 5, 5)


@pytest.mark.parametrize("h,w", [(16, 16), (24, 40)])
def test_upscale2x_matches_jax(tmp_path, h, w):
    import jax.numpy as jnp

    from tracerboy_tpu.ml.superres import load_superres, upscale2x

    path = str(tmp_path / "weights.bin")
    write_weights_bin(path, seed=3)
    img = np.random.default_rng(h * w).random((h, w, 3), np.float32)
    want = np.asarray(upscale2x(load_superres(path), jnp.asarray(img)))
    got = superres.upscale2x(superres.load_superres(path),
                             torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2 * h, 2 * w, 3)
    assert got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    d = np.abs(got - want)
    assert (d <= 1 / 255).all(-1).mean() >= 0.99
    assert d.max() <= 2.0 ** -8
    assert (d == 0).mean() >= 0.75
    # The network does more than the nearest upsample it adds to.
    base = np.repeat(np.repeat(img, 2, 0), 2, 1)
    assert np.abs(got - base).mean() > 1e-2
