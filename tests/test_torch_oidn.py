"""The port's OIDN denoiser (ml/tza.py, ml/oidn.py, ml/finetune.py,
Renderer.denoise) against the JAX package's.

Weights are random (np.random.default_rng) and carried into both packages:
Flax variables for the JAX module, state_dict_from_flax for the port.
Tolerances:
- read_tza, load_params_npz, the 2x upsample, state_dict_from_flax:
  equal;
- OIDNUNet in float32 at 48x32 (3 and 9 input channels): 1e-4 absolute
  (the same convolutions in another summation order);
- OIDNUNet in bfloat16: both compute in bf16 from float32 weights, but
  XLA and oneDNN accumulate and round the bf16 convolutions at other
  places; the measured max |d| is BF16_BOUND of the output's scale;
- denoise_image at 20x36 (pad to 32x48 and crop): 1e-4 absolute;
- Renderer.denoise on "shadertoy:cornell" at 32x24, both models, both
  transfers, float32 networks, both renderers holding the same
  accumulator: 1e-4 (1 + |ref|) after the inverse transfer; the on-demand
  AOV sample of rt_ldr_alb_nrm (no wave kept yet) to 1e-3 (1 + |ref|) on
  >= 99% of pixels, tests/test_torch_renderer.py's bound.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.ml import oidn
from tracerboy_tpu_torch.ml.finetune import load_params_npz, reinhard_fwd, \
    reinhard_inv
from tracerboy_tpu_torch.ml.tza import read_tza

torch.set_num_threads(2)

NPZ = Path(__file__).resolve().parents[1] / "tracerboy_tpu" / "ml" / \
    "weights" / "rt_ldr_ft.npz"
# Measured max |d| / max |ref| of the bf16 UNets at 48x32 (oneDNN against
# XLA on the CPU): 0.95e-2 .. 1.1e-2 (3 channels) and 1.3e-2 .. 1.5e-2
# (9), by thread count; bound 3e-2.
BF16_BOUND = 3e-2


def random_flax_params(in_ch, seed):
    """Flax UNet variables (HWIO kernels) with He-scaled random weights."""
    rng = np.random.default_rng(seed)
    probe = oidn.OIDNUNet(in_channels=in_ch, dtype=torch.float32)
    params = {}
    for name, layer in probe.named_children():
        cout, cin = layer.weight.shape[:2]
        params[name] = dict(
            kernel=(rng.normal(size=(3, 3, cin, cout))
                    * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            bias=(rng.normal(size=cout) * 0.05).astype(np.float32))
    return {"params": params}


def port_unet(variables, dtype=torch.float32):
    return oidn.unet_from_state_dict(oidn.state_dict_from_flax(variables),
                                     dtype)


def jax_unet(variables, in_ch, dtype):
    import jax.numpy as jnp

    from tracerboy_tpu.ml.oidn import OIDNUNet

    return OIDNUNet(in_channels=in_ch, dtype=getattr(jnp, dtype)), {
        "params": {n: {k: jnp.asarray(v) for k, v in p.items()}
                   for n, p in variables["params"].items()}}


def _write_tza(path, tensors):
    """A .tza archive in the format of tracerboy_tpu/ml/tza.py:3-10."""
    blob = bytearray(struct.pack("<HBBQ", 0x41D7, 2, 0, 0))
    offsets = {}
    for name, (arr, _, code) in tensors.items():
        offsets[name] = len(blob)
        blob += arr.astype("<f4" if code == "f" else "<f2").tobytes()
    table = len(blob)
    blob += struct.pack("<I", len(tensors))
    for name, (arr, layout, code) in tensors.items():
        blob += struct.pack("<H", len(name)) + name.encode()
        blob += struct.pack("<B", arr.ndim)
        blob += struct.pack(f"<{arr.ndim}I", *arr.shape)
        blob += layout.encode() + code.encode()
        blob += struct.pack("<Q", offsets[name])
    struct.pack_into("<Q", blob, 4, table)
    path.write_bytes(bytes(blob))


def test_read_tza_matches_jax(tmp_path):
    from tracerboy_tpu.ml.tza import read_tza as jax_read_tza

    rng = np.random.default_rng(0)
    path = tmp_path / "tiny.tza"
    _write_tza(path, {
        "enc_conv0.weight": (rng.normal(size=(4, 3, 3, 3)), "oihw", "h"),
        "enc_conv0.bias": (rng.normal(size=4), "x", "f"),
    })
    got, want = read_tza(str(path)), jax_read_tza(str(path))
    assert set(got) == set(want) == {"enc_conv0.weight", "enc_conv0.bias"}
    for key in got:
        assert got[key][1] == want[key][1]
        assert got[key][0].dtype == np.float32
        np.testing.assert_array_equal(got[key][0], want[key][0])
    sd = oidn.params_from_tza(got)
    assert sd["enc_conv0.weight"].shape == (4, 3, 3, 3)


def test_upsample_picks_source_index_half():
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(1).random((1, 5, 3, 4), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 10, 6, 4), "nearest")
    got = oidn.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    j = np.arange(10)
    np.testing.assert_array_equal(np.asarray(want)[0, :, 0, 0],
                                  x[0, j // 2, 0, 0])


@pytest.mark.parametrize("in_ch", [3, 9])
def test_unet_matches_jax(in_ch):
    import jax.numpy as jnp

    variables = random_flax_params(in_ch, seed=in_ch)
    x = np.random.default_rng(2).random((1, 32, 48, in_ch), dtype=np.float32)
    sd = oidn.state_dict_from_flax(variables)
    np.testing.assert_array_equal(
        sd["dec_conv1a.weight"].numpy(),
        variables["params"]["dec_conv1a"]["kernel"].transpose(3, 2, 0, 1))
    for dtype in ("float32", "bfloat16"):
        jm, jv = jax_unet(variables, in_ch, dtype)
        want = np.asarray(jm.apply(jv, jnp.asarray(x)))
        got = port_unet(variables, getattr(torch, dtype))(
            torch.from_numpy(x)).detach().numpy()
        assert got.dtype == np.float32 and got.shape == (1, 32, 48, 3)
        err = np.abs(got - want).max()
        if dtype == "float32":
            assert err <= 1e-4, err
        else:
            assert err <= BF16_BOUND * np.abs(want).max(), (
                err, np.abs(want).max())


def test_denoise_image_pads_and_crops():
    import jax.numpy as jnp

    from tracerboy_tpu.ml.oidn import denoise_image as jax_denoise

    variables = random_flax_params(9, seed=4)
    rng = np.random.default_rng(5)
    color, albedo, normal = (rng.random((20, 36, 3), dtype=np.float32)
                             for _ in range(3))
    jm, jv = jax_unet(variables, 9, "float32")
    want = np.asarray(jax_denoise(jm, jv, jnp.asarray(color),
                                  albedo=jnp.asarray(albedo),
                                  normal=jnp.asarray(normal)))
    got = oidn.denoise_image(port_unet(variables), torch.from_numpy(color),
                             albedo=torch.from_numpy(albedo),
                             normal=torch.from_numpy(normal)).numpy()
    assert got.shape == want.shape == (20, 36, 3)
    assert got.min() >= 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_load_params_npz_matches_jax():
    from tracerboy_tpu.ml.finetune import load_params_npz as jax_load

    model = load_params_npz(str(NPZ))
    jm, jv = jax_load(str(NPZ))
    assert model.in_channels == jm.in_channels == 3
    assert model.dtype == torch.bfloat16
    sd = model.state_dict()
    assert len(sd) == 2 * len(jv["params"]) == 32
    for name, p in jv["params"].items():
        np.testing.assert_array_equal(
            sd[f"{name}.weight"].numpy(),
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(),
                                      np.asarray(p["bias"]))


def test_reinhard_transfer_matches_jax():
    from tracerboy_tpu.ml.finetune import reinhard_fwd as jfwd
    from tracerboy_tpu.ml.finetune import reinhard_inv as jinv

    x = np.random.default_rng(6).normal(size=(64, 3)).astype(np.float32) * 4
    y = reinhard_fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, jfwd(x), rtol=1e-6, atol=0)
    np.testing.assert_allclose(reinhard_inv(torch.from_numpy(y)).numpy(),
                               jinv(y), rtol=1e-5, atol=0)


def _patch_weights(monkeypatch):
    """Both packages' load_oidn return float32 networks with the same random
    weights: 3 input channels for rt_ldr, 9 for rt_ldr_alb_nrm."""
    def channels(path):
        return 9 if "alb_nrm" in path else 3

    variables = {c: random_flax_params(c, seed=10 + c) for c in (3, 9)}
    monkeypatch.setattr(
        "tracerboy_tpu.ml.oidn.load_oidn",
        lambda path: jax_unet(variables[channels(path)], channels(path),
                              "float32"))
    monkeypatch.setattr(
        "tracerboy_tpu_torch.ml.oidn.load_oidn",
        lambda path: port_unet(variables[channels(path)]))


def test_renderer_denoise_matches_jax(monkeypatch):
    import jax.numpy as jnp

    from tracerboy_tpu import Renderer as JaxRenderer

    _patch_weights(monkeypatch)
    film = (32, 24)
    ref = JaxRenderer("shadertoy:cornell", film_size=film)
    r = Renderer("shadertoy:cornell", film_size=film, device="cpu")
    # No wave kept yet: rt_ldr_alb_nrm renders its AOV sample on demand.
    on_demand = (r.denoise("rt_ldr_alb_nrm", archive="rt_ldr_alb_nrm.tza"),
                 ref.denoise("rt_ldr_alb_nrm"))
    assert r.state.spp == ref.state.spp == 0
    close = np.abs(on_demand[0] - on_demand[1]) <= 1e-3 * (
        1 + np.abs(on_demand[1]))
    assert close.all(-1).mean() >= 0.99
    ref.render_sample(2)
    r.render_sample(2)
    r.state.accum = torch.from_numpy(np.array(ref.state.accum))
    assert np.array_equal(np.asarray(ref.resolve_radiance()),
                          r.resolve_radiance().numpy())
    for model in ("rt_ldr", "rt_ldr_alb_nrm"):
        for transfer in ("reinhard", "clip"):
            got = r.denoise(model, transfer, archive=f"{model}.tza")
            want = ref.denoise(model, transfer)
            assert got.shape == want.shape == (film[1], film[0], 3)
            assert np.isfinite(got).all() and got.min() >= 0
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{model} {transfer}")
    assert not np.array_equal(r.denoise("rt_ldr", archive="rt_ldr.tza"),
                              np.asarray(jnp.asarray(r.resolve_radiance())))


def test_renderer_denoise_needs_the_archive_path():
    """The shipped .tza archives are not in the repository: denoise reads
    none by default and says what it needs."""
    r = Renderer("shadertoy:cornell", film_size=(16, 12), device="cpu")
    with pytest.raises(ValueError, match="rt_ldr_alb_nrm.tza"):
        r.denoise("rt_ldr_alb_nrm")
