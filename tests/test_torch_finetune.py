"""The training half of the port's ml/finetune.py against the JAX
package's: orbit views, the .npz weight and dataset files in both
directions, optax's schedule, Adam steps under autograd, the whole
finetune() and make_dataset() on the CPU.

Weights start from a Flax init (jax.random.PRNGKey(0)) carried into the
port by state_dict_from_flax. Tolerances:
- orbit_offsets, the .npz arrays both ways, the batch and flip draws:
  equal;
- the learning rate at every step: 1e-7 absolute of optax's;
- 3 Adam steps at 32x32, float32: the losses to 1e-4 relative, each
  gradient to 2e-4 of its layer's largest entry, the parameters to 2e-4
  absolute (measured: 1.8e-5, 5.2e-5, 5.4e-5; Adam steps a parameter by
  about lr = 1e-3 whatever the size of its gradient, so the tiny
  gradients' relative error shows in the parameters);
- the same in bfloat16: XLA and oneDNN round the bf16 convolutions at
  other places (tests/test_torch_oidn.py: ~1e-2 of the output's scale),
  so the losses to 2e-2 relative, each gradient to 0.1 of its layer's
  largest entry on >= 0.99 of its entries, the parameters within 4 lr a
  step (a gradient near 0 may take the other sign) and within 1e-4 on
  >= 0.9 of them (measured: 4.4e-3, 0.048, 3.3e-3, 0.944);
- finetune() on tests/test_finetune.py's 6-pair random dataset, 3 steps,
  batch 2: h0 and h1 to 1e-4 relative in float32 and 2e-2 in bf16, the
  saved float16 arrays as the parameters above, plus half a float16 ulp;
- make_dataset on "shadertoy" at 32x24, 2 views, 1 / 2 spp: keys, shapes,
  dtypes, view and meta equal; expo to 1e-4 relative; the radiance under
  tests/test_torch_renderer.py's rule (>= 0.99 of pixels within 1e-3
  (1 + |ref|), the mean to 1e-4 relative).
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.ml import finetune as ft
from tracerboy_tpu_torch.ml import oidn

torch.set_num_threads(2)

LR, STEPS = 1e-3, 3


def flax_init(dtype="float32"):
    """A Flax UNet (3 input channels) and its PRNGKey(0) variables."""
    import jax
    import jax.numpy as jnp

    from tracerboy_tpu.ml.oidn import OIDNUNet

    model = OIDNUNet(in_channels=3, dtype=getattr(jnp, dtype))
    return model, model.init(jax.random.PRNGKey(0),
                             np.zeros((1, 32, 32, 3), np.float32))


def port_net(variables, dtype="float32"):
    return oidn.unet_from_state_dict(oidn.state_dict_from_flax(
        {"params": {n: {k: np.asarray(v) for k, v in p.items()}
                    for n, p in variables["params"].items()}}),
        getattr(torch, dtype))


def hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


def test_orbit_offsets_match_jax():
    from tracerboy_tpu.ml.finetune import orbit_offsets

    for diag in (10.0, 3.7):
        want = orbit_offsets(64, diag, np.random.default_rng(0))
        got = ft.orbit_offsets(64, diag, np.random.default_rng(0))
        assert got == want


def test_params_npz_cross_both_ways(tmp_path):
    """The port's save_params_npz is read by the JAX load_params_npz, and
    the JAX save_params_npz by the port's: equal arrays."""
    from tracerboy_tpu.ml.finetune import load_params_npz as jax_load
    from tracerboy_tpu.ml.finetune import save_params_npz as jax_save

    _, variables = flax_init()
    net = port_net(variables)
    ft.save_params_npz(str(tmp_path / "port.npz"), net)
    jm, jv = jax_load(str(tmp_path / "port.npz"))
    assert jm.in_channels == 3
    assert set(jv["params"]) == {n for n, _ in net.named_children()}
    for name, layer in net.named_children():
        np.testing.assert_array_equal(
            np.asarray(jv["params"][name]["kernel"]),
            hwio(layer.weight).astype(np.float16).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(jv["params"][name]["bias"]),
            layer.bias.detach().numpy().astype(np.float16)
            .astype(np.float32))

    jax_save(str(tmp_path / "jax.npz"), variables["params"])
    back = ft.load_params_npz(str(tmp_path / "jax.npz"), torch.float32)
    sd = back.state_dict()
    for name, p in variables["params"].items():
        np.testing.assert_array_equal(
            hwio(sd[f"{name}.weight"]),
            np.asarray(p["kernel"]).astype(np.float16).astype(np.float32))
    # And the port's file round-trips through the port bit for bit.
    ft.save_params_npz(str(tmp_path / "again.npz"), back)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.float16
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("steps", [1, 7, 200])
def test_schedule_matches_optax(steps):
    import optax

    want = optax.cosine_decay_schedule(1e-4, steps)
    net = torch.nn.Linear(2, 2)
    opt, sched = ft.make_optimizer(net, 1e-4, steps)
    for t in range(steps + 3):
        assert abs(opt.param_groups[0]["lr"] - float(want(t))) <= 1e-7, t
        opt.step()
        sched.step()
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8


def _batches(n):
    rng = np.random.default_rng(7)
    return [(rng.random((2, 32, 32, 3), np.float32),
             rng.random((2, 32, 32, 3), np.float32)) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_steps_match_jax(dtype):
    """3 updates from the same Flax init, in both packages: the loss
    before each, each gradient, the parameters after each."""
    import jax
    import jax.numpy as jnp
    import optax

    model, variables = flax_init(dtype)
    params = variables["params"]
    opt_j = optax.adam(optax.cosine_decay_schedule(LR, STEPS))
    state = opt_j.init(params)

    def loss_fn(p, x, y):
        out = model.apply({"params": p}, x)
        return jnp.mean(jnp.square(out - y.astype(out.dtype)))

    step_j = jax.jit(jax.value_and_grad(loss_fn))

    net = port_net(variables, dtype)
    opt, sched = ft.make_optimizer(net, LR, STEPS)
    f32 = dtype == "float32"
    for i, (x, y) in enumerate(_batches(STEPS)):
        loss_j, grads = step_j(params, jnp.asarray(x), jnp.asarray(y))
        updates, state = opt_j.update(grads, state)
        params = optax.apply_updates(params, updates)
        loss = ft.train_step(net, opt, sched, torch.from_numpy(x),
                             torch.from_numpy(y))
        assert abs(float(loss) - float(loss_j)) <= (
            1e-4 if f32 else 2e-2) * float(loss_j)
        for name, layer in net.named_children():
            g_j = np.asarray(grads[name]["kernel"])
            scale = np.abs(g_j).max()
            d = np.abs(hwio(layer.weight.grad) - g_j)
            if f32:
                assert d.max() <= 2e-4 * scale, (i, name, d.max(), scale)
            else:
                assert (d <= 0.1 * scale).mean() >= 0.99, (i, name)
            p_j = np.asarray(params[name]["kernel"])
            dp = np.abs(hwio(layer.weight) - p_j)
            if f32:
                assert dp.max() <= 2e-4, (i, name, dp.max())
            else:
                assert dp.max() <= 4 * LR * (i + 1), (i, name, dp.max())
                assert (dp <= 1e-4).mean() >= 0.9, (i, name)


def _random_dataset(path):
    """tests/test_finetune.py's 6-pair random dataset."""
    rng = np.random.default_rng(1)
    clean = rng.random((6, 32, 32, 3), np.float32) * 0.5
    inp = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
    tgt = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    np.savez(path, inp=np.maximum(inp, 0).astype(np.float16),
             tgt=np.maximum(tgt, 0).astype(np.float16),
             expo=np.ones(6, np.float32),
             view=np.arange(6, dtype=np.int32),
             meta=np.asarray([8, 128], np.int32))


def test_net_space_matches_jax(tmp_path):
    from tracerboy_tpu.ml.finetune import _net_space as jax_net_space

    _random_dataset(tmp_path / "d.npz")
    with np.load(tmp_path / "d.npz") as d:
        lin, expo = d["inp"], d["expo"] * np.float32(3.5)
    got = ft._net_space(lin, expo).numpy()
    np.testing.assert_allclose(got, jax_net_space(lin, expo), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetune_matches_jax(tmp_path, monkeypatch, dtype):
    import tracerboy_tpu.ml.finetune as jft

    data = str(tmp_path / "d.npz")
    _random_dataset(data)
    model, variables = flax_init(dtype)
    monkeypatch.setattr("tracerboy_tpu.ml.oidn.load_oidn",
                        lambda path: (model, variables))
    net = port_net(variables, dtype)
    kw = dict(steps=STEPS, lr=LR, batch=2, holdout_views=2, log_every=1)
    jax_logs, logs = [], []
    h_j = jft.finetune(data, str(tmp_path / "j.npz"), init_tza="ignored",
                       progress=jax_logs.append, **kw)
    h = ft.finetune(data, str(tmp_path / "t.npz"), init_tza=net,
                    progress=logs.append, device="cpu", **kw)
    f32 = dtype == "float32"
    for a, b in zip(h, h_j):
        assert np.isfinite(a) and abs(a - b) <= (1e-4 if f32 else 2e-2) * b
    assert [m.split(" train")[0] for m in logs if m.startswith("step")] == \
        [m.split(" train")[0] for m in jax_logs if m.startswith("step")] == \
        [f"step {i}/{STEPS}" for i in (1, 2, 3)]
    assert "(4 train pairs)" in logs[0]
    # The model handed in is not trained; the saved weights are.
    sd0 = port_net(variables, dtype).state_dict()
    assert all(torch.equal(v, sd0[k]) for k, v in net.state_dict().items())
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        moved, near = 0, []
        for key in a.files:
            assert b[key].dtype == np.float16 and b[key].shape == a[key].shape
            d = np.abs(b[key].astype(np.float32) - a[key].astype(np.float32))
            # float16 storage adds half an ulp of the larger entries.
            half_ulp = np.abs(a[key].astype(np.float32)) * 2.0 ** -11
            if f32:
                assert (d <= 2e-4 + half_ulp).all(), key
            else:
                assert (d <= 4 * LR * STEPS + half_ulp).all(), key
                near.append((d <= 1e-4 + half_ulp).ravel())
            if key.endswith(".kernel"):
                moved += not np.array_equal(
                    b[key], np.asarray(variables["params"][key[:-7]]
                                       ["kernel"]).astype(np.float16))
        assert moved == 16
        assert f32 or np.concatenate(near).mean() >= 0.9


def test_make_dataset_matches_jax(tmp_path):
    from tracerboy_tpu.ml.finetune import make_dataset as jax_make

    kw = dict(film=(32, 24), n_views=2, input_spp=1, target_spp=2,
              inputs_per_view=2, seed=1, progress=lambda m: None)
    jax_make("shadertoy", str(tmp_path / "j.npz"), **kw)
    ft.make_dataset("shadertoy", str(tmp_path / "t.npz"), device="cpu", **kw)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "expo", "inp", "meta", "tgt", "view"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype and \
                a[key].shape == b[key].shape, key
        assert a["inp"].shape == (4, 24, 32, 3)
        np.testing.assert_array_equal(b["view"], a["view"])
        np.testing.assert_array_equal(b["meta"], a["meta"])
        np.testing.assert_allclose(b["expo"], a["expo"], rtol=1e-4, atol=0)
        for key in ("inp", "tgt"):
            got, ref = (z[key].astype(np.float32) for z in (b, a))
            assert np.isfinite(got).all() and got.mean() > 0
            close = (np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))).all(-1)
            assert close.mean() >= 0.99, (key, close.mean())
            assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())
        # Two inputs a view, each its own seed; one target a view.
        assert not np.array_equal(b["inp"][0], b["inp"][1])
        np.testing.assert_array_equal(b["tgt"][0], b["tgt"][1])
        assert not np.array_equal(b["tgt"][0], b["tgt"][2])
