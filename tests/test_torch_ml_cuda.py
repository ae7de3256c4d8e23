"""The ML extras on the card against the same calls on the CPU: one
fine-tune step (ml/finetune.py train_step under autograd, from the
committed rt_ldr_ft.npz weights) and both upscalers (ml/fsr.py,
ml/superres.py).

Tolerances:
- the training step in float32 (cuDNN against oneDNN, TF32 off): the loss
  to 1e-4 relative, each gradient to 1e-3 of its layer's largest entry;
  Adam's first step is lr g / (|g| + eps), about lr = 1e-3 whatever |g|,
  so a gradient near 0 may step the other way: the parameters within
  2 lr, and within 2e-4 on >= 0.999 of them (the card's first run:
  2.7e-4 at most);
- in bfloat16: the loss to 2e-2 relative, each gradient to 0.1 of its
  layer's largest entry on >= 0.99 of its entries, the parameters within
  2 lr (a gradient near 0 may take the other sign), as
  tests/test_torch_finetune.py holds the port against JAX;
- fsr_upscale: 4e-6 absolute (tests/test_torch_upscale.py's bound;
  the card contracts multiply-adds as XLA does), NaN at the same pixels;
- upscale2x: >= 0.99 of pixels within 1/255, max |d| <= 1/64.

Every test is under the `cuda` marker (skipped without a card). This
module imports no jax, so that it runs on the card's machine: `python -m
pytest --noconftest -m cuda tests/test_torch_ml_cuda.py`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.ml import finetune as ft
from tracerboy_tpu_torch.ml import fsr, superres

NPZ = Path(__file__).resolve().parents[1] / "tracerboy_tpu" / "ml" / \
    "weights" / "rt_ldr_ft.npz"
LR = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _one_step(net, x, y):
    opt, sched = ft.make_optimizer(net, LR, 10)
    loss = ft.train_step(net, opt, sched, x, y)
    return float(loss), {n: (m.weight.grad.float().cpu(), m.weight.detach()
                             .float().cpu())
                         for n, m in net.named_children()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_matches_the_cpu(cuda_device, dtype):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((2, 64, 96, 3), np.float32))
    y = torch.from_numpy(rng.random((2, 64, 96, 3), np.float32))
    loss_c, cpu = _one_step(ft.load_params_npz(str(NPZ), dtype), x, y)
    loss_g, gpu = _one_step(ft.load_params_npz(str(NPZ), dtype)
                            .to(cuda_device), x.to(cuda_device),
                            y.to(cuda_device))
    f32 = dtype == torch.float32
    assert np.isfinite(loss_g)
    assert abs(loss_g - loss_c) <= (1e-4 if f32 else 2e-2) * loss_c
    near = []
    for name, (g_c, p_c) in cpu.items():
        g_g, p_g = gpu[name]
        scale = g_c.abs().max().item()
        d = (g_g - g_c).abs()
        if f32:
            assert d.max().item() <= 1e-3 * scale, name
        else:
            assert (d <= 0.1 * scale).float().mean().item() >= 0.99, name
        dp = (p_g - p_c).abs()
        assert dp.max().item() <= 2 * LR, name
        near.append((dp <= 2e-4).flatten())
    assert not f32 or torch.cat(near).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_fsr_upscale_matches_the_cpu(cuda_device):
    from test_torch_upscale import fsr_input

    img = torch.from_numpy(fsr_input(90, 160, seed=5))
    want = fsr.fsr_upscale(img).numpy()
    got = fsr.fsr_upscale(img.to(cuda_device)).cpu().numpy()
    assert got.shape == (180, 320, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


@pytest.mark.cuda
def test_upscale2x_matches_the_cpu(cuda_device, tmp_path):
    from test_torch_upscale import write_weights_bin

    path = str(tmp_path / "weights.bin")
    write_weights_bin(path, seed=6)
    img = torch.from_numpy(
        np.random.default_rng(7).random((72, 128, 3), np.float32))
    net = superres.load_superres(path)
    want = superres.upscale2x(net, img).numpy()
    got = superres.upscale2x(net.to(cuda_device), img.to(cuda_device))
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    assert got.shape == (144, 256, 3) and np.isfinite(got).all()
    d = np.abs(got - want)
    assert (d <= 1 / 255).all(-1).mean() >= 0.99
    assert d.max() <= 1 / 64
