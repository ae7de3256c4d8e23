"""The launch kinds that volumes and the adaptive burst give kernels 1 and
2, on the card, against their plain versions (traverse.closest_hit_plain,
traverse.anyhit_plain) on the same rays:

- a volume render: kernel 1's closest hits give the delta-tracking walk
  its segment ends; kernel 2 takes shadow rays from volume-scatter
  vertices in mid-air and the env-NEE shadow wave;
- the adaptive burst's residual wave, whose lanes repeat the
  high-variance pixels.

Hits equal, ids equal outside 1e-4 of the hit lanes, t to 1e-6 relative,
occlusion equal, no stack overflow. Every test is under the `cuda` marker
(skipped without a card). This module imports no jax, so that it runs on
the card's machine: `python -m pytest --noconftest -m cuda
tests/test_torch_volume_cuda.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch import renderer as renderer_mod
from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.scene.volume import procedural_cloud
from tracerboy_tpu_torch.trace import kernels, traverse


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _recording(calls, real, when=lambda: True):
    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        if when():
            calls.append((o.clone(), d.clone(), t_max.clone(), nodes,
                          tris_bw))
        return real(o, d, t_max, nodes, tris_bw, roots)
    return recording


def _assert_closest_equal(calls, real):
    kernels.reset_counters()
    for o, d, tm, nodes, tris in calls:
        t_k, tri_k, _, _ = real(o, d, tm, nodes, tris)
        t_p, tri_p, _, _ = traverse.closest_hit_plain(o, d, tm, nodes, tris)
        assert torch.equal(tri_k >= 0, tri_p >= 0)
        both = (tri_k >= 0) & (tri_p >= 0)
        if both.any():
            rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
            assert rel.max().item() <= 1e-6
            assert (tri_k != tri_p)[both].float().mean().item() <= 1e-4
    assert kernels.stack_overflows() == 0


@pytest.mark.cuda
def test_volume_launches_equal_their_plain_version(cuda_device,
                                                   monkeypatch):
    """A cloud in cornell under a seeded sky, environment NEE on, on the
    kernel path at 64x48, render_sample(2)."""
    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    sky = (0.2 + np.random.default_rng(3).random((8, 16, 3))).astype(
        np.float32)
    cs = dataclasses.replace(
        load_scene("shadertoy:cornell", film_size=(64, 48)), has_env=True,
        env_map=sky)
    r = Renderer(cs, volume=procedural_cloud(16), device="cuda")
    r.settings = r.settings.replace(performance_settings=dataclasses.replace(
        r.settings.performance_settings, environment_nee="on"))
    cfg = r.wave_config()
    assert r.traversal == "kernel" and cfg.has_volume and cfg.env_nee
    closest, anyhit = [], []
    real_c, real_a = traverse.closest_hit, traverse.any_hit
    monkeypatch.setattr(traverse, "closest_hit", _recording(closest, real_c))
    monkeypatch.setattr(traverse, "any_hit", _recording(anyhit, real_a))
    r.render_sample(2)
    monkeypatch.setattr(traverse, "closest_hit", real_c)
    monkeypatch.setattr(traverse, "any_hit", real_a)
    assert closest and anyhit
    assert torch.isfinite(r.state.accum).all()
    _assert_closest_equal(closest, real_c)
    for o, d, tm, nodes, tris in anyhit:
        assert torch.equal(real_a(o, d, tm, nodes, tris),
                           traverse.anyhit_plain(o, d, tm, nodes, tris))
    assert kernels.stack_overflows() == 0


@pytest.mark.cuda
def test_residual_wave_launches_equal_their_plain_version(cuda_device,
                                                          monkeypatch):
    """render_sample_adaptive(8) on shadertoy at 96x64: the counts sum to
    the budget, and the residual wave's closest hits equal the plain
    version's."""
    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    r = Renderer("shadertoy", film_size=(96, 64), device="cuda")
    assert r.traversal == "kernel"
    calls, residual = [], [False]
    real, real_wave = traverse.closest_hit, renderer_mod.render_wave

    def residual_wave(*args, **kwargs):
        residual[0] = True
        try:
            return real_wave(*args, **kwargs)
        finally:
            residual[0] = False

    monkeypatch.setattr(traverse, "closest_hit",
                        _recording(calls, real, lambda: residual[0]))
    monkeypatch.setattr(renderer_mod, "render_wave", residual_wave)
    r.render_sample_adaptive(8)
    monkeypatch.setattr(traverse, "closest_hit", real)
    assert int(r._last_adaptive_counts.sum()) == 4 * 96 * 64
    assert calls and r.state.spp == 8
    _assert_closest_equal(calls, real)
