"""The slice through the cut path: the port's Renderer with TB_CUT=1
against the JAX package's Renderer under the same environment.

"shadertoy" at 32x18, render_sample(2) from a fresh state (one merged
wave of 2 samples per pixel). The JAX renderer runs its packed ("pallas")
backend, whose cut path is traverse_binned2 / anyhit_binned2 on every
closest-hit and shadow wave, in Pallas interpret mode (the JAX wave reads
TB_CUT when its module is imported, so the test sets that module flag
too). The port runs the same path through the kernels' plain twins on the
CPU. Tolerances are tests/test_torch_renderer.py's: accum |d| <= 1e-3
(1 + |ref|) on >= 99% of pixels and its mean to 1e-4 relative.
"""

import functools

import numpy as np
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.trace import binned, cut, kernels

torch.set_num_threads(2)

FILM = (32, 18)


def assert_accum_matches(acc, ref_acc):
    assert np.isfinite(acc).all() and acc[..., :3].mean() > 0
    close = (np.abs(acc - ref_acc) <= 1e-3 * (1 + np.abs(ref_acc))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref_acc.mean()) <= 1e-4 * abs(ref_acc.mean())


def jax_accum(monkeypatch, env):
    """The JAX renderer's accumulator after render_sample(2) on its packed
    backend under `env`, with the opt-in paths' kernels in interpret
    mode."""
    import tracerboy_tpu.trace.binned as jbinned
    import tracerboy_tpu.trace.cut as jcut
    import tracerboy_tpu.trace.wavefront as jwave
    from tracerboy_tpu import Renderer as JaxRenderer

    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(jwave, "_USE_CUT", env.get("TB_CUT") == "1")
    monkeypatch.setattr(jwave, "_PACKET_SUB", 8)
    for mod, name in ((jcut, "traverse_binned2"), (jcut, "anyhit_binned2"),
                      (jbinned, "binned_closest")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))
    ref = JaxRenderer("shadertoy", film_size=FILM)
    assert ref.traversal == "pallas"
    assert ref.wave_config().binned_bounces == (env.get("TB_BINNED") == "1")
    ref.render_sample(2)
    return np.asarray(ref.state.accum)


def port_accum(monkeypatch, env):
    for key in ("TB_CUT", "TB_BINNED", "TB_CUT_K", "TB_CUT_TRIS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    r = Renderer("shadertoy", film_size=FILM, device="cpu")
    cfg = r.wave_config()
    assert cfg.cut == (env.get("TB_CUT") == "1") and cfg.cut_k == 8
    assert cfg.binned_bounces == (env.get("TB_BINNED") == "1")
    kernels.reset_counters()
    cut.reset_stats()
    binned.reset_stats()
    r.render_sample(2)
    assert r.state.spp == 2
    return r.state.accum.numpy()


def test_cut_wave_matches_jax(monkeypatch):
    env = {"TB_CUT": "1"}
    acc = port_accum(monkeypatch, env)
    bounces = Renderer("shadertoy", film_size=FILM,
                       device="cpu").wave_config().max_bounces
    # Every closest-hit and shadow wave took the cut path: one emit each.
    assert kernels.TWIN_CALLS["emit"] == 2 * kernels.TWIN_CALLS["anyhit"]
    assert 2 <= kernels.TWIN_CALLS["emit"] <= 2 * bounces
    assert kernels.TWIN_CALLS["select"] == 0
    assert int(cut.STATS["rays"]) > 0
    assert_accum_matches(acc, jax_accum(monkeypatch, env))


def test_default_path_unchanged_without_the_env(monkeypatch):
    """Neither variable set: no cut or binned tables, and the wave takes
    the whole-tree kernels only."""
    acc = port_accum(monkeypatch, {})
    assert kernels.TWIN_CALLS["emit"] == kernels.TWIN_CALLS["select"] == 0
    r = Renderer("shadertoy", film_size=FILM, device="cpu")
    assert not any(k.startswith(("pk_cut", "pk_sh_cut", "bn_"))
                   for k in r.scene)
    cut_acc = port_accum(monkeypatch, {"TB_CUT": "1"})
    # Same hits up to ties: the cut path's image is the default's.
    assert_accum_matches(cut_acc, acc)
