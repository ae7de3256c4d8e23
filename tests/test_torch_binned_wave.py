"""The slice through the binned path: the port's Renderer with
TB_BINNED=1 (and with both TB_BINNED=1 and TB_CUT=1) against the JAX
package's Renderer under the same environment.

As tests/test_torch_cut_wave.py: "shadertoy" at 32x18, render_sample(2)
from a fresh state, the JAX renderer on its packed backend with the
opt-in kernels in Pallas interpret mode, the port on its twins, and
tests/test_torch_renderer.py's tolerances. With TB_BINNED=1 the bounce
waves (all closest-hit waves after the primary one) take binned_closest;
with both variables the primary and shadow waves take the cut path.
"""

import torch

from test_torch_cut_wave import (
    FILM,
    assert_accum_matches,
    jax_accum,
    port_accum,
)
from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.trace import binned, cut, kernels

torch.set_num_threads(2)


def test_binned_wave_matches_jax(monkeypatch):
    env = {"TB_BINNED": "1"}
    acc = port_accum(monkeypatch, env)
    bounces = Renderer("shadertoy", film_size=FILM,
                       device="cpu").wave_config().max_bounces
    # The primary wave on the whole-tree kernel, each bounce wave binned
    # (one selection and two dense chunks), its fallback on the kernel.
    assert kernels.TWIN_CALLS["select"] == bounces - 1
    assert kernels.TWIN_CALLS["dense"] == 2 * (bounces - 1)
    assert kernels.TWIN_CALLS["closest"] == bounces
    assert kernels.TWIN_CALLS["emit"] == 0
    assert int(binned.STATS["rays"]) > 0
    assert_accum_matches(acc, jax_accum(monkeypatch, env))


def test_binned_and_cut_together_split_the_waves(monkeypatch):
    """Both variables: binned takes the bounce waves, cut the primary and
    the shadow waves (the JAX package's precedence). The hits are the
    same up to ties, so the image is the binned path's alone."""
    alone = port_accum(monkeypatch, {"TB_BINNED": "1"})
    acc = port_accum(monkeypatch, {"TB_BINNED": "1", "TB_CUT": "1"})
    bounces = Renderer("shadertoy", film_size=FILM,
                       device="cpu").wave_config().max_bounces
    assert kernels.TWIN_CALLS["select"] == bounces - 1
    assert kernels.TWIN_CALLS["emit"] == 1 + kernels.TWIN_CALLS["anyhit"]
    assert int(cut.STATS["rays"]) > 0 and int(binned.STATS["rays"]) > 0
    assert_accum_matches(acc, alone)
