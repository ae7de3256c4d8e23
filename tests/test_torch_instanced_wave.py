"""The wave on a TLAS scene: the port's Renderer against the JAX
package's, on tests/test_torch_instanced.py's small two-object scene (a
ball object instanced 3 times, 2 of them in the same place, and an
emissive panel instanced once: KI = 4 instances, so one round of BLAS
launches a pass) at 16x12 with 2 bounces, render_sample(1) from a fresh
state.

The JAX renderer takes its packed ("pallas") backend, as it does for every
TLAS scene, with the kernels in Pallas interpret mode; the port takes the
kernel path on the CPU, the plain twins. Tolerances are
tests/test_torch_renderer.py's: accum |d| <= 1e-3 (1 + |ref|) on >= 99% of
pixels and its mean to 1e-4 relative.
"""

import dataclasses

import numpy as np
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene.compile import compile_scene
from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
from tracerboy_tpu_torch.trace import instanced, kernels
from test_torch_instanced import write
from test_torch_cut_wave import assert_accum_matches

torch.set_num_threads(2)

FILM = (16, 12)
BOUNCES = 2


def with_bounces(settings):
    return settings.replace(performance_settings=dataclasses.replace(
        settings.performance_settings, max_bounces=BOUNCES))


def test_tlas_wave_matches_jax(tmp_path, monkeypatch):
    import tracerboy_tpu.trace.wavefront as jwave
    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.scene.compile import compile_scene as jax_compile
    from tracerboy_tpu.scene.pbrt_parser import parse_pbrt as jax_parse
    from tracerboy_tpu.utils.config import default_output_settings

    path = write(tmp_path, "two_objects_small")
    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    monkeypatch.setattr(jwave, "_PACKET_SUB", 8)
    ref = JaxRenderer(jax_compile(jax_parse(path), instancing="tlas"),
                      settings=with_bounces(default_output_settings()),
                      film_size=FILM)
    assert ref.traversal == "pallas" and ref.wave_config().has_instances
    ref.render_sample(1)
    ref_acc = np.asarray(ref.state.accum)

    monkeypatch.delenv("TB_TRAVERSAL")
    r = Renderer(compile_scene(parse_pbrt(path), instancing="tlas"),
                 film_size=FILM, device="cpu")
    r.settings = with_bounces(r.settings)
    cfg = r.wave_config()
    assert r.traversal == "kernel" and cfg.has_instances
    assert cfg.max_bounces == BOUNCES and cfg.num_lights == 2
    kernels.reset_counters()
    r.render_sample(1)
    # Each bounce: a flat closest-hit wave and one BLAS launch an object a
    # round (one round: KI instances), and its NEE shadow wave (any hit)
    # with the instanced occluders' BLAS launches.
    n_inst = r.scene["inst_obj"].shape[0]
    assert n_inst == instanced.KI
    per_pass = len(r.scene["inst_objs"])
    assert kernels.TWIN_CALLS["closest"] == BOUNCES * (1 + 2 * per_pass)
    assert kernels.TWIN_CALLS["anyhit"] == BOUNCES
    assert_accum_matches(r.state.accum.numpy(), ref_acc)
