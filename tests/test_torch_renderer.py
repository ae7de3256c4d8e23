"""The slice end to end: the port's Renderer against the JAX package's,
on both procedural scenes at 32x24, render_sample(1), render_sample(2),
current_image().

The JAX renderer runs its CPU default (brute force for cornell, the
lock-step jnp traversal for the benchmark scene, whose hits carry
scene-order ids); the port runs brute force for cornell and the kernel
path for the benchmark scene, which on the CPU takes the traversal
kernels' plain twins and packed ids. Tolerances:
accum |d| <= 1e-3 (1 + |ref|) on >= 99% of pixels and its mean to 1e-4
relative; the display image to 2/255 on >= 99% of pixels.
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu import Renderer as JaxRenderer
from tracerboy_tpu_torch import OutputSettings, Renderer
from tracerboy_tpu_torch.trace import kernels

torch.set_num_threads(2)

FILM = (32, 24)


@pytest.mark.parametrize("name,backend", [
    ("shadertoy:cornell", "brute"), ("shadertoy", "kernel")])
def test_render_matches_jax(name, backend):
    ref = JaxRenderer(name, film_size=FILM)
    ref.render_sample(1)
    ref.render_sample(2)
    ref_acc = np.asarray(ref.state.accum)
    ref_img = ref.current_image()

    r = Renderer(name, film_size=FILM, device="cpu")
    assert r.traversal == backend
    r.render_sample(1)
    r.render_sample(2)
    acc = r.state.accum.numpy()
    img = r.current_image()

    assert r.state.spp == ref.state.spp == 3
    assert np.isfinite(acc).all() and acc[..., :3].mean() > 0
    close = (np.abs(acc - ref_acc) <= 1e-3 * (1 + np.abs(ref_acc))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref_acc.mean()) <= 1e-4 * abs(ref_acc.mean())
    assert img.shape == (FILM[1], FILM[0], 3)
    assert (np.abs(img - ref_img) <= 2 / 255).all(-1).mean() >= 0.99
    # The jittered accumulator draws the same coins.
    jit = r.state.accum_jittered.numpy()
    ref_jit = np.asarray(ref.state.accum_jittered)
    assert ((jit[..., 3] > 0) == (ref_jit[..., 3] > 0)).all()


def test_kernel_path_reaches_the_traversal_once_per_bounce():
    """On the kernel path each bounce traces one closest-hit and one
    shadow wave: at least one of each per wave, at most one per bounce.
    On the CPU they go to the twins, so the kernels launch nothing."""
    r = Renderer("shadertoy", film_size=(16, 12), device="cpu")
    bounces = r.wave_config().max_bounces
    for n in (1, 3):   # a single wave, then one merged wave of 3 samples
        kernels.reset_counters()
        r.render_sample(n)
        for key in ("closest", "anyhit"):
            assert 1 <= kernels.TWIN_CALLS[key] <= bounces, (
                key, kernels.TWIN_CALLS)
        assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_twin_backend_equals_kernel_backend_on_cpu():
    """The "twin" backend (the path-parity wave of chip_smoke.py) takes
    the same twins on the CPU, so its merged 2-sample wave equals the
    one render_sample(2) accumulates, bit for bit."""
    from dataclasses import replace

    from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

    r = Renderer("shadertoy", film_size=(16, 12), device="cpu")
    cfg = replace(r.wave_config(), traversal="twin")
    out = render_wave_merged(r.scene, r.frame_params(), r.pixel_ids, 0, 2,
                             cfg)
    r.render_sample(2)
    assert torch.equal(r.state.accum[..., :3].reshape(-1, 3),
                       out["radiance"])
    assert torch.equal(r.state.accum[..., 3].reshape(-1),
                       out["filter_weight"])


@pytest.mark.parametrize("what", ["adaptive", "output_type"])
def test_estimator_settings_render(what):
    """Adaptive sampling and the tent splat (here under a debug view) are
    taken by the renderer: it renders and shows an image in [0, 1]; the
    splat's wave is the merged fold, the adaptive one's has no mask
    before ADAPTIVE_MIN_SPP samples."""
    from tracerboy_tpu_torch.utils.config import (
        CameraSettings,
        OutputType,
        PerformanceSettings,
    )

    if what == "adaptive":
        s = OutputSettings(performance_settings=PerformanceSettings(
            enable_adaptive_sampling=True))
    else:
        s = OutputSettings(output_type=OutputType.ALBEDO,
                           camera_settings=CameraSettings(filter_splat=True))
    r = Renderer("shadertoy:cornell", settings=s, film_size=(8, 8),
                 device="cpu")
    r.render_sample(1)
    img = r.current_image()
    assert img.shape == (8, 8, 3) and 0 <= img.min() and img.max() <= 1
    if what == "adaptive":
        assert r.active_pixel_mask() is None and r._live_pixels is None
    else:
        assert r.wave_config().filter_splat
        assert "radiance_splat" in r._last_aovs
        assert img.any()


def test_render_options_match_jax():
    """Non-default paths of the slice's code: Sobol sampler, Gaussian
    pixel filter, depth of field, firefly clamp, and Renderer.render(),
    on cornell (brute force, so the JAX side compiles quickly; RIS is
    held against the JAX package in test_torch_camera_shade.py). Same
    tolerances as the default render."""
    from tracerboy_tpu.utils import config as jcfg
    from tracerboy_tpu_torch.utils import config as tcfg

    def settings(cfg):
        return cfg.OutputSettings(
            camera_settings=cfg.CameraSettings(
                filter_type=cfg.FilterType.GAUSSIAN, filter_width=1.5,
                dof_focus_distance=3.0, dof_aperture_width=0.02),
            performance_settings=cfg.PerformanceSettings(
                sampler="sobol", max_bounces=4),
            fireflies_clamp=4.0,
        )

    ref = JaxRenderer("shadertoy:cornell", settings=settings(jcfg),
                      film_size=FILM)
    ref_img = ref.render(spp=2)
    ref_acc = np.asarray(ref.state.accum)
    r = Renderer("shadertoy:cornell", settings=settings(tcfg),
                 film_size=FILM, device="cpu")
    img = r.render(spp=2)
    acc = r.state.accum.numpy()
    close = (np.abs(acc - ref_acc) <= 1e-3 * (1 + np.abs(ref_acc))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref_acc.mean()) <= 1e-4 * abs(ref_acc.mean())
    assert (np.abs(img - ref_img) <= 2 / 255).all(-1).mean() >= 0.99


def test_profile_summary_unions_device_intervals():
    """profile_slice's device summary: busy time is the union of kernel
    intervals, the idle share is measured over the device span, and the
    traversal launches are listed in start order."""
    from types import SimpleNamespace as NS

    from tracerboy_tpu_torch.utils.profile_slice import _device_summary

    def ev(name, start, end, dev="DeviceType.CUDA"):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=start, end=end))

    prof = NS(events=lambda: [
        ev("void (anonymous namespace)::octet_kernel<true>(...)", 500.0,
           600.0),
        ev("void at::native::vectorized_elementwise_kernel", 0.0, 300.0),
        ev("void (anonymous namespace)::octet_kernel<false>(...)", 200.0,
           400.0),
        ev("void at::native::CatArrayBatchedCopy", 900.0, 1000.0),
        ev("aten::add", 0.0, 2000.0, dev="DeviceType.CPU"),
    ])
    s = _device_summary(prof)
    assert s["n_device_events"] == 4
    assert s["span_ms"] == 1.0 and s["busy_ms"] == 0.6
    assert abs(s["idle_share"] - 0.4) < 1e-12
    assert s["by_class_ms"] == {"traversal": pytest.approx(0.3),
                                "elementwise": pytest.approx(0.3),
                                "cat_stack": pytest.approx(0.1)}
    assert s["traversal_launches_ms"] == [("closest_hit", 0.2),
                                          ("any_hit", 0.1)]
    assert s["traversal_by_bounce_ms"] == [[0.2, 0.1]]


def test_profile_summary_pairs_traversal_launches_by_bounce():
    """A closest hit (or the stats kernel on a HEATMAP primary wave) opens
    a bounce; the any hits up to the next one are its shadow waves."""
    from tracerboy_tpu_torch.utils.profile_slice import (
        _by_bounce,
        _traversal_kind,
    )

    names = ["(anonymous namespace)::traverse_stats_kernel(float const*)",
             "void (anonymous namespace)::octet_kernel<true>(float const*)",
             "void (anonymous namespace)::octet_kernel<(bool)0>(float const*)",
             "void (anonymous namespace)::octet_kernel<false>(float const*)",
             "void (anonymous namespace)::octet_kernel<true>(float const*)",
             "void (anonymous namespace)::octet_kernel<(bool)1>(float*)"]
    kinds = [_traversal_kind(n) for n in names]
    assert kinds == ["closest_hit_stats", "any_hit", "closest_hit",
                     "closest_hit", "any_hit", "any_hit"]
    rows = _by_bounce(list(zip(kinds, [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])))
    assert rows == [[1.0, 2.0], [3.0, 0.0], [4.0, 11.0]]
    assert _by_bounce([("any_hit", 1.0)]) == []


def test_profile_summary_separates_the_opt_in_kernels():
    """The cut path's emit kernel and the binned path's selection and
    dense kernels are classes of their own, not traversal."""
    from types import SimpleNamespace as NS

    from tracerboy_tpu_torch.utils.profile_slice import _device_summary

    def ev(name, start, end):
        return NS(name=name, device_type="DeviceType.CUDA",
                  time_range=NS(start=start, end=end))

    prof = NS(events=lambda: [
        ev("(anonymous namespace)::emit_kernel(...)", 0.0, 100.0),
        ev("void (anonymous namespace)::octet_kernel<false>(...)", 100.0,
           300.0),
        ev("(anonymous namespace)::select_kernel(...)", 300.0, 600.0),
        ev("(anonymous namespace)::dense_kernel(...)", 600.0, 1000.0),
    ])
    s = _device_summary(prof)
    assert s["by_class_ms"] == {"emit": pytest.approx(0.1),
                                "traversal": pytest.approx(0.2),
                                "select": pytest.approx(0.3),
                                "dense": pytest.approx(0.4)}
    assert s["traversal_launches_ms"] == [("closest_hit", 0.2)]
