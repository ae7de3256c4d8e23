"""Debug views of the port (post/pipeline.py post_process, post/visualize.py)
and the Renderer's readouts that use them, against the JAX package.

- post_process for every OutputType on identical numpy accumulators and
  AOV planes, with and without the optional planes (variance,
  live_pixels, motion): equal to 1e-6 absolute;
- overlay_ray_path on the same image, path record and camera: equal;
- the port's Renderer against the JAX Renderer on "shadertoy:cornell" at
  32x24 (brute force in both), render_sample(1) + render_sample(2):
  current_image() of every view to 2/255 on >= 99% of pixels (the
  tolerance of tests/test_torch_renderer.py's display image), select_pixel
  (material id equal, the rest to 1e-3 (1 + |ref|)), get_material
  (equal), convergence_error (to 1e-3 relative) and
  visualize_selected_ray_path (2/255 on >= 99% of pixels);
- HEATMAP on the kernel path on the CPU goes through the stats twin and
  gives a finite image in [0, 1].
"""

import dataclasses

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import OutputType, Renderer
from tracerboy_tpu_torch.post import pipeline, visualize
from tracerboy_tpu_torch.trace import kernels

torch.set_num_threads(2)

FILM = (32, 24)
H, W = 12, 16


def _views_inputs(seed, optional):
    rng = np.random.default_rng(seed)
    n = H * W
    accum = rng.random((H, W, 4), dtype=np.float32) * 2
    accum[..., 3] += 0.5
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    aovs = dict(
        albedo=rng.random((n, 3), dtype=np.float32) * 1.2,
        normal=nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
        depth=rng.random(n, dtype=np.float32) * 9,
        heatmap=rng.integers(1, 80, n).astype(np.float32),
    )
    if optional:
        aovs.update(variance=rng.random((H, W), dtype=np.float32) * 0.3,
                    live_pixels=rng.random(n) < 0.5,
                    motion=rng.normal(size=(n, 2)).astype(np.float32) * 5)
    return accum, aovs


@pytest.mark.parametrize("optional", [False, True])
@pytest.mark.parametrize("view", list(OutputType), ids=lambda v: v.name)
def test_post_process_views_match_jax(view, optional):
    import jax.numpy as jnp

    from tracerboy_tpu.post.pipeline import post_process as jax_post
    from tracerboy_tpu.utils import config as jcfg
    from tracerboy_tpu_torch.utils import config as tcfg

    accum, aovs = _views_inputs(int(view) + 10 * optional, optional)
    ref = np.asarray(jax_post(
        jnp.asarray(accum),
        jcfg.OutputSettings(output_type=jcfg.OutputType(int(view))),
        aovs={k: jnp.asarray(v) for k, v in aovs.items()}, width=W,
        height=H))
    got = pipeline.post_process(
        torch.from_numpy(accum),
        tcfg.OutputSettings(output_type=view),
        aovs={k: torch.from_numpy(np.asarray(v)) for k, v in aovs.items()},
        width=W, height=H).numpy()
    assert got.shape == ref.shape == (H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_overlay_ray_path_matches_jax():
    from tracerboy_tpu.post.visualize import overlay_ray_path as jax_overlay
    from tracerboy_tpu_torch.scene.compile import load_scene

    cam = load_scene("shadertoy:cornell", film_size=FILM).camera.as_numpy()
    rng = np.random.default_rng(3)
    img = rng.random((FILM[1], FILM[0], 3), dtype=np.float32)
    viz = np.zeros((6, 8), np.float32)
    viz[:4, :6] = rng.normal(size=(4, 6)) * 0.8 + np.array(
        [0, 1, 0, 0, 1, 0])
    viz[:4, 7] = 1.0
    viz[2, 7] = 0.0
    got = visualize.overlay_ray_path(img, viz, cam, *FILM)
    np.testing.assert_array_equal(got, jax_overlay(img, viz, cam, *FILM))
    assert not np.array_equal(got, img)


def _display_close(got, ref):
    return (np.abs(got - ref) <= 2 / 255).all(-1).mean()


def test_renderer_readouts_match_jax():
    from tracerboy_tpu import Renderer as JaxRenderer

    ref = JaxRenderer("shadertoy:cornell", film_size=FILM)
    r = Renderer("shadertoy:cornell", film_size=FILM, device="cpu")
    assert r.select_pixel(3, 4) == ref.select_pixel(3, 4) == {}
    for rr in (ref, r):
        rr.render_sample(1)
        rr.render_sample(2)
    for view in OutputType:
        ref.settings = dataclasses.replace(
            ref.settings, output_type=type(ref.settings.output_type)(
                int(view)))
        r.settings = dataclasses.replace(r.settings, output_type=view)
        got, want = r.current_image(), ref.current_image()
        assert got.shape == want.shape == (FILM[1], FILM[0], 3)
        assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
        assert _display_close(got, want) >= 0.99, view.name
    for x, y in ((3, 4), (16, 12), (30, 20)):
        got, want = r.select_pixel(x, y), ref.select_pixel(x, y)
        assert got["material_id"] == want["material_id"]
        for key in ("depth", "albedo", "normal", "world_pos"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                       atol=1e-3, err_msg=key)
        mat = r.get_material(got["material_id"])
        want_mat = ref.get_material(want["material_id"])
        assert set(mat) == set(want_mat)
        for key in mat:
            np.testing.assert_array_equal(mat[key], want_mat[key])
    assert r.convergence_error() == pytest.approx(ref.convergence_error(),
                                                  rel=1e-3)
    r.settings = dataclasses.replace(r.settings, output_type=OutputType.LIT)
    ref.settings = dataclasses.replace(
        ref.settings, output_type=type(ref.settings.output_type).LIT)
    got = r.visualize_selected_ray_path(13, 9)
    want = ref.visualize_selected_ray_path(13, 9)
    assert r.state.spp == ref.state.spp == 4
    assert _display_close(got, want) >= 0.99
    assert not np.array_equal(got, r.current_image())


def test_heatmap_view_runs_the_stats_twin_on_cpu():
    s = dataclasses.replace(Renderer("shadertoy:cornell", film_size=(4, 4),
                                     device="cpu").settings,
                            output_type=OutputType.HEATMAP)
    r = Renderer("shadertoy", settings=s, film_size=(16, 12), device="cpu")
    kernels.reset_counters()
    r.render_sample(1)
    img = r.current_image()
    assert kernels.TWIN_CALLS["closest_stats"] == 1
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    assert img[..., 0].max() == 1.0       # the costliest pixel is red
