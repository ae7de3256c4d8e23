"""First-hit AOVs of the port's wave (trace/wavefront.py render_wave, which
always builds them, as the JAX default want_aovs does) against the JAX
package's wave.

- "shadertoy:cornell" at 32x24 on brute force in both packages, one
  wave with a selected pixel: every AOV plane, the heatmap included (the
  padded triangle count on every lane, exactly), and viz_rays.
- "shadertoy": the JAX CPU default (the lock-step jnp traversal,
  scene-order ids) against the port's kernel path (the twins on the
  CPU, packed ids): every plane but heatmap, whose jnp cost counts the
  JAX package's other tree layout.
- The merged and batch contracts of the port, on its own waves: a merged
  wave's AOVs are its first sample's, a batch's are its last sample's; a merged wave refuses a selected pixel, as the JAX
  assert does; the HEATMAP view's primary wave takes the stats kernel
  once per wave, on the default path and with TB_CUT=1.

Tolerances (tests/test_torch_renderer.py's): |d| <= 1e-3 (1 + |ref|) on
>= 99% of lanes for the float planes; material ids equal on every lane
whose depth agrees to that bound; viz_rays to the same bound on every
entry. Between the port's own waves: equal to 1e-6 absolute (the same
expressions over other lane counts).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import OutputType, Renderer
from tracerboy_tpu_torch.trace import kernels
from tracerboy_tpu_torch.trace.wavefront import (
    AOV_KEYS,
    render_wave,
    render_wave_batch,
    render_wave_merged,
)

torch.set_num_threads(2)

FILM = (32, 24)
SELECTED = (13, 9)


def _close(got, ref):
    return np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))


def _jax_wave(name):
    """The JAX package's AOV wave (sample 0) with SELECTED recorded."""
    import jax.numpy as jnp

    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.trace.wavefront import render_wave as jax_render_wave

    ref = JaxRenderer(name, film_size=FILM)
    params = ref.frame_params()
    params["selected_pixel"] = jnp.int32(SELECTED[1] * FILM[0] + SELECTED[0])
    cfg = ref.wave_config()
    assert cfg.want_aovs
    out = jax_render_wave(ref.scene_pytree, params,
                          jnp.arange(FILM[0] * FILM[1], dtype=jnp.int32),
                          jnp.int32(0), cfg)
    return ref.traversal, {k: np.asarray(v) for k, v in out.items()}


def _port_wave(name):
    r = Renderer(name, film_size=FILM, device="cpu")
    params = r.frame_params()
    params["selected_pixel"] = SELECTED[1] * FILM[0] + SELECTED[0]
    out = render_wave(r.scene, params, r.pixel_ids, 0, r.wave_config())
    return r.traversal, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", ["shadertoy:cornell", "shadertoy"])
def test_aovs_match_jax(name):
    jax_backend, ref = _jax_wave(name)
    backend, got = _port_wave(name)
    for key in AOV_KEYS + ("radiance", "filter_weight"):
        assert got[key].shape == ref[key].shape, key
    keys = [k for k in AOV_KEYS if k not in ("material", "heatmap")]
    for key in keys:
        close = _close(got[key], ref[key]).reshape(len(got[key]), -1)
        assert close.all(-1).mean() >= 0.99, (key, close.all(-1).mean())
    agree = _close(got["depth"], ref["depth"])
    assert agree.mean() >= 0.99
    np.testing.assert_array_equal(got["material"][agree],
                                  ref["material"][agree])
    assert (got["material"] >= -1).all()
    assert (ref["material"] == -1).any() == (got["material"] == -1).any()
    assert _close(got["viz_rays"], ref["viz_rays"]).all(), (
        got["viz_rays"], ref["viz_rays"])
    assert got["viz_rays"][0, 7] == 1.0
    if name == "shadertoy:cornell":
        assert jax_backend == backend == "brute"
        np.testing.assert_array_equal(got["heatmap"], ref["heatmap"])
        # The brute-force cost: the rows of the padded triangle table
        # (cornell's 36 triangles padded to 56), on every lane.
        assert (got["heatmap"] == 56).all()
    else:
        assert (jax_backend, backend) == ("jnp", "kernel")


def _cornell(film=(16, 12)):
    r = Renderer("shadertoy:cornell", film_size=film, device="cpu")
    return r, r.frame_params(), r.wave_config()


def _assert_aovs_equal(got, want, keys=AOV_KEYS):
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_merged_wave_keeps_the_first_sample():
    r, params, cfg = _cornell()
    ids = r.pixel_ids
    first = render_wave(r.scene, params, ids, 5, cfg)
    merged = render_wave_merged(r.scene, params, ids, 5, 2, cfg)
    _assert_aovs_equal(merged, first)
    assert merged["albedo"].shape == (ids.shape[0], 3)
    assert merged["viz_rays"].shape == (cfg.max_bounces, 8)
    assert not merged["viz_rays"].any()


def test_batch_keeps_the_last_sample():
    r, params, cfg = _cornell()
    batch = render_wave_batch(r.scene, params, r.pixel_ids, 3, 3, cfg)
    last = render_wave(r.scene, params, r.pixel_ids, 5, cfg)
    _assert_aovs_equal(batch, last)
    assert "viz_rays" not in batch


def test_merged_wave_refuses_a_selected_pixel():
    r, params, cfg = _cornell()
    params["selected_pixel"] = 7
    with pytest.raises(ValueError, match="selected pixel"):
        render_wave_merged(r.scene, params, r.pixel_ids, 0, 2, cfg)


@pytest.mark.parametrize("env", [{}, {"TB_CUT": "1"}])
def test_heatmap_primary_wave_takes_the_stats_kernel(monkeypatch, env):
    """HEATMAP: one stats traversal per wave (the primary), the whole-tree
    or cut path for the bounces; the merged wave's heatmap is its first
    sample's cost, pops + clusters of the stats twin."""
    for key in ("TB_CUT", "TB_BINNED"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    r = Renderer("shadertoy", film_size=(16, 12), device="cpu")
    r.settings = dataclasses.replace(r.settings,
                                     output_type=OutputType.HEATMAP)
    cfg = r.wave_config()
    assert cfg.want_heatmap and cfg.cut == ("TB_CUT" in env)
    kernels.reset_counters()
    r.render_sample(1)
    r.render_sample(3)
    assert kernels.TWIN_CALLS["closest_stats"] == 2
    # The bounce waves' closest hits (on the cut path phase 2 of each,
    # after an emit per closest-hit and shadow wave).
    assert kernels.TWIN_CALLS["closest"] >= 2
    assert (kernels.TWIN_CALLS["emit"] >= 2) == bool(env)
    hm = r._last_aovs["heatmap"]
    assert hm.shape == (16 * 12,) and (hm >= 1).all()
    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.trace import traverse
    from tracerboy_tpu_torch.trace.camera import generate_primary_rays_soa

    # The first sample's primary rays, traced again through the twin.
    bn = r.frame_params()["bn"]
    from tracerboy_tpu_torch.core import rng as tbrng

    shift = tbrng.halton23(torch.as_tensor(1))
    ju, jv = (torch.remainder(bn[k] + shift[..., k], 1.0) for k in (0, 1))
    du, dv = (torch.remainder(bn[4 + k] + shift[..., k], 1.0)
              for k in (0, 1))
    params = r.frame_params()
    o, d = generate_primary_rays_soa(
        r.scene["camera"], 16, 12, r.pixel_ids, ju, jv,
        dof_focus_distance=params["dof_focus"],
        dof_aperture_width=params["dof_aperture"], dof_u=du, dof_v=dv,
        filter_width=cfg.filter_width)
    st = traverse.closest_hit_stats_plain(
        v3.to_rows(o), v3.to_rows(d), torch.full((16 * 12,), 1e30),
        r.scene["pk_nodes"], r.scene["pk_tris_bw"])
    assert torch.equal(hm, (st[4] + st[5]).to(torch.float32))
