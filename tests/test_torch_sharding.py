"""Tile and sample sharding (parallel/sharding.py, Renderer(shard=))
against the JAX package's, on meshes of 2: the port's mesh is the CPU
twice (make_mesh(2, device_type="cpu")), the JAX one the first 2 of the
8 virtual CPU devices of tests/conftest.py.

Tolerances against JAX: tests/test_torch_renderer.py's (accum |d| <=
1e-3 (1 + |ref|) on >= 99% of pixels and its mean to 1e-4 relative; the
display image to 2/255 on >= 99%). Within the port the sharded paths are
exact: the tiled accumulators equal (torch.equal) the unsharded
single-sample waves', with and without pad, and the spp step equals its
waves summed in mesh order. (Torch's vectorised CPU kernels compute a
sine or an exponential in a vector's lanes and in the scalar tail of a
loop differently, by an ulp, so a lane that moves from the tail to a
vector between an unsharded and a tiled wave may differ; the exactness
check of padded films therefore runs in a subprocess under
ATEN_CPU_CAPABILITY=default, whose kernels compute every lane alike. On
the card each lane is one thread either way: chip_smoke.py checks it
there.)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.parallel.sharding import (
    make_mesh,
    render_spp_sharded,
    render_wave_tiled,
    shard_pixels,
)
from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

torch.set_num_threads(2)

CORNELL = ("shadertoy:cornell", (16, 12))
BENCH = ("shadertoy", (32, 24))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_mesh(n=2):
    return make_mesh(n, device_type="cpu")


def assert_accum_close(acc, ref):
    close = (np.abs(acc - ref) <= 1e-3 * (1 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize("w,h,n", [(32, 24, 2), (31, 23, 2), (7, 5, 8),
                                   (16, 12, 3)])
def test_shard_pixels_matches_jax(w, h, n):
    import jax

    from tracerboy_tpu.parallel.sharding import make_mesh as jax_mesh
    from tracerboy_tpu.parallel.sharding import shard_pixels as jax_shard

    ref_ids, ref_pad = jax_shard(jax_mesh(n), w, h)
    ids, pad = shard_pixels(cpu_mesh(n), w, h)
    assert pad == ref_pad and (w * h + pad) % n == 0
    assert np.array_equal(ids.numpy(), np.asarray(jax.device_get(ref_ids)))


def test_make_mesh():
    """Repeated devices are allowed; more cards than are visible raise
    (the JAX package's devices[:n] would give fewer)."""
    m = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert m.size == 3 and all(d.type == "cpu" for d in m.devices)
    assert cpu_mesh().size == 2 and make_mesh(device_type="cpu").size == 1
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        make_mesh(n_devices=n_cards + 1)
    with pytest.raises(ValueError, match="visible"):
        make_mesh(devices=[f"cuda:{n_cards}"])
    if n_cards == 0:
        with pytest.raises(ValueError, match="visible"):
            Renderer(CORNELL[0], film_size=CORNELL[1], shard="tiles")
    with pytest.raises(ValueError, match="shard must be"):
        Renderer(CORNELL[0], film_size=CORNELL[1], device="cpu",
                 shard="rows")


def test_wave_functions_match_jax():
    """render_wave_tiled and render_spp_sharded (2 samples an entry, as
    a loop) against the JAX functions on the same scene and params."""
    import jax.numpy as jnp

    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.parallel import sharding as jsh

    name, film = CORNELL
    ref = JaxRenderer(name, film_size=film)
    r = Renderer(name, film_size=film, device="cpu")
    jmesh, mesh = jsh.make_mesh(2), cpu_mesh()
    jids, jpad = jsh.shard_pixels(jmesh, *film)
    ids, pad = shard_pixels(mesh, *film)
    cfg, jcfg = r.wave_config(), ref.wave_config()
    params, jparams = r.frame_params(), ref.frame_params()
    params.pop("bn", None)
    jparams.pop("bn", None)
    replicas = [r.scene, r.scene]
    out = render_wave_tiled(mesh, replicas, params, ids, 3, cfg)
    jout = jsh.render_wave_tiled(jmesh, ref.scene_pytree, jparams, jids,
                                 jnp.int32(3), jcfg)
    for key in ("radiance", "filter_weight", "world_pos", "depth"):
        got, want = out[key].numpy(), np.asarray(jout[key])
        assert got.shape == want.shape, key
        got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
        assert_accum_close(got, want)
    assert int(out["rays_traced"]) == int(jout["rays_traced"])
    base = 5
    rad, fw, rays = render_spp_sharded(mesh, replicas, params, r.pixel_ids,
                                       base, cfg, samples_per_device=2)
    jrad, jfw, jrays = jsh.render_spp_sharded(
        jmesh, ref.scene_pytree, jparams,
        jnp.arange(film[0] * film[1], dtype=jnp.int32), jnp.int32(base),
        jcfg, samples_per_device=2)
    assert_accum_close(torch.cat([rad, fw[:, None]], 1).numpy(),
                       np.concatenate([np.asarray(jrad),
                                       np.asarray(jfw)[:, None]], 1))
    assert int(rays) == int(jrays)


@pytest.mark.parametrize("shard,scene", [
    ("tiles", CORNELL), ("spp", CORNELL), ("tiles", BENCH), ("spp", BENCH)])
def test_renderer_matches_jax(shard, scene):
    """render_sample(1), render_sample(3) and current_image() of
    Renderer(shard=, n_devices=2) against the JAX one: spp counts alike
    (the spp step rounds n up to a multiple of the mesh), accumulators
    and display image within tests/test_torch_renderer.py's bounds."""
    from tracerboy_tpu import Renderer as JaxRenderer

    name, film = scene
    ref = JaxRenderer(name, film_size=film, shard=shard, n_devices=2)
    r = Renderer(name, film_size=film, device="cpu", shard=shard,
                 n_devices=2)
    assert r.mesh.size == ref.mesh.devices.size == 2
    for n in (1, 3):
        ref.render_sample(n)
        r.render_sample(n)
        assert r.state.spp == ref.state.spp
    acc = r.state.accum.numpy()
    assert np.isfinite(acc).all() and acc[..., :3].mean() > 0
    assert_accum_close(acc, np.asarray(ref.state.accum))
    img, ref_img = r.current_image(), ref.current_image()
    assert img.shape == (film[1], film[0], 3)
    assert (np.abs(img - ref_img) <= 2 / 255).all(-1).mean() >= 0.99


EXACT_SCRIPT = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(2)
from tracerboy_tpu_torch import Renderer
res = {}
for name, w, h in (("shadertoy", 32, 24), ("shadertoy", 31, 23),
                   ("shadertoy:cornell", 15, 11)):
    ref = Renderer(name, film_size=(w, h), device="cpu")
    til = Renderer(name, film_size=(w, h), device="cpu", shard="tiles",
                   n_devices=2)
    ref.render_sample(1)
    ref.render_sample(1)
    til.render_sample(2)
    res[f"{name} {w}x{h} pad {til._tiled_pixels[1]}"] = [
        torch.equal(ref.state.accum, til.state.accum),
        torch.equal(ref.state.accum_jittered, til.state.accum_jittered),
        torch.equal(ref.state.world_pos[1], til.state.world_pos[1])]
print(json.dumps(res))
"""


def test_tiled_equals_the_unsharded_waves():
    """Two tiled samples equal two unsharded render_sample(1) calls bit
    for bit (accum, the jittered accumulator, the world-position buffer),
    on films with pad 0 and pad 1 (see the module docstring for the
    subprocess)."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    res = subprocess.run([sys.executable, "-c", EXACT_SCRIPT, REPO],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert any("pad 0" in k for k in got) and any("pad 1" in k for k in got)
    assert all(all(v) for v in got.values()), got


@pytest.mark.parametrize("scene", [CORNELL, BENCH])
def test_spp_equals_its_mesh_order_sum(scene):
    """render_sample(4) on a mesh of 2 (2 samples an entry, one merged
    wave each on the packed backend) accumulates exactly entry 0's wave
    plus entry 1's, each traced unsharded."""
    name, film = scene
    r = Renderer(name, film_size=film, device="cpu", shard="spp",
                 n_devices=2)
    ref = Renderer(name, film_size=film, device="cpu")
    r.render_sample(4)
    assert r.state.spp == 4
    cfg, params = ref.wave_config(), ref.frame_params()
    outs = [render_wave_merged(ref.scene, params, ref.pixel_ids, 2 * i, 2,
                               cfg) for i in range(2)]
    rad = outs[0]["radiance"] + outs[1]["radiance"]
    fw = outs[0]["filter_weight"] + outs[1]["filter_weight"]
    want = torch.cat([rad.reshape(film[1], film[0], 3),
                      fw.reshape(film[1], film[0], 1)], -1)
    assert torch.equal(r.state.accum, want)
    assert r.rays_traced == int(outs[0]["rays_traced"]
                                + outs[1]["rays_traced"])


def _edit(r, what):
    if what == "set_material":
        r.set_material(0, albedo=[0.1, 0.9, 0.2])
    elif what == "move_camera":
        r.move_camera(forward=0.2, yaw=0.05)
    else:
        sc = r.scene
        shift = torch.tensor([0.0, 0.05, 0.0])
        r.update_geometry(sc["tri_v0"] + shift, sc["tri_v1"] + shift,
                          sc["tri_v2"] + shift)


@pytest.mark.parametrize("what", ["set_material", "move_camera",
                                  "update_geometry"])
def test_replicas_refresh_after_scene_edits(what):
    """The second mesh entry renders its own replica of the scene (a
    clone, though the device repeats): after an edit it must be copied
    again, so a tiled sample after the edit equals the unsharded one."""
    name, film = CORNELL
    r = Renderer(name, film_size=film, device="cpu", shard="tiles",
                 n_devices=2)
    ref = Renderer(name, film_size=film, device="cpu")
    r.render_sample(1)
    stale = r._mesh_scenes()[1]
    _edit(r, what)
    _edit(ref, what)
    r.render_sample(1)
    ref.render_sample(1)
    assert r._mesh_scenes()[1] is not stale
    assert torch.equal(r.state.accum, ref.state.accum)


def test_adaptive_burst_refuses_a_sharded_renderer():
    r = Renderer(CORNELL[0], film_size=CORNELL[1], device="cpu",
                 shard="spp", n_devices=2)
    with pytest.raises(NotImplementedError, match="single-chip"):
        r.render_sample_adaptive(4)


def test_sharded_checkpoint_resumes(tmp_path):
    """A sharded run saved after 2 samples and resumed in a new sharded
    renderer for 2 more equals the uninterrupted run (the checkpoint
    holds the same state as an unsharded one)."""
    from tracerboy_tpu_torch.utils.checkpoint import (
        load_render_checkpoint,
        save_render_checkpoint,
    )

    name, film = CORNELL
    path = str(tmp_path / "ck.npz")

    def make():
        return Renderer(name, film_size=film, device="cpu", shard="spp",
                        n_devices=2)

    full = make()
    full.render_sample(2)
    full.render_sample(2)
    first = make()
    first.render_sample(2)
    save_render_checkpoint(path, first)
    resumed = make()
    assert load_render_checkpoint(path, resumed)
    assert resumed.state.spp == 2
    resumed.render_sample(2)
    assert torch.equal(resumed.state.accum, full.state.accum)
    assert torch.equal(resumed.state.accum_jittered,
                       full.state.accum_jittered)
