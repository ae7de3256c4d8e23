"""The port's command-line renderer (app/cli.py) and render checkpoints
(utils/checkpoint.py) against the JAX package's, in process, on the
scene of tests/test_cli.py (a plane under a white sky, so environment
NEE is on by auto) at 32x24 on the CPU (--device cpu).

Tolerances: the PNG within 2/255 of the JAX CLI's on >= 99% of pixels;
the --hdr-out radiance (and the accumulators) within
tests/test_torch_renderer.py's bound, 1e-3 (1 + |ref|) on >= 99% of
pixels and the mean to 1e-4 relative. Checkpoint files carry their arrays
bit for bit in both directions.

Under the `cuda` marker (skipped without a card; run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_cli.py`): the CLI
with --device cuda on a written scene of 100,352 PLY triangles launches
the closest-hit and any-hit kernels, and every env-NEE shadow wave of the
render gives the kernel's occlusion equal to its plain version's. This
module imports jax (and the JAX package) only inside the tests that
compare with it.
"""

import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.app import cli
from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.trace import kernels, traverse

torch.set_num_threads(2)

SCENE = """
    LookAt 0 2 4  0 0 0  0 1 0
    Camera "perspective" "float fov" [ 35 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 24 ]
    WorldBegin
    LightSource "infinite" "rgb L" [ 1 1 1 ]
    Material "matte" "rgb Kd" [ 0.6 0.4 0.3 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -5 0 -5  5 0 -5  5 0 5  -5 0 5 ]
    WorldEnd
"""


@pytest.fixture
def tiny_scene(tmp_path):
    p = tmp_path / "s.pbrt"
    p.write_text(textwrap.dedent(SCENE))
    return str(p)


def _jax_main(argv):
    from tracerboy_tpu.app.cli import main

    return main(argv)


def _read_png(path):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(str(path))


def assert_images_close(a, b):
    assert a.shape == b.shape
    assert (np.abs(a - b) <= 2 / 255 + 1e-6).all(-1).mean() >= 0.99


def assert_radiance_close(got, ref):
    close = (np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


def test_parser_has_every_jax_flag_with_its_default():
    from tracerboy_tpu.app.cli import build_parser as jax_parser

    ref, got = jax_parser(), cli.build_parser()
    ref_opts = {a.dest: a for a in ref._actions}
    got_opts = {a.dest: a for a in got._actions}
    assert set(got_opts) - set(ref_opts) == {"device", "archive"}
    assert set(ref_opts) <= set(got_opts)
    for dest, a in ref_opts.items():
        b = got_opts[dest]
        assert (a.option_strings, a.default, a.choices) == (
            b.option_strings, b.default, b.choices), dest
    args = got.parse_args(
        ["scene.pbrt", "--spp", "8", "--size", "64x48", "--tonemap", "aces",
         "--ris", "--no-auto-exposure", "--aov", "normal", "--denoiser",
         "oidn", "--archive", "rt_ldr.tza", "--device", "cpu"])
    assert args.spp == 8 and args.size == "64x48" and args.ris
    assert args.tonemap == "aces" and args.aov == "normal"
    assert (args.denoiser, args.archive, args.device) == (
        "oidn", "rt_ldr.tza", "cpu")
    assert got.parse_args(["s.pbrt"]).device == "cuda"


@pytest.mark.parametrize("extra", [[], ["--aov", "normal"],
                                   ["--tonemap", "aces", "--no-nee",
                                    "--sampler", "sobol"]])
def test_render_matches_the_jax_cli(tiny_scene, tmp_path, extra):
    common = [tiny_scene, "--spp", "2", "--size", "32x24", "--quiet",
              *extra]
    j_png, t_png = tmp_path / "j.png", tmp_path / "t.png"
    j_exr, t_exr = tmp_path / "j.exr", tmp_path / "t.exr"
    assert _jax_main([*common, "--out", str(j_png), "--hdr-out",
                      str(j_exr)]) == 0
    stats = {}
    assert cli.main([*common, "--out", str(t_png), "--hdr-out", str(t_exr),
                     "--device", "cpu"], stats=stats) == 0
    img = _read_png(t_png)
    assert img.shape == (24, 32, 3)
    assert_images_close(img, _read_png(j_png))
    rad = image_io.read_exr_rgb(str(t_exr))
    assert np.isfinite(rad).all()
    assert_radiance_close(rad, image_io.read_exr_rgb(str(j_exr)))
    assert stats["spp"] == 2 and stats["rays_traced"] > 32 * 24 * 2
    assert (stats["width"], stats["height"], stats["mode"]) == (
        32, 24, "unbiased")
    if extra[:2] == ["--aov", "normal"]:
        # The floor's +y normal: green in the 0.5 + 0.5 n encoding.
        assert img[12, 16, 1] > 0.9


@pytest.mark.parametrize("ext", ["hdr", "pfm"])
def test_hdr_out_formats(tiny_scene, tmp_path, ext):
    out = tmp_path / f"r.{ext}"
    assert cli.main([tiny_scene, "--spp", "1", "--out",
                     str(tmp_path / "o.png"), "--hdr-out", str(out),
                     "--device", "cpu", "--quiet"]) == 0
    rad = image_io.read_texture(str(out))
    assert rad.shape == (24, 32, 3) and np.isfinite(rad).all()


def test_capture_sequence(tiny_scene, tmp_path):
    out = tmp_path / "cap.png"
    assert cli.main([tiny_scene, "--spp", "8", "--out", str(out),
                     "--capture-every", "4", "--device", "cpu",
                     "--quiet"]) == 0
    for n in (4, 8):
        cap = tmp_path / f"cap_{n:05d}.png"
        assert cap.exists() and _read_png(cap).shape == (24, 32, 3)
    # The last capture is the final image.
    assert np.array_equal(_read_png(tmp_path / "cap_00008.png"),
                          _read_png(out))


def test_realtime_mode_writes_its_last_frame(tiny_scene, tmp_path):
    out = tmp_path / "rt.png"
    stats = {}
    assert cli.main([tiny_scene, "--mode", "realtime", "--frames", "3",
                     "--out", str(out), "--device", "cpu", "--quiet"],
                    stats=stats) == 0
    img = _read_png(out)
    assert img.shape == (24, 32, 3) and img.mean() > 0
    assert (stats["spp"], stats["mode"]) == (3, "realtime")


def test_denoiser_matches_the_jax_cli(tiny_scene, tmp_path, monkeypatch):
    """--denoiser oidn with --archive, both packages' load_oidn patched to
    the same random float32 weights (tests/test_torch_oidn.py)."""
    from test_torch_oidn import _patch_weights

    _patch_weights(monkeypatch)
    common = [tiny_scene, "--spp", "2", "--denoiser", "oidn", "--quiet"]
    assert _jax_main([*common, "--out", str(tmp_path / "j.png")]) == 0
    assert cli.main([*common, "--out", str(tmp_path / "t.png"), "--archive",
                     "rt_ldr.tza", "--device", "cpu"]) == 0
    assert_images_close(_read_png(tmp_path / "t.png"),
                        _read_png(tmp_path / "j.png"))


def test_denoiser_needs_the_archive(tiny_scene, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main([tiny_scene, "--denoiser", "oidn", "--device", "cpu",
                  "--out", str(tmp_path / "o.png")])
    assert e.value.code == 2


def test_upscale_fsr_matches_the_jax_cli(tiny_scene, tmp_path):
    """--upscale fsr: a 2x PNG (48x64 from 32x24) equal to the JAX CLI's
    within 2/255 on >= 99% of pixels."""
    common = [tiny_scene, "--spp", "1", "--upscale", "fsr", "--quiet"]
    assert _jax_main([*common, "--out", str(tmp_path / "j.png")]) == 0
    assert cli.main([*common, "--out", str(tmp_path / "t.png"),
                     "--device", "cpu"]) == 0
    img = _read_png(tmp_path / "t.png")
    assert img.shape == (48, 64, 3)
    assert_images_close(img, _read_png(tmp_path / "j.png"))


def test_upscale_superres_matches_the_jax_cli(tiny_scene, tmp_path,
                                              monkeypatch):
    """--upscale superres with a seeded random weights.bin read by both
    CLIs (tests/test_torch_upscale.py's writer)."""
    import tracerboy_tpu.ml.superres as jax_superres
    from test_torch_upscale import write_weights_bin

    from tracerboy_tpu_torch.ml import superres

    weights = str(tmp_path / "weights.bin")
    write_weights_bin(weights, seed=4)
    real = jax_superres.load_superres
    monkeypatch.setattr(jax_superres, "load_superres",
                        lambda path: real(weights))
    monkeypatch.setattr(superres, "WEIGHTS_BIN", weights)
    common = [tiny_scene, "--spp", "1", "--upscale", "superres", "--quiet"]
    assert _jax_main([*common, "--out", str(tmp_path / "j.png")]) == 0
    assert cli.main([*common, "--out", str(tmp_path / "t.png"),
                     "--device", "cpu"]) == 0
    img = _read_png(tmp_path / "t.png")
    assert img.shape == (48, 64, 3)
    assert_images_close(img, _read_png(tmp_path / "j.png"))


def test_upscale_superres_needs_its_weights(tiny_scene, tmp_path,
                                            monkeypatch, capsys):
    """Without weights.bin --upscale superres stops with exit 2 before
    any render, naming the file; it never falls back to FSR."""
    from tracerboy_tpu_torch import renderer as renderer_mod
    from tracerboy_tpu_torch.ml import superres

    missing = str(tmp_path / "absent" / "weights.bin")
    monkeypatch.setattr(superres, "WEIGHTS_BIN", missing)

    def no_render(*args, **kwargs):
        raise AssertionError("rendered without the weights")

    monkeypatch.setattr(renderer_mod.Renderer, "__init__", no_render)
    with pytest.raises(SystemExit) as e:
        cli.main([tiny_scene, "--upscale", "superres", "--device", "cpu",
                  "--out", str(tmp_path / "o.png")])
    assert e.value.code == 2
    assert missing in capsys.readouterr().err
    assert not (tmp_path / "o.png").exists()


@pytest.mark.parametrize("flags", [
    ["--shard", "tiles", "--devices", "2"],
    ["--shard", "spp", "--devices", "2"],
    ["--devices", "2"],
])
def test_unported_flags_raise(tiny_scene, tmp_path, flags):
    """--shard tiles|spp over --devices 2 (the port's mesh: the CPU
    twice; the JAX CLI's: 2 of the 8 virtual CPU devices) renders as the
    JAX CLI does; --devices without --shard is accepted and ignored, as
    there."""
    common = [tiny_scene, "--spp", "4", "--size", "32x24", "--quiet",
              *flags]
    assert _jax_main([*common, "--out", str(tmp_path / "j.png"),
                      "--hdr-out", str(tmp_path / "j.exr")]) == 0
    stats = {}
    assert cli.main([*common, "--out", str(tmp_path / "t.png"), "--hdr-out",
                     str(tmp_path / "t.exr"), "--device", "cpu"],
                    stats=stats) == 0
    assert stats["spp"] == 4
    assert_images_close(_read_png(tmp_path / "t.png"),
                        _read_png(tmp_path / "j.png"))
    rad = image_io.read_exr_rgb(str(tmp_path / "t.exr"))
    assert np.isfinite(rad).all()
    assert_radiance_close(rad, image_io.read_exr_rgb(str(tmp_path / "j.exr")))


def test_shard_logs_its_mesh_and_resumes(tiny_scene, tmp_path, capsys):
    """The JAX CLI's log line names the axis and the mesh size; a sharded
    run checkpoints and resumes to the uninterrupted run's radiance."""
    ck = str(tmp_path / "ck.npz")
    common = [tiny_scene, "--shard", "spp", "--devices", "2", "--device",
              "cpu", "--checkpoint", ck, "--checkpoint-every", "2"]
    assert cli.main([*common, "--spp", "2", "--out",
                     str(tmp_path / "a.png")]) == 0
    assert "sharding: spp over 2 devices" in capsys.readouterr().out
    assert cli.main([*common, "--spp", "4", "--out", str(tmp_path / "b.png"),
                     "--hdr-out", str(tmp_path / "b.exr")]) == 0
    assert "resumed from checkpoint at 2 spp" in capsys.readouterr().out
    assert cli.main([tiny_scene, "--shard", "spp", "--devices", "2",
                     "--device", "cpu", "--spp", "4", "--quiet", "--out",
                     str(tmp_path / "c.png"), "--hdr-out",
                     str(tmp_path / "c.exr")]) == 0
    assert np.array_equal(image_io.read_exr_rgb(str(tmp_path / "b.exr")),
                          image_io.read_exr_rgb(str(tmp_path / "c.exr")))


@pytest.mark.parametrize("kind", ["cloud", "vdb", "vol", "npy"])
def test_volume_flag_renders(tiny_scene, tmp_path, kind):
    """--volume attaches a heterogeneous medium, as the JAX CLI's does:
    the procedural cloud, or a .vdb, .vol or .npy grid (a .npy spans the
    unit box). The render is finite and the medium changes it."""
    from tracerboy_tpu_torch.scene import vdb, volume

    arg = "cloud"
    if kind != "cloud":
        vol = volume.procedural_cloud(8)
        arg = str(tmp_path / f"c.{kind}")
        if kind == "vdb":
            vdb.write_vdb(arg, vol)
        elif kind == "vol":
            volume.write_vol(arg, vol)
        else:
            np.save(arg, vol.density)

    def run(name, extra):
        assert cli.main([tiny_scene, "--device", "cpu", "--spp", "2",
                         "--quiet", "--out", str(tmp_path / f"{name}.png"),
                         "--hdr-out", str(tmp_path / f"{name}.exr"),
                         *extra]) == 0
        return image_io.read_exr_rgb(str(tmp_path / f"{name}.exr"))

    foggy = run("foggy", ["--volume", arg])
    clear = run("clear", [])
    assert foggy.shape == (24, 32, 3) and np.isfinite(foggy).all()
    assert np.abs(foggy - clear).max() > 1e-3


def test_export_pbf_matches_the_jax_cli(tiny_scene, tmp_path, capsys):
    """--export-pbf writes the JAX CLI's bytes and exits 0 without a
    render; the port's CLI renders the .pbf as it renders the scene file
    (the radiance bound of test_render_matches_the_jax_cli)."""
    from test_torch_instanced import write

    for i, scene in enumerate((tiny_scene, write(tmp_path, "two_objects"))):
        port, ref = tmp_path / f"port{i}.pbf", tmp_path / f"jax{i}.pbf"
        assert cli.main([scene, "--export-pbf", str(port),
                         "--out", str(tmp_path / "none.png")]) == 0
        assert f"wrote {port}" in capsys.readouterr().out
        assert _jax_main([scene, "--export-pbf", str(ref)]) == 0
        assert port.read_bytes() == ref.read_bytes()
        assert not (tmp_path / "none.png").exists()
    port = tmp_path / "port0.pbf"
    common = ["--spp", "2", "--size", "32x24", "--quiet", "--device", "cpu"]
    cli.main([tiny_scene, *common, "--out", str(tmp_path / "a.png"),
              "--hdr-out", str(tmp_path / "a.exr")])
    cli.main([str(port), *common, "--out", str(tmp_path / "b.png"),
              "--hdr-out", str(tmp_path / "b.exr")])
    assert_radiance_close(image_io.read_exr_rgb(str(tmp_path / "b.exr")),
                          image_io.read_exr_rgb(str(tmp_path / "a.exr")))


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_cli_checkpoint_resumes_across_packages(tiny_scene, tmp_path, first,
                                                second):
    """One package renders 2 samples into --checkpoint; the other resumes
    it to 4. The result equals the JAX CLI's straight 4-sample render."""
    run = {"jax": _jax_main,
           "port": lambda a: cli.main([*a, "--device", "cpu"])}
    ck = str(tmp_path / "ck.npz")
    base = [tiny_scene, "--quiet", "--checkpoint", ck]
    assert run[first]([*base, "--spp", "2", "--out",
                       str(tmp_path / "a.png")]) == 0
    assert int(np.load(ck)["spp"]) == 2
    assert run[second]([*base, "--spp", "4", "--out", str(tmp_path / "b.png"),
                        "--hdr-out", str(tmp_path / "b.exr")]) == 0
    assert int(np.load(ck)["spp"]) == 4
    assert _jax_main([tiny_scene, "--quiet", "--spp", "4", "--out",
                      str(tmp_path / "r.png"), "--hdr-out",
                      str(tmp_path / "r.exr")]) == 0
    assert_images_close(_read_png(tmp_path / "b.png"),
                        _read_png(tmp_path / "r.png"))
    assert_radiance_close(image_io.read_exr_rgb(str(tmp_path / "b.exr")),
                          image_io.read_exr_rgb(str(tmp_path / "r.exr")))


def _history(rng, h, w):
    def z(c=3):
        return rng.random((h, w, c)).astype(np.float32)

    return dict(indirect=z(), moments=z(), final=z(), prev_world_pos=z(4),
                raw=z(), aovs=dict(albedo=z(), normal=z(), world_pos=z(4),
                                   emissive=z(), diffuse_contrib=z()))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.cpu() if isinstance(
                v, torch.Tensor) else v)
    return out


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape and fa[k].tobytes() == \
            fb[k].tobytes(), k


def test_checkpoint_from_jax_resumes_in_the_port(tiny_scene, tmp_path):
    """A JAX checkpoint with accumulators, a RealTime history, the previous
    camera and the governor's pad: the port takes every array bit for bit,
    and its next samples continue the JAX render."""
    import jax

    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.post.realtime import FrameRateGovernor
    from tracerboy_tpu.utils.checkpoint import save_render_checkpoint
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.utils.checkpoint import load_render_checkpoint

    ck = str(tmp_path / "ck.npz")
    jr = JaxRenderer(tiny_scene)
    jr.render_sample(2)
    hist = _history(np.random.default_rng(5), jr.height, jr.width)
    jr._rt_hist_fused = jax.tree_util.tree_map(jax.numpy.asarray, hist)
    jr._cam_prev = jr.scene_pytree["camera"]
    jr._governor = FrameRateGovernor(target_fps=30.0, pad=0.1)
    jr._governor.pad = 0.0625
    save_render_checkpoint(ck, jr)

    r = Renderer(tiny_scene, device="cpu")
    assert load_render_checkpoint(ck, r)
    st = jr.state
    assert r.state.spp == st.spp == 2
    for got, ref in ((r.state.accum, st.accum),
                     (r.state.accum_jittered, st.accum_jittered),
                     (r.state.world_pos[0], st.world_pos[0]),
                     (r.state.world_pos[1], st.world_pos[1])):
        assert got.numpy().tobytes() == np.asarray(ref).tobytes()
    _assert_same_tree(r._rt_hist_fused, hist)
    _assert_same_tree(r._cam_prev, jax.tree_util.tree_map(
        np.asarray, jr.scene_pytree["camera"]))
    assert r._governor.pad == 0.0625
    jr.render_sample(2)
    r.render_sample(2)
    assert_radiance_close(r.state.accum.numpy(), np.asarray(jr.state.accum))


def test_checkpoint_from_the_port_resumes_in_jax(tiny_scene, tmp_path):
    """A port checkpoint after two fused RealTime frames: the JAX package
    restores its accumulators, reads its temporal history and previous
    camera into the JAX structures bit for bit, and keeps the pad."""
    import jax

    from tracerboy_tpu import Renderer as JaxRenderer
    from tracerboy_tpu.utils.checkpoint import (
        _unflatten_tree,
        load_render_checkpoint,
    )
    from tracerboy_tpu_torch import OutputSettings, Renderer, RenderMode
    from tracerboy_tpu_torch.utils.checkpoint import save_render_checkpoint

    ck = str(tmp_path / "ck.npz")
    r = Renderer(tiny_scene, device="cpu", settings=OutputSettings(
        render_mode=RenderMode.REAL_TIME))
    r.render_realtime_frame_fused()
    r.render_realtime_frame_fused()
    r.render_sample(1)
    save_render_checkpoint(ck, r)

    jr = JaxRenderer(tiny_scene)
    assert load_render_checkpoint(ck, jr)
    assert jr.state.spp == r.state.spp == 3
    assert np.asarray(jr.state.accum).tobytes() == \
        r.state.accum.numpy().tobytes()
    # The JAX renderer defers the history to its next fused frame; its own
    # reader gives the port's arrays in the JAX structure.
    assert jr._rt_checkpoint_pending == ck
    z = np.load(ck)
    like = _history(np.random.default_rng(0), jr.height, jr.width)
    _assert_same_tree(_unflatten_tree("rt_hist", like, z),
                      r._rt_hist_fused)
    cam_like = jax.tree_util.tree_map(np.asarray, jr.scene_pytree["camera"])
    _assert_same_tree(_unflatten_tree("cam_prev", cam_like, z), r._cam_prev)
    assert jr._governor_pad_pending == r._governor.pad
    assert bytes(z["rt_hist.__treedef__"]) == str(
        jax.tree_util.tree_structure(like)).encode()


def test_checkpoint_of_another_film_size_is_ignored(tiny_scene, tmp_path):
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.utils.checkpoint import (
        load_render_checkpoint,
        save_render_checkpoint,
    )

    ck = str(tmp_path / "ck.npz")
    r = Renderer(tiny_scene, device="cpu")
    r.render_sample(1)
    save_render_checkpoint(ck, r)
    other = Renderer(tiny_scene, film_size=(16, 12), device="cpu")
    assert not load_render_checkpoint(ck, other)
    assert other.state.spp == 0
    assert not load_render_checkpoint(str(tmp_path / "absent.npz"), r)


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def ply_scene(tmp_path):
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    return write_demo_scene(str(tmp_path), grid=224, sky=(128, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["env", "lit"])
def test_cli_launches_the_kernels_on_the_card(cuda_device, ply_scene,
                                              tmp_path, which):
    scene = ply_scene[0 if which == "env" else 1]
    kernels.reset_counters()
    assert cli.main([scene, "--size", "320x180", "--spp", "4", "--out",
                     str(tmp_path / "o.png"), "--hdr-out",
                     str(tmp_path / "o.exr"), "--quiet"]) == 0
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["closest"] > 0 and kernels.LAUNCHES["anyhit"] > 0
    assert kernels.TWIN_CALLS["closest"] == kernels.TWIN_CALLS["anyhit"] == 0
    assert kernels.stack_overflows() == 0
    rad = image_io.read_exr_rgb(str(tmp_path / "o.exr"))
    assert rad.shape == (180, 320, 3) and np.isfinite(rad).all()
    assert rad.mean() > 0


@pytest.mark.cuda
def test_env_nee_waves_equal_their_plain_version(cuda_device, ply_scene,
                                                 monkeypatch):
    """Every any-hit launch of an env-lit render (no light records, so
    each is an env-NEE shadow wave; M = 3: one wave of 3 x lanes rays)
    against traverse.anyhit_plain on the same rays."""
    import dataclasses

    from tracerboy_tpu_torch import Renderer

    calls = []
    real = traverse.any_hit

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        calls.append((o.clone(), d.clone(), t_max.clone(), nodes, tris_bw))
        return real(o, d, t_max, nodes, tris_bw, roots)

    r = Renderer(ply_scene[0], film_size=(160, 90), device="cuda")
    r.settings = r.settings.replace(
        performance_settings=dataclasses.replace(
            r.settings.performance_settings, environment_nee_samples=3))
    assert r.compiled.num_lights == 0 and r.wave_config().env_nee
    monkeypatch.setattr(traverse, "any_hit", recording)
    r.render_sample(2)
    monkeypatch.setattr(traverse, "any_hit", real)
    assert calls and calls[0][0].shape[0] == 3 * 2 * 160 * 90
    kernels.reset_counters()
    for o, d, tm, nodes, tris in calls:
        assert torch.equal(real(o, d, tm, nodes, tris),
                           traverse.anyhit_plain(o, d, tm, nodes, tris))
    assert kernels.stack_overflows() == 0
