"""The port's AVIF reader on the card's machine, which has no PIL, no
libavif and no AV1 library: every fixture of tests/data/avif decodes to
the shape, dtype and sha256 of PIL's array in its manifest
(tests/make_avif_fixtures.py wrote both; the in-loop filters' fixtures
among them), and the textured demo scene with its albedo and RGBA leaf
Pillow's default saves (the in-loop filters on), whose deblocked alpha
item makes the cutouts, again with its albedo a plain Image.save (intra
block copy) and its leaf a save with film grain (its alpha item's too),
and again with its albedo a grid image through libavif's float routines
and its leaf colour and alpha grids (also through the CLI), renders on
the card with every closest-hit launch of kernel 1
(main waves, alpha re-fires, shadow-BVH rounds) held against its plain
version: hits equal, t to 1e-6 relative, ids equal but on at most 1e-4
of the hit lanes (ties), no stack overflow.

Under the `cuda` marker (skipped without a card). This module imports no
jax and no PIL: `python -m pytest --noconftest -m cuda
tests/test_torch_avif_cuda.py`.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.core import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "avif")
with open(os.path.join(FIXTURES, "manifest.json")) as f:
    MANIFEST = json.load(f)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_hash_matches_pil(cuda_device, name):
    arr = image_io.decode_ldr(os.path.join(FIXTURES, name))
    entry = MANIFEST["files"][name]
    assert list(arr.shape) == entry["shape"]
    assert str(arr.dtype) == entry["dtype"]
    assert hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest() \
        == entry["sha256"]
    tex = torch.from_numpy(image_io.read_ldr(os.path.join(FIXTURES, name)))
    assert torch.equal(tex.to(cuda_device).cpu(), tex)


@pytest.mark.cuda
def test_avif_scene_launches_equal_their_plain_version(cuda_device, tmp_path,
                                                      monkeypatch):
    scene_launches_check(tmp_path, monkeypatch, "albedo_default.avif",
                         "leaf_default.avif")


@pytest.mark.cuda
def test_copy_grain_scene_launches_equal_their_plain_version(
        cuda_device, tmp_path, monkeypatch):
    scene_launches_check(tmp_path, monkeypatch, "albedo_plain.avif",
                         "leaf_grain.avif")


@pytest.mark.cuda
def test_grid_scene_launches_equal_their_plain_version(
        cuda_device, tmp_path, monkeypatch):
    scene_launches_check(tmp_path, monkeypatch, "albedo_grid.avif",
                         "leaf_grid.avif")


@pytest.mark.cuda
def test_grid_scene_cli_run(cuda_device, tmp_path):
    """The CLI on the grid scene (albedo a 3x3 grid through libavif's
    float routines, leaf colour and alpha grids) at 320x180, 2 spp: exit
    0, a finite image in [0, 1], closest-hit launches of kernel 1 and no
    any-hit launch (the cutouts make every shadow wave a closest-hit
    march)."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=64, sky=(64, 32),
                                    leaves=512, albedo=8, normal=64,
                                    leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURES, "albedo_grid.avif"),
                    "leaf.png": os.path.join(FIXTURES, "leaf_grid.avif")})
    out = str(tmp_path / "grid.png")
    kernels.reset_counters()
    assert cli.main([lit, "--size", "320x180", "--spp", "2", "--out", out,
                     "--quiet"]) == 0
    assert kernels.LAUNCHES["closest"] > 0
    assert kernels.LAUNCHES["anyhit"] == 0
    img = image_io.read_ldr(out)
    assert img.shape[:2] == (180, 320) and np.isfinite(img).all()
    assert 0.0 < img[..., :3].mean() < 1.0


def scene_launches_check(tmp_path, monkeypatch, albedo, leaf):
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=64, sky=(64, 32),
                                    leaves=512, albedo=8, normal=64,
                                    leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURES, albedo),
                    "leaf.png": os.path.join(FIXTURES, leaf)})
    calls = []
    real = traverse.closest_hit

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        calls.append((o.clone(), d.clone(), t_max.clone(), nodes, tris_bw))
        return real(o, d, t_max, nodes, tris_bw, roots)

    r = Renderer(lit, film_size=(320, 180), device="cuda")
    assert r.traversal == "kernel" and r.wave_config().has_alpha
    kernels.reset_counters()
    monkeypatch.setattr(traverse, "closest_hit", recording)
    r.render_sample(1)
    monkeypatch.setattr(traverse, "closest_hit", real)
    assert kernels.LAUNCHES["closest"] == len(calls) > 0
    assert kernels.LAUNCHES["anyhit"] == 0
    assert torch.isfinite(r.resolve_radiance()).all()
    refire = [c for c in calls if c[3] is r.scene["pk_nodes"]
              and (c[2] == 0).float().mean() > 0.5]
    assert refire, "no alpha re-fire launch"
    kernels.reset_counters()
    for o, d, tm, nodes, tris in calls:
        t_k, tri_k, _, _ = real(o, d, tm, nodes, tris)
        t_p, tri_p, _, _ = traverse.closest_hit_plain(o, d, tm, nodes, tris)
        assert torch.equal(tri_k >= 0, tri_p >= 0)
        both = (tri_k >= 0) & (tri_p >= 0)
        if not both.any():
            continue
        rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
        assert rel.max().item() <= 1e-6
        assert (tri_k != tri_p)[both].float().mean().item() <= 1e-4
    assert kernels.stack_overflows() == 0
