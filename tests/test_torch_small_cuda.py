"""The port's readers of PIL's small texture formats on the card's
machine, which has no PIL: every fixture of tests/data/small and
tests/data/small2 decodes to the shape, dtype and sha256 of PIL's array
in its manifest (tests/make_small_fixtures.py and
tests/make_small2_fixtures.py wrote them), and so do the textures
utils/demo_scene.write_small_textures and write_small2_textures write
there (the manifests' "generated" entries: each file's sha256 and PIL's
pixels; an ICNS's PNG is compared by its pixels, as another zlib may
write other bytes),
csrc/small_decode.cpp built at first use; the textured demo scene with
its albedo an RLE SGI and its leaf a DXT5 BLP2, whose alpha makes the
cutouts, renders on the card with every closest-hit launch of kernel 1
held against its plain version, as tests/test_torch_avif_cuda.py holds
the AVIF scene's, and so does the scene with its albedo a Sun RLE and its
leaf an RGBA IM. Part 3 the same way: tests/data/small3's fixtures
(FITS, FLI, IPTC, CMYK and YCCK JPEGs and their BLP1s),
write_small3_textures' files (a gzip FITS compared by its pixels, as
another zlib may write other bytes), and the scene with its albedo the
committed BLP1 whose JPEG is a CMYK JPEG.

Under the `cuda` marker (skipped without a card). This module imports no
jax and no PIL: `python -m pytest --noconftest -m cuda
tests/test_torch_small_cuda.py`.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from test_torch_avif_cuda import cuda_device  # noqa: F401 (a fixture)
from test_torch_avif_cuda import scene_launches_check
from tracerboy_tpu_torch.core import image_io

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = os.path.join(DATA, "small")
FIXTURES2 = os.path.join(DATA, "small2")
FIXTURES3 = os.path.join(DATA, "small3")
with open(os.path.join(FIXTURES, "manifest.json")) as f:
    MANIFEST = json.load(f)
with open(os.path.join(FIXTURES2, "manifest.json")) as f:
    MANIFEST2 = json.load(f)
with open(os.path.join(FIXTURES3, "manifest.json")) as f:
    MANIFEST3 = json.load(f)


def digest(arr) -> dict:
    return dict(shape=list(arr.shape), dtype=str(arr.dtype),
                sha256=hashlib.sha256(
                    np.ascontiguousarray(arr).tobytes()).hexdigest())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_hash_matches_pil(cuda_device, name):
    arr = image_io.decode_ldr(os.path.join(FIXTURES, name))
    assert digest(arr) == MANIFEST["files"][name]


@pytest.fixture(scope="module")
def small_textures(tmp_path_factory):
    from tracerboy_tpu_torch.utils.demo_scene import write_small_textures

    return write_small_textures(str(tmp_path_factory.mktemp("small")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST["generated"]))
def test_written_textures_match_pil(cuda_device, small_textures, name):
    entry = dict(MANIFEST["generated"][name])
    path = small_textures[name]
    got = digest(image_io.decode_ldr(path))
    with open(path, "rb") as f:
        got["file_sha256"] = hashlib.sha256(f.read()).hexdigest()
    if name.endswith(".icns"):
        got["file_sha256"] = entry["file_sha256"]
    assert got == entry


@pytest.mark.cuda
def test_small_scene_launches_equal_their_plain_version(
        cuda_device, small_textures, tmp_path, monkeypatch):
    scene_launches_check(tmp_path, monkeypatch, small_textures["albedo.sgi"],
                         small_textures["leaf.blp"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST2["files"]))
def test_small2_fixture_hash_matches_pil(cuda_device, name):
    arr = image_io.decode_ldr(os.path.join(FIXTURES2, name))
    assert digest(arr) == MANIFEST2["files"][name]


@pytest.fixture(scope="module")
def small2_textures(tmp_path_factory):
    from tracerboy_tpu_torch.utils.demo_scene import write_small2_textures

    return write_small2_textures(str(tmp_path_factory.mktemp("small2")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST2["generated"]))
def test_small2_written_textures_match_pil(cuda_device, small2_textures,
                                           name):
    path = small2_textures[name]
    got = digest(image_io.decode_ldr(path))
    with open(path, "rb") as f:
        got["file_sha256"] = hashlib.sha256(f.read()).hexdigest()
    assert got == MANIFEST2["generated"][name]


@pytest.mark.cuda
def test_small2_scene_launches_equal_their_plain_version(
        cuda_device, small2_textures, tmp_path, monkeypatch):
    scene_launches_check(tmp_path, monkeypatch, small2_textures["albedo.ras"],
                         small2_textures["leaf.im"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST3["files"]))
def test_small3_fixture_hash_matches_pil(cuda_device, name):
    arr = image_io.decode_ldr(os.path.join(FIXTURES3, name))
    assert digest(arr) == MANIFEST3["files"][name]


@pytest.fixture(scope="module")
def small3_textures(tmp_path_factory):
    from tracerboy_tpu_torch.utils.demo_scene import write_small3_textures

    return write_small3_textures(str(tmp_path_factory.mktemp("small3")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST3["generated"]))
def test_small3_written_textures_match_pil(cuda_device, small3_textures,
                                           name):
    entry = dict(MANIFEST3["generated"][name])
    path = small3_textures[name]
    got = digest(image_io.decode_ldr(path))
    with open(path, "rb") as f:
        got["file_sha256"] = hashlib.sha256(f.read()).hexdigest()
    if name == "albedo_gzip.fits":
        got["file_sha256"] = entry["file_sha256"]
    assert got == entry


@pytest.mark.cuda
def test_small3_scene_launches_equal_their_plain_version(
        cuda_device, tmp_path, monkeypatch):
    from tracerboy_tpu_torch.utils.demo_scene import (
        SMALL3_ALBEDO,
        leaf_image,
    )

    leaf = tmp_path / "png" / "leaf.png"
    leaf.parent.mkdir()
    image_io.write_png(str(leaf), leaf_image(8))
    scene_launches_check(tmp_path / "scene", monkeypatch, SMALL3_ALBEDO,
                         str(leaf))
