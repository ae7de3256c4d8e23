"""The port's readers of PIL's small texture formats on the card's
machine, which has no PIL: every fixture of tests/data/small decodes to
the shape, dtype and sha256 of PIL's array in its manifest
(tests/make_small_fixtures.py wrote both), and so do the textures
utils/demo_scene.write_small_textures writes there (the manifest's
"generated" entries: each file's sha256 and PIL's pixels; an ICNS's PNG
is compared by its pixels, as another zlib may write other bytes),
csrc/small_decode.cpp built at first use; the textured demo scene with
its albedo an RLE SGI and its leaf a DXT5 BLP2, whose alpha makes the
cutouts, renders on the card with every closest-hit launch of kernel 1
held against its plain version, as tests/test_torch_avif_cuda.py holds
the AVIF scene's.

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

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "small")
with open(os.path.join(FIXTURES, "manifest.json")) as f:
    MANIFEST = json.load(f)


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
