"""The port's JPEG decoder on the card's machine, which has no PIL: every
fixture of tests/data/jpeg (PIL's saves, arithmetic-coded sequential and
progressive files, lossless files of every predictor, block-smoothed
cut progressive files, the arithmetic-coded albedo) decodes to the
shape, dtype and sha256 of PIL's array in its manifest
(tests/make_jpeg_fixtures.py wrote both), and a decoded texture uploads
to the card unchanged; so does every CMYK and
YCCK JPEG of tests/data/small3 and every BLP1 there whose JPEG has four
components (tests/make_small3_fixtures.py).

Under the `cuda` marker (skipped without a card). This module imports no
jax and no PIL: `python -m pytest --noconftest -m cuda
tests/test_torch_jpeg_cuda.py`.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.core.jpeg import read_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES3 = os.path.join(os.path.dirname(FIXTURES), "small3")
with open(os.path.join(FIXTURES3, "manifest.json")) as f:
    MANIFEST3 = json.load(f)
CMYK = sorted(n for n in MANIFEST3["files"]
              if n.startswith(("cmyk_", "ycck_", "blp1_", "albedo_")))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_hash_matches_pil(cuda_device, name):
    arr = read_jpeg(os.path.join(FIXTURES, name))
    entry = MANIFEST["files"][name]
    assert list(arr.shape) == entry["shape"]
    assert str(arr.dtype) == entry["dtype"]
    assert hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest() \
        == entry["sha256"]
    tex = torch.from_numpy(image_io.read_ldr(os.path.join(FIXTURES, name)))
    assert torch.equal(tex.to(cuda_device).cpu(), tex)
    assert torch.equal((tex * 255).round().to(torch.uint8),
                       torch.from_numpy(arr))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CMYK)
def test_cmyk_fixture_hash_matches_pil(cuda_device, name):
    path = os.path.join(FIXTURES3, name)
    arr = image_io.decode_ldr(path)
    entry = MANIFEST3["files"][name]
    assert [list(arr.shape), str(arr.dtype)] == [entry["shape"],
                                                 entry["dtype"]]
    assert hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest() \
        == entry["sha256"]
    tex = torch.from_numpy(image_io.read_ldr(path))
    assert torch.equal(tex.to(cuda_device).cpu(), tex)
