"""The port's JPEG decoder on the card's machine, which has no PIL: every
fixture of tests/data/jpeg decodes to the shape, dtype and sha256 of
PIL's array in its manifest (tests/make_jpeg_fixtures.py wrote both), and
a decoded texture uploads to the card unchanged.

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
