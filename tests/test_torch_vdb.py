"""The port's OpenVDB reader and writer (tracerboy_tpu_torch/scene/vdb.py, a
jax-free copy of tracerboy_tpu/scene/vdb.py) against the JAX package's, on
the seeded grids of tests/test_vdb.py: every compression mode, half
precision, a grid over several internal nodes, grid-name selection, and
files written by either package read by the other. Tolerance: none; the
files are byte-equal and the grids bit-equal (half precision: equal to
the float16 rounding of the grid, in both packages).
"""

import numpy as np
import pytest

from tracerboy_tpu.scene import vdb as jax_vdb
from tracerboy_tpu.scene.volume import VolumeIR as JaxVolumeIR
from tracerboy_tpu_torch.scene import vdb
from tracerboy_tpu_torch.scene.volume import VolumeIR, load_volume

MODES = {
    "zip_active_mask": vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK,
    "zip": vdb.COMPRESS_ZIP,
    "active_mask": vdb.COMPRESS_ACTIVE_MASK,
    "none": vdb.COMPRESS_NONE,
}


def _cloud(shape=(24, 20, 17), seed=0):
    """tests/test_vdb.py's grid: a soft ball with ~60% zero voxels."""
    d, h, w = shape
    z, y, x = np.meshgrid(np.linspace(-1, 1, d), np.linspace(-1, 1, h),
                          np.linspace(-1, 1, w), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    dens = np.maximum(0.0, 0.7 - r).astype(np.float32) * 3.0
    dens *= (np.random.default_rng(seed).random(shape) > 0.2)
    return dict(density=dens, lo=np.array([-1.0, -2.0, 0.5], np.float32),
                hi=np.array([1.5, 0.0, 2.5], np.float32))


def _both(tmp_path, grid, **kw):
    """The grid written by each package: (port path, JAX path)."""
    port, ref = str(tmp_path / "port.vdb"), str(tmp_path / "jax.vdb")
    vdb.write_vdb(port, VolumeIR(**grid), **kw)
    jax_vdb.write_vdb(ref, JaxVolumeIR(**grid), **kw)
    return port, ref


def _assert_reads_equal(paths, want, **kw):
    """Each file read by both packages: the same grid and box, bit for
    bit, and the grid is `want`."""
    for path in paths:
        ref = jax_vdb.read_vdb(path, **kw)
        got = vdb.read_vdb(path, **kw)
        np.testing.assert_array_equal(ref.density, want)
        for field in ("density", "lo", "hi"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(ref, field))


@pytest.mark.parametrize("mode", list(MODES))
def test_compression_modes_match_jax(tmp_path, mode):
    grid = _cloud()
    port, ref = _both(tmp_path, grid, compression=MODES[mode])
    assert open(port, "rb").read() == open(ref, "rb").read()
    _assert_reads_equal((port, ref), grid["density"])
    back = vdb.read_vdb(port)
    np.testing.assert_allclose(back.lo, grid["lo"], atol=1e-6)
    np.testing.assert_allclose(back.hi, grid["hi"], atol=1e-6)


def test_half_precision_matches_jax(tmp_path):
    grid = _cloud()
    port, ref = _both(tmp_path, grid, half=True)
    assert open(port, "rb").read() == open(ref, "rb").read()
    _assert_reads_equal(
        (port, ref), grid["density"].astype(np.float16).astype(np.float32))


def test_multiple_internal_nodes_match_jax(tmp_path):
    """More than 128 voxels on one axis: several Internal16 children."""
    rng = np.random.default_rng(3)
    dens = (rng.random((9, 10, 200)).astype(np.float32)
            * (rng.random((9, 10, 200)) > 0.5))
    grid = dict(density=dens, lo=np.zeros(3, np.float32),
                hi=np.array([20.0, 1.0, 1.0], np.float32))
    port, ref = _both(tmp_path, grid)
    assert open(port, "rb").read() == open(ref, "rb").read()
    _assert_reads_equal((port, ref), dens)


def test_grid_name_selection_matches_jax(tmp_path):
    grid = _cloud(seed=4)
    port, ref = _both(tmp_path, grid, grid_name="smoke")
    assert open(port, "rb").read() == open(ref, "rb").read()
    _assert_reads_equal((port, ref), grid["density"], grid_name="smoke")
    for reader in (vdb.read_vdb, jax_vdb.read_vdb):
        with pytest.raises(ValueError, match="not found"):
            reader(port, grid_name="temperature")


def test_rejects_non_vdb(tmp_path):
    p = tmp_path / "bogus.vdb"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not a .vdb"):
        vdb.read_vdb(str(p))


def test_load_volume_dispatches_vdb(tmp_path):
    """load_volume takes .vdb (it was refused before the port had a
    reader); a file the JAX package wrote reads back bit for bit."""
    grid = _cloud(seed=7)
    _, ref = _both(tmp_path, grid)
    back = load_volume(ref)
    np.testing.assert_array_equal(back.density, grid["density"])
    np.testing.assert_array_equal(back.lo, jax_vdb.read_vdb(ref).lo)
    np.testing.assert_array_equal(back.hi, jax_vdb.read_vdb(ref).hi)
