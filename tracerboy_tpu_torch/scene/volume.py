"""Heterogeneous volume grids: loading + scene attachment.

The reference's openvdb path (TracerBoy.cpp:1096-1184, compile-disabled
via USE_OPENVDB 0 in pch.h:5) loads one density grid into an R32 3D
texture plus world bounds (m_volumeMin/Max, TracerBoy.h:733) — and stops
there; no shader ever samples it. This module provides the same
capability TPU-natively (a dense density grid + bounds on the scene
pytree) and the wavefront actually renders it (delta-tracking medium,
trace/wavefront.py), going past the reference's parked implementation.

Sources accepted:
- pbrt `MakeNamedMedium "n" "string type" "heterogeneous"` with inline
  `"float density"` + `"integer nx/ny/nz"` + `"point p0/p1"` (the
  pbrt-v3 grid medium), `sigma_a`, `sigma_s`, `scale`, `g`;
- Mitsuba `.vol` binary grids (the common exchange format for openvdb
  clouds; header per the Mitsuba 0.5 docs);
- raw `.npy` (D, H, W) float arrays (bounds given separately);
- a procedural test cloud.

A numpy copy of tracerboy_tpu/scene/volume.py; OpenVDB grids are read by
the port's own copy of the JAX package's reader (scene/vdb.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class VolumeIR:
    """One heterogeneous medium: density grid in a world-space box.

    density is indexed [z, y, x] over the box lo..hi (z maps to the
    world z extent). sigma_a / sigma_s are per-channel coefficients at
    density 1.0 (pbrt semantics, pre-multiplied by `scale`); g is the
    Henyey-Greenstein anisotropy.
    """

    density: np.ndarray                  # (D, H, W) float32
    lo: np.ndarray                       # (3,) world min
    hi: np.ndarray                       # (3,) world max
    sigma_a: np.ndarray = field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5], np.float32))
    sigma_s: np.ndarray = field(
        default_factory=lambda: np.array([8.0, 8.0, 8.0], np.float32))
    g: float = 0.0

    @property
    def max_density(self) -> float:
        return float(self.density.max())

    def sigma_t_majorant(self) -> float:
        """Majorant extinction for delta tracking: max density x the
        largest per-channel sigma_t."""
        st = (self.sigma_a + self.sigma_s).max()
        return float(self.max_density * st)


def read_vol(path: str) -> VolumeIR:
    """Read a Mitsuba `.vol` binary grid (format 3 = float32).

    Layout (little-endian): 'VOL' + uint8 version(3) + int32 type(1) +
    int32 xres,yres,zres + int32 channels + 6 float32 bbox
    (xmin,ymin,zmin,xmax,ymax,zmax) + data x*y*z*channels float32
    (x fastest).
    """
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"not a .vol file: {path}")
        (version,) = struct.unpack("<B", f.read(1))
        if version != 3:
            raise ValueError(f"unsupported .vol version {version}")
        enc, xres, yres, zres, channels = struct.unpack("<5i", f.read(20))
        if enc != 1:
            raise ValueError(f"unsupported .vol encoding {enc} (want f32)")
        bbox = struct.unpack("<6f", f.read(24))
        n = xres * yres * zres * channels
        data = np.frombuffer(f.read(n * 4), dtype="<f4", count=n)
    grid = data.reshape(zres, yres, xres, channels)[..., 0]
    return VolumeIR(
        density=np.ascontiguousarray(grid, np.float32),
        lo=np.array(bbox[:3], np.float32),
        hi=np.array(bbox[3:], np.float32),
    )


def write_vol(path: str, vol: VolumeIR) -> None:
    """Write a Mitsuba `.vol` (round-trip partner of read_vol)."""
    d, h, w = vol.density.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(struct.pack("<B", 3))
        f.write(struct.pack("<5i", 1, w, h, d, 1))
        f.write(struct.pack("<6f", *vol.lo.tolist(), *vol.hi.tolist()))
        f.write(np.ascontiguousarray(
            vol.density, np.float32).tobytes())


def read_npy(path: str, lo, hi) -> VolumeIR:
    """Raw (D, H, W) float .npy density with explicit world bounds."""
    grid = np.load(path).astype(np.float32)
    if grid.ndim != 3:
        raise ValueError(f"expected a 3D density grid, got {grid.shape}")
    return VolumeIR(density=grid, lo=np.asarray(lo, np.float32),
                    hi=np.asarray(hi, np.float32))


def from_pbrt_medium(params: dict) -> VolumeIR | None:
    """Build a VolumeIR from pbrt-v3 `MakeNamedMedium ... "string type"
    "heterogeneous"` parameters (nx/ny/nz + density + p0/p1)."""
    nx = int(np.asarray(params.get("nx", 0)).reshape(-1)[0] or 0)
    ny = int(np.asarray(params.get("ny", 0)).reshape(-1)[0] or 0)
    nz = int(np.asarray(params.get("nz", 0)).reshape(-1)[0] or 0)
    density = params.get("density")
    if not (nx and ny and nz) or density is None:
        return None
    grid = np.asarray(density, np.float32).reshape(nz, ny, nx)
    p0 = np.asarray(params.get("p0", [0, 0, 0]), np.float32).reshape(3)
    p1 = np.asarray(params.get("p1", [1, 1, 1]), np.float32).reshape(3)
    scale = float(np.asarray(params.get("scale", 1.0)).reshape(-1)[0])
    sigma_a = np.asarray(
        params.get("sigma_a", [1.0, 1.0, 1.0]), np.float32
    ).reshape(3) * scale
    sigma_s = np.asarray(
        params.get("sigma_s", [1.0, 1.0, 1.0]), np.float32
    ).reshape(3) * scale
    g = float(np.asarray(params.get("g", 0.0)).reshape(-1)[0])
    return VolumeIR(density=grid, lo=p0, hi=p1,
                    sigma_a=sigma_a, sigma_s=sigma_s, g=g)


def procedural_cloud(n: int = 32, seed: int = 0) -> VolumeIR:
    """Pyroclastic-ish test cloud: a soft sphere modulated by value
    noise, in a unit box. Deterministic for tests."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(
        *(np.linspace(-1, 1, n, dtype=np.float32),) * 3, indexing="ij"
    )
    r = np.sqrt(x * x + y * y + z * z)
    base = np.clip(1.0 - r, 0.0, 1.0)
    # Cheap tri-linear value noise at two octaves.
    def noise(k):
        g = rng.random((k, k, k)).astype(np.float32)
        idx = np.linspace(0, k - 1, n)
        i0 = np.floor(idx).astype(np.int32)
        f = (idx - i0).astype(np.float32)
        i1 = np.minimum(i0 + 1, k - 1)
        def lerp1(a, axis):
            sl0 = [slice(None)] * 3
            sl1 = [slice(None)] * 3
            out = np.take(a, i0, axis=axis) * (1 - _shape(f, axis, a.ndim))
            out += np.take(a, i1, axis=axis) * _shape(f, axis, a.ndim)
            return out
        def _shape(f, axis, nd):
            sh = [1] * nd
            sh[axis] = n
            return f.reshape(sh)
        a = g
        for ax in range(3):
            a = lerp1(a, ax)
        return a
    d = base * (0.55 + 0.45 * noise(4)) * (0.7 + 0.3 * noise(8))
    d = np.clip(d * 1.6 - 0.1, 0.0, 1.0)
    return VolumeIR(
        density=d.astype(np.float32),
        lo=np.array([-1, -1, -1], np.float32),
        hi=np.array([1, 1, 1], np.float32),
    )


def load_volume(path: str, lo=None, hi=None) -> VolumeIR:
    """Dispatch on extension (.vdb / .vol / .npy)."""
    if path.endswith(".vdb"):
        from tracerboy_tpu_torch.scene.vdb import read_vdb

        return read_vdb(path)
    if path.endswith(".vol"):
        return read_vol(path)
    if path.endswith(".npy"):
        if lo is None or hi is None:
            lo, hi = (0, 0, 0), (1, 1, 1)
        return read_npy(path, lo, hi)
    raise ValueError(f"unsupported volume format: {path}")
