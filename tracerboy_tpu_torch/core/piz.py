"""PIZ-compressed EXR block reading via the native decoder.

Bridges core/image_io.read_exr to native/piz_decoder.cpp, the JAX
package's decoder source, compiled at first use into the port's build
directory (utils/build.py), never into native/. PIZ is the format of the
Tungsten golden renders shipped with the reference scenes. A copy of
tracerboy_tpu/core/piz.py.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from tracerboy_tpu_torch.utils.build import REPO_ROOT, build_shared_library

_SRC = REPO_ROOT / "native" / "piz_decoder.cpp"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_shared_library(
        "tbpiz", [_SRC], ["g++", "-O3", "-shared", "-fPIC"])))
    lib.tb_piz_uncompress.restype = ctypes.c_int
    lib.tb_piz_uncompress.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    _lib = lib
    return lib


_PT_SIZES = {0: 2, 1: 1, 2: 2}  # u16 units per sample: uint=2, half=1, float=2


def read_piz_blocks(data, pos, chans, width, height, nblocks,
                    lines_per_block):
    """Decode all PIZ blocks of a scanline EXR.

    chans: list of (name, pixel_type, xs, ys). Returns
    {name: float32 (H, W)}.
    """
    lib = _load()
    out = {name: np.zeros((height, width), np.float32)
           for name, *_ in chans}
    n_ch = len(chans)

    for _ in range(nblocks):
        ystart, dsize = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = np.frombuffer(data, np.uint8, dsize, offset=pos)
        pos += dsize
        y0 = ystart
        nlines = min(lines_per_block, height - y0)

        sizes = [_PT_SIZES[pt] for _, pt, _, _ in chans]
        ch_nx = (ctypes.c_int * n_ch)(*([width] * n_ch))
        ch_ny = (ctypes.c_int * n_ch)(*([nlines] * n_ch))
        ch_sz = (ctypes.c_int * n_ch)(*sizes)
        total = sum(width * nlines * s for s in sizes)
        buf = np.zeros(total, np.uint16)

        rc = lib.tb_piz_uncompress(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dsize,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            total, ch_nx, ch_ny, ch_sz, n_ch,
        )
        if rc != 0:
            raise ValueError(f"PIZ block decode failed (code {rc})")

        off = 0
        for (name, pt, _, _), s in zip(chans, sizes):
            plane = buf[off : off + width * nlines * s]
            off += width * nlines * s
            if pt == 1:  # half
                vals = plane.view(np.float16).astype(np.float32)
                out[name][y0 : y0 + nlines] = vals.reshape(nlines, width)
            elif pt == 2:  # float: two u16 halves per value (interleaved)
                v = plane.reshape(nlines, width, 2).copy()
                f = v.view(np.uint16).reshape(nlines, width, 2)
                fl = (f[..., 0].astype(np.uint32) << 16) | f[..., 1]
                out[name][y0 : y0 + nlines] = fl.view(np.float32)
            else:  # uint32
                v = plane.reshape(nlines, width, 2)
                u = (v[..., 0].astype(np.uint32) << 16) | v[..., 1]
                out[name][y0 : y0 + nlines] = u.astype(np.float32)
    return out
