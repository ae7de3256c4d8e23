"""OIDN .tza tensor-archive parser (tracerboy_tpu/ml/tza.py, copied so the
port reads it without importing the JAX package).

Reads the Open Image Denoise weight blobs of the reference
(TracerBoy/ML/rt_ldr*.tza). Format (the reference's parser,
TracerBoy/OpenImageDenoise.cpp:455-529): little-endian, `uint16 magic
0x41D7`, `uint8 major == 2`, `uint8 minor`, `uint64 table_offset`; at the
table: `uint32 num_tensors`, then per tensor: `uint16 name_len + name`,
`uint8 ndims`, `uint32 dims[ndims]`, `char layout[ndims]` ("x" or
"oihw"), `char dtype` ('f' = f32, 'h' = f16), `uint64 data_offset` into
the blob.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x41D7


def read_tza(path: str) -> dict:
    """Parse a .tza file -> {name: (array, layout)}; arrays are float32."""
    with open(path, "rb") as f:
        blob = f.read()
    magic, major, minor = struct.unpack_from("<HBB", blob, 0)
    if magic != MAGIC:
        raise ValueError(f"bad tza magic: {magic:#x}")
    if major != 2:
        raise ValueError(f"unsupported tza version: {major}.{minor}")
    (table_offset,) = struct.unpack_from("<Q", blob, 4)

    pos = table_offset
    (num_tensors,) = struct.unpack_from("<I", blob, pos)
    pos += 4
    out = {}
    for _ in range(num_tensors):
        (name_len,) = struct.unpack_from("<H", blob, pos)
        pos += 2
        name = blob[pos : pos + name_len].decode("ascii")
        pos += name_len
        ndims = blob[pos]
        pos += 1
        dims = struct.unpack_from(f"<{ndims}I", blob, pos)
        pos += 4 * ndims
        layout = blob[pos : pos + ndims].decode("ascii")
        pos += ndims
        dtype_ch = chr(blob[pos])
        pos += 1
        (data_offset,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        count = int(np.prod(dims))
        if dtype_ch == "f":
            arr = np.frombuffer(blob, "<f4", count, offset=data_offset)
        elif dtype_ch == "h":
            arr = np.frombuffer(blob, "<f2", count, offset=data_offset).astype(
                np.float32
            )
        else:
            raise ValueError(f"unknown tza dtype: {dtype_ch!r}")
        out[name] = (arr.reshape(dims).copy(), layout)
    return out
