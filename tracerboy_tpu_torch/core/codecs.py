"""The shared library of the TIFF and GIF readers' byte-serial loops
(csrc/lzw_codecs.cpp: TIFF LZW decode and encode, PackBits, the TIFF
predictors, GIF LZW), built with g++ at first use into the port's build
directory and loaded through ctypes. core/tiff.py and core/gif.py both
call library().
"""

from __future__ import annotations

_lib = None


def library():
    global _lib
    if _lib is None:
        import ctypes

        from tracerboy_tpu_torch.utils.build import (
            REPO_ROOT,
            build_shared_library,
        )

        lib = ctypes.CDLL(str(build_shared_library(
            "tbcodecs", [REPO_ROOT / "tracerboy_tpu_torch" / "csrc"
                         / "lzw_codecs.cpp"],
            ["g++", "-O2", "-shared", "-fPIC"])))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for name, args in (
                ("tb_tiff_lzw_decode", [p, i64, p, i64]),
                ("tb_tiff_lzw_encode", [p, i64, p]),
                ("tb_packbits_decode", [p, i64, p, i64]),
                ("tb_tiff_unpredict", [p, i64, i64, i64, i64, i64]),
                ("tb_gif_decode", [p, i64, p, i64, i64, i64, i64, i64])):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = args
        _lib = lib
    return _lib
