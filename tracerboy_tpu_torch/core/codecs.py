"""The shared libraries of the image readers' byte-serial loops, built
with g++ at first use into the port's build directory and loaded through
ctypes:
- library(): csrc/lzw_codecs.cpp (TIFF LZW decode, old-style too, and
  encode, libtiff's PackBits, the TIFF predictors, GIF LZW, PIL's
  row-wise PackBits), for core/tiff.py, core/gif.py and core/psd.py;
- tiff_library(): csrc/tiff_codecs.cpp (Zstandard, CCITT fax,
  ThunderScan, libtiff's YCbCr route, Pillow's LAB conversion), for
  core/tiff.py, with -ffp-contract=off: the LAB conversion repeats
  littleCMS's float steps;
- webp_library(): csrc/webp_decode.cpp (VP8L, VP8, the ALPH plane, QOI
  decode and encode; the VP8L tables in csrc/webp_vp8l_tables.inc),
  for core/webp.py and core/qoi.py;
- j2k_library(): csrc/j2k_decode.cpp (a JPEG 2000 tile's packets, tier 1,
  wavelets, colour transform and DC shift), for core/jpeg2000.py, with
  -ffp-contract=off: no fused multiply-add may change a 9/7 or ICT
  result;
- small_library(): csrc/small_decode.cpp (PCX run lengths, SGI RLE rows,
  ICNS RLE channels, Sun RLE, MSP LinS rows, XBM hex bytes, IM's packed
  float samples, FLI frames), for core/pcx.py, core/sgi.py,
  core/icns.py, core/sun.py, core/msp.py, core/xbm.py, core/im.py and
  core/fli.py;
- av1_library(): csrc/av1_decode.cpp (an AV1 intra frame's OBUs to its
  planes, with csrc/av1_tables.inc, its in-loop filters in
  csrc/av1_filters.inc and its film grain in csrc/av1_grain.inc, and
  libavif's YUV-to-RGB, its float routines in csrc/avif_reformat.inc),
  for core/avif.py, with -ffp-contract=off: the float routines repeat
  libavif's single-precision steps; also the decision record of a frame
  (tb_av1_record, the layout in csrc/av1_syntax.inc, which both AV1
  files share);
- av1_encode_library(): csrc/av1_encode.cpp (libaom's AV1 bitstream
  writer: OBUs, headers, the entropy coder, block and coefficient syntax,
  all from a frame's decision record), for core/avif_save.py;
- jpeg_encode_library(): csrc/jpeg_encode.cpp (the pixel stages and the
  entropy coder of libjpeg-turbo's baseline writer), for
  core/image_save.py;
- j2k_encode_library(): csrc/j2k_encode.cpp (OpenJPEG's lossless 5/3
  tile coder: wavelet, tier 1, tier 2), for core/image_save.py;
- gif_encode_library(): csrc/gif_encode.cpp (Pillow's median-cut and
  octree quantisers and its GIF LZW coder), for core/image_save.py;
- resample_library(): csrc/resample.cpp (Pillow's BICUBIC and LANCZOS
  resampling of 8-bit images and the premultiplication around it), for
  core/resample.py, with -ffp-contract=off: the coefficients are doubles
  rounded to 22-bit fixed point, which a fused multiply-add could move;
- webp_encode_library(): csrc/webp_encode.cpp (libwebp's lossy VP8
  encoder as PIL's WebP writer runs it, with the decoder's tables in
  csrc/webp_vp8_tables.inc and its own in csrc/webp_enc_tables.inc), for
  core/image_save.py, with -ffp-contract=off: the gamma tables and the
  segment quantisers come from pow in double;
- webp_alpha_library(): csrc/webp_alpha_encode.cpp (libwebp's ALPH
  plane: alpha_enc.c's filters and its lossless VP8L encoder, with the
  decoder's VP8L tables in csrc/webp_vp8l_tables.inc), for
  core/image_save.py, with -ffp-contract=off: its costs above 65,535
  come from log in double.
"""

from __future__ import annotations

_libs: dict = {}

_CSRC = ("tracerboy_tpu_torch", "csrc")


def _load(name, source, headers, functions, flags=()):
    if name not in _libs:
        import ctypes

        from tracerboy_tpu_torch.utils.build import (
            REPO_ROOT,
            build_shared_library,
        )

        csrc = REPO_ROOT.joinpath(*_CSRC)
        lib = ctypes.CDLL(str(build_shared_library(
            name, [csrc / source],
            ["g++", "-O2", "-shared", "-fPIC", *flags],
            headers=[csrc / h for h in headers])))
        for fn_name, args in functions:
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int64
            fn.argtypes = args
        _libs[name] = lib
    return _libs[name]


def library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbcodecs", "lzw_codecs.cpp", (), (
        ("tb_tiff_lzw_decode", [p, i64, p, i64]),
        ("tb_tiff_lzw_decode_compat", [p, i64, p, i64]),
        ("tb_tiff_lzw_encode", [p, i64, p]),
        ("tb_packbits_decode", [p, i64, p, i64]),
        ("tb_tiff_unpredict", [p, i64, i64, i64, i64, i64]),
        ("tb_gif_decode", [p, i64, p, i64, i64, i64, i64, i64]),
        ("tb_pil_packbits_rows", [p, i64, p, i64, i64])))


def tiff_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbtiff", "tiff_codecs.cpp", (), (
        ("tb_zstd_decode", [p, i64, p, i64]),
        ("tb_fax_decode", [p, i64, p, i64, i64, i64, i64]),
        ("tb_thunder_decode", [p, i64, p, i64, i64]),
        ("tb_lab_to_rgb", [p, i64, p]),
        ("tb_ycbcr_to_rgb", [p, i64, i64, i64, i64, i64, i64, p, p, p,
                             i64])),
        flags=("-ffp-contract=off",))


def webp_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbwebp", "webp_decode.cpp",
                 ("webp_vp8_tables.inc", "webp_vp8l_tables.inc"), (
        ("tb_webp_vp8l_decode", [p, i64, i64, i64, p]),
        ("tb_webp_vp8_decode", [p, i64, i64, i64, p]),
        ("tb_webp_alpha_decode", [p, i64, i64, i64, p]),
        ("tb_qoi_decode", [p, i64, i64, i64, p]),
        ("tb_qoi_encode", [p, i64, i64, i64, i64, p])))


def j2k_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbj2k", "j2k_decode.cpp", ("j2k_mq.inc",), (
        ("tb_j2k_decode_tile", [p, i64, p, i64, p, i64, p, p, p, i64,
                                i64]),), flags=("-ffp-contract=off",))


def av1_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbav1", "av1_decode.cpp",
                 ("av1_tables.inc", "av1_syntax.inc", "av1_filters.inc",
                  "av1_grain.inc", "avif_reformat.inc"), (
        ("tb_av1_decode", [p, i64, p, i64, p, ctypes.c_char_p, i64]),
        ("tb_av1_record", [p, i64, p, i64, ctypes.c_char_p, i64]),
        ("tb_avif_to_rgb", [p, p, p, i64, i64, i64, i64, i64, p, i64, p,
                            i64, i64])), flags=("-ffp-contract=off",))


def av1_encode_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbav1enc", "av1_encode.cpp",
                 ("av1_tables.inc", "av1_syntax.inc"), (
        ("tb_av1_write", [p, i64, p, i64, ctypes.c_char_p, i64]),))


def small_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbsmall", "small_decode.cpp", (), (
        ("tb_pcx_decode", [p, i64, p, i64, i64, i64, i64]),
        ("tb_sgi_rle_decode", [p, i64, p, i64, i64, i64, i64]),
        ("tb_icns_rle_decode", [p, i64, p, i64]),
        ("tb_sun_rle_decode", [p, i64, p, i64, i64]),
        ("tb_msp_decode", [p, i64, p, i64, i64, p, i64]),
        ("tb_xbm_decode", [p, i64, p, i64, i64]),
        ("tb_bit_decode", [p, i64, p, i64, i64, i64]),
        ("tb_fli_decode", [p, i64, p, i64, i64, p])))


def jpeg_encode_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbjpegenc", "jpeg_encode.cpp", (), (
        ("tb_jpeg_encode_scan", [p, i64, i64, i64, p, p, p, i64]),))


def j2k_encode_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbj2kenc", "j2k_encode.cpp", ("j2k_mq.inc",), (
        ("tb_j2k_encode_tile", [p, i64, i64, i64, i64, p, i64]),))


def gif_encode_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbgifenc", "gif_encode.cpp", (), (
        ("tb_quantize_median", [p, i64, p, p]),
        ("tb_quantize_octree", [p, i64, p, p]),
        ("tb_gif_lzw", [p, i64, i64, i64, p, i64])))


def resample_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbresample", "resample.cpp", (), (
        ("tb_resample", [p, i64, i64, i64, p, i64, i64, i64]),
        ("tb_premultiply", [p, i64, i64]),
        ("tb_unpremultiply", [p, i64, i64])),
        flags=("-ffp-contract=off",))


def webp_encode_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbwebpenc", "webp_encode.cpp",
                 ("webp_vp8_tables.inc", "webp_enc_tables.inc"), (
        ("tb_webp_encode", [p, i64, i64, p, i64]),
        ("tb_webp_encode_rgba", [p, i64, i64, p, i64]),
        ("tb_webp_yuv", [p, i64, i64, p, p, p]),
        ("tb_webp_yuva", [p, i64, i64, i64, p, p, p, p]),
        ("tb_webp_mb_info", [p, i64, i64, p])),
        flags=("-ffp-contract=off",))


def webp_alpha_library():
    import ctypes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    return _load("tbwebpalpha", "webp_alpha_encode.cpp",
                 ("webp_vp8l_tables.inc",), (
        ("tb_webp_alpha_encode", [p, i64, i64, p, i64]),
        ("tb_vp8l_encode_green", [p, i64, i64, p, i64])),
        flags=("-ffp-contract=off",))
