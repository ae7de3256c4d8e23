"""Write the JPEG 2000 fixtures of the port's reader and their manifest.

    PYTHONPATH=. python tests/make_j2k_fixtures.py [OUT_DIR]

Writes into tests/data/j2k/ (or OUT_DIR) a small file of each layout the
port's reader (core/jpeg2000.py, csrc/j2k_decode.cpp) takes:
- written by PIL (OpenJPEG's encoder): L, LA, RGB, RGBA and I;16 with
  the 5/3 and the 9/7 wavelet, as JP2 files and as raw codestreams; MCT
  on; signed samples; 1 to 6 resolutions; 1 to 3 quality layers under
  `rates` and `dB`; each progression order; code-blocks from 4x4 to
  64x64; precincts; tiles with tile and image offsets; PLT markers; a
  comment; the cinema 2K and 4K profiles (tile-parts, a POC marker);
  sizes 1x1, 1x37, 37x1 and 17x33;
- written by tests/j2k_encode.py around PIL's codestreams: pclr + cmap
  palettes (RGB and RGBA entries, repeated colours, indices past the
  palette), with alpha; cdef; colr 12 (CMYK) and 18 (sYCC, 3 and 4
  components); an ICC colr; no colr; res; the jpx brand; unknown and XL
  boxes; bpcc; COM, CRG, PLM, TLM and unknown markers; tile-part COD,
  QCD and POC; COC, QCC, POC and RGN in the main header; precisions 1 to
  31 and signed samples (SIZ rewritten); subsampled components (which
  Pillow then reads as sYCC); every code-block style but HT (COD
  rewritten: bypass, reset, termination on each pass, vertically causal,
  predictable termination, segmentation symbols); SOP and EPH markers
  and packet headers in PPT or PPM segments (packets rewritten); a file
  whose last tile-part is cut at a packet boundary;
- the JPEG 2000 scene's textures: utils/demo_scene's 1024x1024 albedo as
  a lossless 5/3 JP2 and as a 9/7 JP2 at 38 dB, and its 512x512 leaf as
  a lossless RGBA raw codestream (.j2k) whose alpha makes the cutouts.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL (Image.open,
converted to RGB or RGBA as read_ldr converts it), and PIL's and
OpenJPEG's versions. The machine with the card has no PIL: chip_smoke.py
and tests/test_torch_jpeg2000_cuda.py hold the port against the manifest
there; tests/test_torch_jpeg2000.py holds the manifest against PIL.
"""

from __future__ import annotations

import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import j2k_encode as je  # noqa: E402
from make_dds_fixtures import array_digest, pil_pixels  # noqa: E402

FIXTURE_DIR = os.path.join(HERE, "data", "j2k")
ALBEDO, ALBEDO_LOSSLESS, LEAF = ("albedo.jp2", "albedo_lossless.jp2",
                                 "leaf.j2k")
W, H = 37, 21
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def sample(rng, mode: str, h: int = H, w: int = W) -> np.ndarray:
    """Noise beside a flat patch and a gradient, in PIL's layout for
    mode (uint16 for I;16)."""
    if mode == "I;16":
        img = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        img[h // 2:, : w // 2] = 300
        return img
    n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    img = rng.integers(0, 256, (h, w, n), dtype=np.uint8)
    img[h // 4:h // 2, w // 5:] = img[0, 0]
    yy, xx = np.mgrid[0:h, 0:w]
    img[h // 2:, :, 0] = ((xx * 7 + yy * 3) % 256)[h // 2:]
    return img[..., 0] if n == 1 else img


def pil_files(rng) -> dict:
    """Files PIL writes: every save option of its JPEG 2000 encoder."""
    out = {}
    cs = je.pil_codestream
    for mode in ("L", "LA", "RGB", "RGBA", "I;16"):
        img = sample(rng, mode)
        tag = mode.replace(";", "").lower()
        for irr in (False, True):
            wav = "97" if irr else "53"
            data = cs(img, mode, irreversible=irr)
            out[f"{tag}_{wav}.j2k"] = data
            out[f"{tag}_{wav}.jp2"] = je.jp2_file(
                data, bpc=15 if mode == "I;16" else 7)
            out[f"{tag}_{wav}_signed.j2k"] = cs(img, mode, irreversible=irr,
                                                signed=True)
    rgb, rgba = sample(rng, "RGB"), sample(rng, "RGBA")
    for irr in (False, True):
        wav = "97" if irr else "53"
        out[f"rgb_{wav}_mct.j2k"] = cs(rgb, "RGB", irreversible=irr, mct=1)
        out[f"rgba_{wav}_mct.j2k"] = cs(rgba, "RGBA", irreversible=irr,
                                        mct=1)
    big = sample(rng, "RGB", 48, 64)
    for n in range(1, 7):
        out[f"res{n}.j2k"] = cs(big, "RGB", num_resolutions=n,
                                irreversible=n % 2 == 0)
    for name, kw in (("rates_3", dict(quality_mode="rates",
                                      quality_layers=[20, 10, 1])),
                     ("rates_2", dict(quality_mode="rates",
                                      quality_layers=[40, 5])),
                     ("db_3", dict(quality_mode="dB",
                                   quality_layers=[30, 40, 50])),
                     ("db_1", dict(quality_mode="dB", quality_layers=[38]))):
        for irr in (False, True):
            out[f"layers_{name}_{'97' if irr else '53'}.j2k"] = cs(
                big, "RGB", irreversible=irr, **kw)
    for i, prg in enumerate(PROGRESSIONS):
        out[f"prog_{prg.lower()}.j2k"] = cs(
            big, "RGB", progression=prg, quality_layers=[30, 10, 1],
            precinct_size=(16, 16), codeblock_size=(8, 8), num_resolutions=4,
            irreversible=i % 2 == 1, mct=i % 2)
        out[f"prog_{prg.lower()}_tiles.jp2"] = je.jp2_file(cs(
            big, "RGB", progression=prg, quality_layers=[20, 2],
            tile_size=(24, 16), num_resolutions=3))
    for cw, ch in ((4, 4), (8, 8), (16, 64), (64, 64), (64, 16)):
        out[f"cblk_{cw}x{ch}.j2k"] = cs(big, "RGB", codeblock_size=(cw, ch),
                                        quality_layers=[25, 5])
    for pw, ph in ((16, 16), (32, 64), (64, 32)):
        out[f"prec_{pw}x{ph}.j2k"] = cs(big, "RGB", precinct_size=(pw, ph),
                                        codeblock_size=(8, 8),
                                        progression="RPCL", num_resolutions=4,
                                        quality_layers=[20, 4])
    out["tiles.j2k"] = cs(big, "RGB", tile_size=(16, 16))
    out["tiles_offsets.j2k"] = cs(big, "RGB", tile_size=(16, 24),
                                  offset=(5, 3), tile_offset=(2, 1))
    out["offset.j2k"] = cs(big, "RGB", offset=(7, 9), tile_size=(71, 57),
                           irreversible=True)
    out["plt.j2k"] = cs(big, "RGB", plt=True, tile_size=(32, 32))
    out["comment.jp2"] = je.jp2_file(cs(rgb, "RGB", comment="a comment"))
    flat = np.full((1080, 2048, 3), 90, np.uint8)
    flat[500:580, 1000:1100] = (200, 30, 60)
    for profile in ("cinema2k-24", "cinema2k-48", "cinema4k-24"):
        out[f"{profile.replace('-', '_')}.j2k"] = cs(flat, "RGB",
                                                     cinema_mode=profile)
    for h, w in ((1, 1), (1, 37), (37, 1), (17, 33)):
        small = sample(rng, "RGBA", h, w)
        out[f"size_{w}x{h}_53.jp2"] = je.jp2_file(cs(small, "RGBA"))
        out[f"size_{w}x{h}_97.j2k"] = cs(small[..., :3], "RGB",
                                         irreversible=True)
    return out


def box_files(rng) -> dict:
    """JP2 files whose boxes tests/j2k_encode.py writes."""
    out = {}
    cs = je.pil_codestream
    rgb, rgba = sample(rng, "RGB"), sample(rng, "RGBA")
    la = sample(rng, "LA")
    c3, c4 = cs(rgb, "RGB"), cs(rgba, "RGBA")
    idx = rng.integers(0, 12, (H, W), dtype=np.uint8)
    ci = cs(idx, "L")
    pal = rng.integers(0, 256, (10, 3))
    pal[5] = pal[2]                                    # a repeated colour
    pal4 = rng.integers(0, 256, (10, 4))
    pal4[6] = pal4[1]
    hdr = [je.ihdr(W, H, 1), je.colr(16)]
    out["pclr.jp2"] = je.jp2_file(ci, header=hdr + [je.pclr(pal),
                                                    je.cmap(3)])
    out["pclr_rgba.jp2"] = je.jp2_file(ci, header=hdr + [je.pclr(pal4),
                                                         je.cmap(4)])
    out["pclr_no_cmap.jp2"] = je.jp2_file(ci, header=hdr + [je.pclr(pal)])
    out["pclr_alpha.jp2"] = je.jp2_file(cs(la, "LA"), header=[
        je.ihdr(W, H, 2), je.colr(16), je.pclr(pal), je.cmap(3)])
    out["cdef.jp2"] = je.jp2_file(c4, header=[
        je.ihdr(W, H, 4), je.colr(16),
        je.cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)])])
    out["cmyk.jp2"] = je.jp2_file(c4, header=[je.ihdr(W, H, 4),
                                              je.colr(12)])
    out["sycc.jp2"] = je.jp2_file(c3, header=[je.ihdr(W, H, 3),
                                              je.colr(18)])
    out["sycc_alpha.jp2"] = je.jp2_file(c4, header=[je.ihdr(W, H, 4),
                                                    je.colr(18)])
    out["icc.jp2"] = je.jp2_file(c3, header=[
        je.ihdr(W, H, 3), je.colr_icc(bytes(rng.integers(0, 256, 128,
                                                         dtype=np.uint8)))])
    out["no_colr.jp2"] = je.jp2_file(c3, header=[je.ihdr(W, H, 3)])
    out["lab_colr.jp2"] = je.jp2_file(c3, header=[je.ihdr(W, H, 3),
                                                  je.colr(14)])
    out["two_colr.jp2"] = je.jp2_file(c3, header=[
        je.ihdr(W, H, 3), je.colr(16), je.colr_icc(b"icc")])
    out["res.jp2"] = je.jp2_file(c3, header=[je.ihdr(W, H, 3), je.colr(16),
                                             je.res_box()])
    out["jpx.jp2"] = je.jp2_file(c3, brand=b"jpx ")
    out["unknown_boxes.jp2"] = je.jp2_file(
        c3, before=[je.box(b"xml ", b"<x/>"), je.box(b"uuid", bytes(20))],
        after=[je.box(b"free", b"tail")])
    out["xl_jp2c.jp2"] = je.jp2_file(c3, xl_codestream=True)
    out["bpcc.jp2"] = je.jp2_file(c3, header=[
        je.ihdr(W, H, 3, 255), je.colr(16), je.box(b"bpcc", bytes([7] * 3))])
    out["colr_first.jp2"] = je.jp2_file(c3, header=[je.colr(16),
                                                    je.ihdr(W, H, 3)])
    out["ihdr_rgba_of_rgb.jp2"] = je.jp2_file(c3, header=[je.ihdr(W, H, 4),
                                                          je.colr(16)])
    return out


def codestream_files(rng) -> dict:
    """Codestreams whose marker segments or packets tests/j2k_encode.py
    rewrites."""
    out = {}
    cs = je.pil_codestream
    rgb = sample(rng, "RGB")
    grey = sample(rng, "L")
    c3, c1 = cs(rgb, "RGB"), cs(grey, "L")
    c97 = cs(rgb, "RGB", irreversible=True, quality_layers=[20, 5])
    big = sample(rng, "RGB", 48, 64)
    tiled = cs(big, "RGB", tile_size=(16, 16), quality_layers=[30, 10, 1],
               progression="RLCP")
    multi = cs(big, "RGB", tile_size=(32, 24), quality_layers=[30, 10, 1],
               progression="PCRL", precinct_size=(16, 16),
               codeblock_size=(4, 4), num_resolutions=3)
    parsed = je.Codestream(c3)
    cod, qcd = parsed.segment(0xFF52), parsed.segment(0xFF5C)
    out["markers.j2k"] = je.with_main_segments(c3, [
        (0xFF64, b"\x00\x01latin-1 comment"), (0xFF63, bytes(12)),
        (0xFF57, b"\x00"), (0xFF30, b"abcd")])
    out["tlm.j2k"] = je.with_main_segments(
        tiled, [(0xFF55, je.tlm(je.Codestream(tiled)))])
    out["tile_cod_qcd.j2k"] = je.with_tile_segments(
        c3, [(0xFF52, cod), (0xFF5C, qcd), (0xFF64, b"\x00\x01tile")])
    out["coc_qcc.j2k"] = je.with_main_segments(
        c3, [(0xFF53, b"\x01\x00" + cod[5:]), (0xFF5D, b"\x02" + qcd)])
    poc = struct.pack(">BBHBBB", 0, 0, 3, 6, 3, 1)
    out["tile_poc.j2k"] = je.with_tile_segments(tiled, [(0xFF5F, poc)])
    out["main_poc.j2k"] = je.with_main_segments(tiled, [(0xFF5F, poc)])
    out["rgn.j2k"] = je.with_main_segments(c3, [(0xFF5E, b"\x01\x00\x03")])
    out["rgn_97.j2k"] = je.with_main_segments(c97,
                                              [(0xFF5E, b"\x00\x00\x02")])
    for prec in (1, 4, 12, 16, 24, 31):
        out[f"precision{prec}.j2k"] = je.with_siz(c3, precision=prec)
        out[f"precision{prec}_97.j2k"] = je.with_siz(c97, precision=prec)
        out[f"precision{prec}_grey.j2k"] = je.with_siz(c1, precision=prec)
    out["signed_rewritten.j2k"] = je.with_siz(c97, signed=True)
    out["subsampled_420.j2k"] = je.with_siz(
        c3, subsampling=[None, (2, 2), (2, 2)])
    out["subsampled_422.j2k"] = je.with_siz(
        c3, subsampling=[None, (2, 1), (1, 2)])
    out["subsampled_luma.j2k"] = je.with_siz(
        c3, subsampling=[(2, 2), None, None])
    out["rsiz_cinema.j2k"] = je.with_siz(c3, rsiz=3)
    for bit, name in ((0x01, "bypass"), (0x02, "reset"), (0x04, "termall"),
                      (0x08, "vcausal"), (0x10, "pterm"),
                      (0x20, "segsym"), (0x3F, "all"), (0x09, "bypass_vc")):
        out[f"style_{name}.j2k"] = je.with_cblk_style(c3, bit)
        out[f"style_{name}_97.j2k"] = je.with_cblk_style(c97, bit)
    for base_name, base in (("single", c3), ("tiled", tiled),
                            ("multi", multi)):
        for opts in ("sop", "eph", "sop_eph", "ppt", "ppm", "ppt_sop_eph"):
            kw = {k: True for k in opts.split("_")}
            out[f"packets_{base_name}_{opts}.j2k"] = je.rewrite_packets(base,
                                                                        **kw)
    # A tile-part cut after its first packets, Psot cut to match (PIL reads
    # it: the missing packets read as empty).
    parsed = je.Codestream(multi)
    parsed.tiles[0][2] = parsed.tiles[0][2][:dict(je.packets(multi))[0][5][2]]
    out["cut_packets.j2k"] = parsed.bytes()
    return out


def scene_textures() -> dict:
    """The JPEG 2000 scene's albedo (lossless and 9/7) and cut-out leaf."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    albedo = _to_uint8(albedo_image(1024))
    leaf = _to_uint8(leaf_image(512))
    return {ALBEDO: je.jp2_file(je.pil_codestream(
                albedo, "RGB", irreversible=True, quality_mode="dB",
                quality_layers=[38])),
            ALBEDO_LOSSLESS: je.jp2_file(je.pil_codestream(albedo, "RGB")),
            LEAF: je.pil_codestream(leaf, "RGBA")}


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL
    from PIL import features

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261020)
    files = {**pil_files(rng), **box_files(rng), **codestream_files(rng),
             **scene_textures()}
    manifest = {"pil": PIL.__version__,
                "openjpeg": features.version("jpg_2000"), "files": {}}
    for name, data in files.items():
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = array_digest(pil_pixels(path))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
