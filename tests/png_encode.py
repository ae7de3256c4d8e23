"""PNG files for the tests of the port's decoder, and a timing of it.

encode_png writes a PNG with every colour type, bit depth, row filter
choice and Adam7 interlace; tests/test_torch_png_read.py builds its files
with it and holds both the port's reader and PIL against the samples it
was given. Run from the repository's root, it times the decoder
(core/image_io.read_ldr) on the host:

    PYTHONPATH=. python tests/png_encode.py [--size 2048] [--runs 5]

It writes a seeded RGBA image of --size x --size pixels whose rows cycle
through the five row filters (None, Sub, Up, Average, Paeth), so the
serial Average and Paeth rows are a fair share of the work, decodes it
--runs times and prints one JSON line: the file's bytes, each run's
seconds, the median, and the host's CPU count. A host measurement: it
says nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    ADAM7,
    PNG_FORMATS,
    PNG_SIGNATURE,
    png_chunk,
)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, rowbytes) uint8 as the file stores them."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, 2 * w * c)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = (w * c + per - 1) // per
    padded = np.zeros((h, n * per), np.uint8)
    padded[:, :w * c] = flat
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (padded.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Apply row filter filters[r % len(filters)] to each row r;
    (h, 1 + rowbytes) uint8."""
    raw = raw.astype(np.int32)
    h, n = raw.shape
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp] if n > bpp else 0
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    ul = np.zeros_like(raw)
    ul[1:] = left[:-1]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up,
                                                             ul))
    preds = (0, left, up, (left + up) >> 1, paeth)
    out = np.zeros((h, n + 1), np.uint8)
    for r in range(h):
        f = int(filters[r % len(filters)])
        out[r, 0] = f
        out[r, 1:] = (raw[r] - (preds[f][r] if f else 0)) & 0xFF
    return out


def encode_png(samples: np.ndarray, ctype: int, depth: int, filters=(0,),
               interlace: bool = False, palette=None, trns=None) -> bytes:
    """A PNG file of `samples` ((h, w, c) integer sample values, palette
    indices for colour type 3) at the given colour type and bit depth,
    its rows filtered by `filters` in turn, Adam7-interlaced if asked;
    palette ((n, 3) uint8) and trns (the tRNS chunk's bytes) when given."""
    samples = np.asarray(samples)
    h, w, c = samples.shape
    chans, depths = PNG_FORMATS[ctype]
    if c != chans or depth not in depths:
        raise ValueError(f"colour type {ctype} takes {chans} samples at "
                         f"depths {depths}")
    bpp = max(1, depth * chans // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        stream.append(_filter_rows(_pack_rows(sub, depth), bpp,
                                   filters).tobytes())
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", bytes(trns))
    data = zlib.compress(b"".join(stream), 6)
    # Two IDAT chunks: a decoder must join them.
    half = len(data) // 2
    out += png_chunk(b"IDAT", data[:half]) + png_chunk(b"IDAT", data[half:])
    return out + png_chunk(b"IEND", b"")


def seeded_rgba(size: int, seed: int = 0) -> np.ndarray:
    """A seeded RGBA image: smooth gradients plus noise, so the filters
    have real work and zlib does not shrink it to nothing."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([x, y, 0.5 * (x + y), 1.0 - 0.5 * x], axis=-1) * 200
    noise = rng.integers(0, 56, (size, size, 4))
    return (base + noise).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    from tracerboy_tpu_torch.core.image_io import read_ldr

    img = seeded_rgba(args.size)
    data = encode_png(img, 6, 8, filters=(0, 1, 2, 3, 4))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bench.png")
        with open(path, "wb") as f:
            f.write(data)
        got = read_ldr(path)            # builds the unfilter library
        if not np.array_equal(got, img.astype(np.float32) / 255.0):
            raise SystemExit("decoded image differs from the samples")
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            read_ldr(path)
            times.append(time.perf_counter() - t0)
    print(json.dumps(dict(size=args.size, file_bytes=len(data),
                          seconds=times, median_s=float(np.median(times)),
                          cpu_count=os.cpu_count())))


if __name__ == "__main__":
    main()
