"""The port's WebP reader: the pixels PIL returns (Pillow 12.1, which
opens every WebP through libwebp's WebPAnimDecoder), bit for bit,
without an imaging library.

WebP is what asset pipelines write today (Blender's glTF exporter,
cwebp, web asset stores); a PBRT imagemap or an OBJ map_Kd may name
one, and the JAX package reads it through PIL. This module parses the
container as libwebp's demuxer does (demux.c: ParseSingleImage,
ParseVP8X, ParseVP8XChunks, ParseAnimationFrame, StoreFrame,
IsValidSimpleFormat, IsValidExtendedFormat) and decodes the first frame
as WebPAnimDecoderGetNext does:
- simple files ('VP8 ' or 'VP8L' first) and extended ones ('VP8X': ICCP,
  EXIF, XMP and unknown chunks skipped, odd chunk sizes padded);
- the bitstreams by csrc/webp_decode.cpp: VP8L (RFC 9649), VP8 key
  frames (RFC 6386) converted to RGB as libwebp converts them, and the
  ALPH chunk (raw or a VP8L green plane, then its filter undone);
- animations (ANIM, ANMF): frame 1 on a transparent black canvas at its
  offset; the first frame is never blended (libwebp blends from frame 2
  on).
PIL opens the file as RGBA (unpremultiplied) unless libwebp's
WebPGetFeatures says it has no alpha (no VP8X alpha flag, no ALPH chunk,
no alpha hint in a VP8L header), and then as RGB (raw mode RGBX: the
fourth byte dropped).

Refused as PIL refuses: any file PIL's _accept takes (RIFF, WEBP, then
'VP8 ', 'VP8L' or 'VP8X') that libwebp's demuxer or decoder rejects
raises ValueError, as PIL raises OSError or EOFError; a file _accept
does not take is not a WebP (decode_ldr tries PIL's other formats).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.codecs import webp_library
from tracerboy_tpu_torch.core.image_io import check_image_size

FOURCCS = (b"VP8 ", b"VP8L", b"VP8X")
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG, ALL_VALID_FLAGS = 0x10, 0x02, 0x3E


def is_webp(data: bytes) -> bool:
    """PIL's _accept (WebPImagePlugin.py:24-35)."""
    return (data.startswith(b"RIFF") and data[8:12] == b"WEBP"
            and data[12:16] in FOURCCS)


class _Refused(Exception):
    """libwebp's demuxer or decoder gave up."""


class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.image = None            # (chunk offset, chunk bytes)
        self.alpha = None
        self.has_alpha = False
        self.complete = False
        self.num = 0
        self.lossless = False


class _Demux:
    """The container as libwebp's WebPDemux parses a complete file."""

    def __init__(self, data: bytes):
        if len(data) < 20:
            raise _Refused("truncated header")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Refused("bad RIFF size")
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise _Refused("truncated file")
        self.buf = data[:self.riff_end]
        self.start = 12
        self.flags = 0
        self.canvas = (0, 0)
        self.is_ext = False
        self.frames = []
        self.done = False
        tag = self.buf[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            status = self._single_image()
            valid = self._valid_simple
        else:
            status = self._vp8x()
            valid = self._valid_extended
        if status != "ok" or not valid():
            raise _Refused("invalid container")

    # MemBuffer helpers
    def left(self) -> int:
        return self.riff_end - self.start

    def u24(self) -> int:
        b = self.buf[self.start:self.start + 3]
        self.start += 3
        return b[0] | b[1] << 8 | b[2] << 16

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.start)[0]
        self.start += 4
        return v

    def _features(self, off: int, size: int):
        """WebPGetFeatures on one VP8/VP8L chunk: (w, h, alpha, lossless)."""
        chunk = self.buf[off:off + size]
        if len(chunk) < 12:
            raise _Refused("short image chunk")
        payload = chunk[8:]
        declared = struct.unpack_from("<I", chunk, 4)[0]
        if chunk[:4] == b"VP8L":
            if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
                raise _Refused("bad VP8L header")
            bits = int.from_bytes(payload[1:5], "little")
            return ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1,
                    bool((bits >> 28) & 1), True)
        if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
            raise _Refused("bad VP8 header")
        bits = payload[0] | payload[1] << 8 | payload[2] << 16
        w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
        h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
        if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
                or bits >> 5 >= declared or not w or not h):
            raise _Refused("bad VP8 frame header")
        return w, h, False, False

    def _store_frame(self, num: int, min_size: int, frame: _Frame) -> str:
        """StoreFrame: an ALPH chunk and/or one image chunk."""
        if self.left() < 8 or self.left() < min_size:
            return "more"
        alphas = images = 0
        status = "ok"
        while True:
            chunk_off = self.start
            fourcc = self.buf[self.start:self.start + 4]
            self.start += 4
            size = self.u32()
            if size > MAX_CHUNK_PAYLOAD:
                return "error"
            padded = size + (size & 1)
            if padded > self.left():
                return "error"
            chunk_bytes = 8 + padded
            done = False
            if fourcc == b"ALPH" and alphas == 0:
                alphas = 1
                frame.alpha = (chunk_off, chunk_bytes)
                frame.has_alpha = True
                frame.num = num
                self.start += padded
            elif fourcc == b"VP8L" and alphas:
                return "error"             # VP8L carries its own alpha
            elif fourcc in (b"VP8 ", b"VP8L") and images == 0:
                w, h, alpha, lossless = self._features(chunk_off,
                                                       chunk_bytes)
                images = 1
                frame.image = (chunk_off, chunk_bytes)
                frame.width, frame.height = w, h
                frame.has_alpha |= alpha
                frame.lossless = lossless
                frame.num = num
                frame.complete = True
                self.start += padded
            else:
                self.start = chunk_off              # rewind
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.left() < 8:
                status = "more"
            if done or status != "ok":
                return status

    def _add_frame(self, frame: _Frame) -> bool:
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def _single_image(self) -> str:
        if self.frames:
            return "error"
        if 8 > self.left():
            return "error"
        frame = _Frame()
        status = self._store_frame(1, 0, frame)
        if status == "error":
            return status
        if not self.flags & ALPHA_FLAG and frame.alpha is not None:
            frame.alpha = None
            frame.has_alpha = False
        if not self.is_ext and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
            if frame.has_alpha:
                self.flags |= ALPHA_FLAG
        if not self._add_frame(frame):
            return "error"
        if status == "ok":
            self.done = True
        return "ok" if status == "ok" else "error"

    def _vp8x(self) -> str:
        self.is_ext = True
        self.start += 4
        size = self.u32()
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            return "error"
        size += size & 1
        if size > self.left():
            return "error"
        self.flags = self.buf[self.start]
        self.start += 4
        self.canvas = (1 + self.u24(), 1 + self.u24())
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            return "error"
        self.start += size - 10
        if 8 > self.left():
            return "error"
        status = self._vp8x_chunks()
        if status == "ok":
            self.done = True
        return status

    def _vp8x_chunks(self) -> str:
        is_anim = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            chunk_off = self.start
            fourcc = self.buf[self.start:self.start + 4]
            self.start += 4
            size = self.u32()
            if size > MAX_CHUNK_PAYLOAD:
                return "error"
            padded = size + (size & 1)
            if padded > self.left():
                return "error"
            if fourcc == b"VP8X":
                return "error"
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_anim:
                    return "error"
                self.start = chunk_off
                status = self._single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    return "error"
                anim_chunks += 1
                self.start += padded
                status = "ok"
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return "error"
                status = self._animation_frame(padded)
            else:
                self.start += padded
                status = "ok"
            if status != "ok":
                return status
            if self.start == self.riff_end:
                return "ok"
            if self.left() < 8:
                return "error"

    def _animation_frame(self, chunk_size: int) -> str:
        is_anim = bool(self.flags & ANIMATION_FLAG)
        payload = chunk_size - 16
        if 16 > self.left() or chunk_size < 16:
            return "error"
        frame = _Frame()
        frame.x = 2 * self.u24()
        frame.y = 2 * self.u24()
        frame.width = 1 + self.u24()
        frame.height = 1 + self.u24()
        self.u24()                                   # duration
        self.start += 1                              # dispose, blend
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            return "error"
        start = self.start
        status = self._store_frame(len(self.frames) + 1, payload, frame)
        if status != "error" and self.start - start > payload:
            status = "error"
        if status != "error" and is_anim and frame.num > 0:
            if not self._add_frame(frame):
                status = "error"
        return "ok" if status == "ok" else "error"

    def _valid_simple(self) -> bool:
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.done and not self.frames:
            return False
        f = self.frames[0]
        return f.width > 0 and f.height > 0

    def _valid_extended(self) -> bool:
        is_anim = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.done and not self.frames:
            return False
        if self.flags & ~ALL_VALID_FLAGS:
            return False
        for f in self.frames:
            if not is_anim and f.num > 1:
                return False
            if not f.complete:
                return False
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                return False
            if f.width <= 0 or f.height <= 0:
                return False
            if not is_anim:
                if (f.x, f.y, f.width, f.height) != (0, 0, *self.canvas):
                    return False
            elif (f.x + f.width > self.canvas[0]
                  or f.y + f.height > self.canvas[1]):
                return False
        return True


def _sniff_alpha(data: bytes):
    """WebPGetFeatures(data).has_alpha, which Pillow's _webp.c reads to
    choose RGBA or RGBX (None where WebPGetFeatures fails: RGBA).
    libwebp's ParseHeadersInternal: the VP8X flag, or an ALPH chunk
    before the image, or for VP8L its header's alpha hint (which
    overrides the flag); a short read after a VP8X chunk keeps what was
    found."""
    if len(data) < 12:
        return None
    pos, riff_size = 0, 0
    if data.startswith(b"RIFF"):
        if data[8:12] != b"WEBP":
            return None
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
            return None
        pos = 12
    if len(data) - pos < 8:
        return None
    found_vp8x = data[pos:pos + 4] == b"VP8X"
    has_alpha = False
    if found_vp8x:
        if struct.unpack_from("<I", data, pos + 4)[0] != 10:
            return None
        if len(data) - pos < 18:
            return None
        flags = struct.unpack_from("<I", data, pos + 8)[0]
        w = 1 + int.from_bytes(data[pos + 12:pos + 15], "little")
        h = 1 + int.from_bytes(data[pos + 15:pos + 18], "little")
        if w * h >= MAX_IMAGE_AREA or not riff_size:
            return None
        has_alpha = bool(flags & ALPHA_FLAG)
        if flags & ANIMATION_FLAG:
            return has_alpha
        pos += 18
    if len(data) - pos < 4:
        return has_alpha if found_vp8x else None
    alpha_data = False
    if found_vp8x or data[pos:pos + 4] == b"ALPH":
        total = 22
        while True:
            if len(data) - pos < 8:
                return has_alpha if found_vp8x else None
            size = struct.unpack_from("<I", data, pos + 4)[0]
            if size > MAX_CHUNK_PAYLOAD:
                return None
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size and total > riff_size:
                return None
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if len(data) - pos < disk:
                return (has_alpha or alpha_data) if found_vp8x else None
            if data[pos:pos + 4] == b"ALPH":
                alpha_data = True
            pos += disk
    if len(data) - pos < 8:
        return (has_alpha or alpha_data) if found_vp8x else None
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if riff_size >= 12 and size > riff_size - 12:
            return None
        lossless = tag == b"VP8L"
        pos += 8
    else:
        size = len(data) - pos
        lossless = (len(data) - pos >= 5 and data[pos] == 0x2F
                    and data[pos + 4] >> 5 == 0)
    payload = data[pos:]
    short = len(payload) < (5 if lossless else 10)
    if short:
        return (has_alpha or alpha_data) if found_vp8x else None
    if lossless:
        if payload[0] != 0x2F or payload[4] >> 5:
            return None
        bits = int.from_bytes(payload[1:5], "little")
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        has_alpha = bool((bits >> 28) & 1)
    else:
        bits = payload[0] | payload[1] << 8 | payload[2] << 16
        w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
        h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
        if (payload[3:6] != b"\x9d\x01\x2a" or bits & 1
                or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
                or bits >> 5 >= size or not w or not h):
            return None
    if found_vp8x and (w, h) != (1 + int.from_bytes(data[24:27], "little"),
                                 1 + int.from_bytes(data[27:30], "little")):
        return None
    return has_alpha or alpha_data


def _decode_frame(buf: bytes, frame: _Frame) -> np.ndarray:
    """WebPDecode of a frame's chunks into (h, w, 4) RGBA."""
    lib = webp_library()
    off, size = frame.image
    payload = np.frombuffer(buf, np.uint8, size - 8, off + 8)
    w, h = frame.width, frame.height
    out = np.empty((h, w, 4), np.uint8)
    if frame.lossless:
        status = lib.tb_webp_vp8l_decode(payload.ctypes.data, payload.size,
                                         w, h, out.ctypes.data)
    else:
        out[..., 3] = 255
        status = lib.tb_webp_vp8_decode(payload.ctypes.data, payload.size,
                                        w, h, out.ctypes.data)
        if status == 0 and frame.alpha is not None:
            a_off = frame.alpha[0]
            a_size = struct.unpack_from("<I", buf, a_off + 4)[0]
            alpha = np.frombuffer(buf, np.uint8, a_size, a_off + 8)
            plane = np.empty((h, w), np.uint8)
            status = lib.tb_webp_alpha_decode(alpha.ctypes.data, alpha.size,
                                              w, h, plane.ctypes.data)
            out[..., 3] = plane
    if status:
        raise _Refused(f"bitstream error {status}")
    return out


def read_webp(data: bytes, path: str = "<webp>") -> np.ndarray:
    """A WebP file's first frame as PIL decodes it: (H, W, 4) uint8 RGBA
    when the file has the alpha flag, else (H, W, 3) RGB. ValueError
    where PIL raises OSError or EOFError."""
    if not is_webp(data):
        raise ValueError(f"{path}: not a WebP file")
    try:
        demux = _Demux(data)
        check_image_size(*demux.canvas, path)
        frame = demux.frames[0]
        pixels = _decode_frame(demux.buf, frame)
    except _Refused as e:
        raise ValueError(f"{path}: libwebp cannot decode this file "
                         f"({e})") from None
    cw, ch = demux.canvas
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[frame.y:frame.y + frame.height,
           frame.x:frame.x + frame.width] = pixels
    if _sniff_alpha(data) is not False:
        return canvas
    return np.ascontiguousarray(canvas[..., :3])
