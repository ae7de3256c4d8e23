"""Texture system: image array + procedural (checker / scale) records.

A numpy copy of tracerboy_tpu/scene/textures.py (the same record layout
and the same images, so both packages compile the same tables). Image
files are read by core/image_io.read_texture (PNG through the port's own
decoder; .hdr/.pfm/.exr); noise textures (fbm, wrinkled, marble, windy)
are baked to 256x256 images over the UV square; an image whose alpha
channel is not opaque everywhere gets a companion record of its alpha,
which the material table binds as the cutout mask.

TextureData SoA columns:
  ttype: 0=image, 1=checker, 2=scale, 3=constant
  flags: bit0 = needs gamma->linear decode on sample
  image_idx: index into the image array (type 0)
  uscale/vscale, color1/color2: checker params (type 1)
  sub1/sub2: nested texture indices for scale (type 2; -1 = use color)
"""

from __future__ import annotations

import os
import warnings

import numpy as np

TEX_IMAGE = 0
TEX_CHECKER = 1
TEX_SCALE = 2
TEX_CONSTANT = 3

GAMMA_FLAG = 0x1


def _perlin2(x, y, seed=0):
    """Vectorized 2-D gradient (Perlin) noise in [-1, 1]."""
    xi = np.floor(x).astype(np.int64)
    yi = np.floor(y).astype(np.int64)
    xf = x - xi
    yf = y - yi

    def grad(ix, iy, dx, dy):
        h = (ix * 374761393 + iy * 668265263 + seed * 1274126177)
        h = (h ^ (h >> 13)) * 1274126177
        h = (h ^ (h >> 16)) & 7
        ang = h.astype(np.float64) * (2 * np.pi / 8.0)
        return np.cos(ang) * dx + np.sin(ang) * dy

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v = fade(xf), fade(yf)
    n00 = grad(xi, yi, xf, yf)
    n10 = grad(xi + 1, yi, xf - 1, yf)
    n01 = grad(xi, yi + 1, xf, yf - 1)
    n11 = grad(xi + 1, yi + 1, xf - 1, yf - 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return (nx0 + v * (nx1 - nx0)).astype(np.float32)


def _fbm2(x, y, octaves, roughness, turbulence=False):
    """pbrt-style fractional Brownian motion (sum of lacunarity-1.99
    octaves with geometric amplitude falloff); turbulence sums |noise|
    (the Wrinkled/marble basis)."""
    out = np.zeros_like(x, np.float32)
    lam, amp = 1.0, 1.0
    for i in range(max(1, int(octaves))):
        n = _perlin2(x * lam, y * lam, seed=i)
        out += amp * (np.abs(n) if turbulence else n)
        lam *= 1.99
        amp *= roughness
    return out


def bake_noise_texture(ir, res: int = 256) -> np.ndarray:
    """Evaluate a noise TextureIR (fbm / wrinkled / marble / windy) over
    the UV unit square as a (res, res, 3) linear image."""
    s = 8.0 * max(ir.scale, 1e-6)
    v, u = np.meshgrid(
        np.linspace(0, 1, res, endpoint=False),
        np.linspace(0, 1, res, endpoint=False), indexing="ij",
    )
    x, y = u * s, v * s
    if ir.type == "fbm":
        g = 0.5 + 0.5 * _fbm2(x, y, ir.octaves, ir.roughness)
        img = np.repeat(g[..., None], 3, axis=2)
    elif ir.type == "wrinkled":
        g = _fbm2(x, y, ir.octaves, ir.roughness, turbulence=True)
        img = np.repeat((g / max(g.max(), 1e-6))[..., None], 3, axis=2)
    elif ir.type == "windy":
        # pbrt windy: fbm at 1/10 frequency modulating |fbm| strength.
        wave = _fbm2(0.1 * x, 0.1 * y, 3, 0.5)
        amp = np.abs(_fbm2(x, y, 6, 0.5))
        g = np.abs(wave) * amp
        img = np.repeat((g / max(g.max(), 1e-6))[..., None], 3, axis=2)
    else:  # marble: sine bands warped by turbulence, pbrt palette blend
        t = _fbm2(x, y, ir.octaves, ir.roughness, turbulence=True)
        band = 0.5 + 0.5 * np.sin(4.0 * v * s + ir.variation * 10.0 * t)
        c1 = np.array([0.58, 0.58, 0.6], np.float32)
        c2 = np.array([0.21, 0.2, 0.22], np.float32)
        img = c1 * band[..., None] + c2 * (1.0 - band[..., None])
    return np.clip(img, 0.0, 1.0).astype(np.float32)


class TextureAllocator:
    def __init__(self, base_dir: str, texture_irs: dict):
        self.base_dir = base_dir
        self.texture_irs = texture_irs
        self.images: list[np.ndarray] = []
        self.records: list[dict] = []
        self._cache: dict = {}
        # record idx -> companion alpha-texture record idx, for image
        # textures whose file carries a meaningful alpha channel (the
        # reference's albedo-alpha cutout fallback, SharedHitGroup.h:171).
        self.alpha_companion: dict[int, int] = {}

    def __call__(self, name_or_path, gamma: bool = False) -> int:
        key = (name_or_path, gamma)
        if key in self._cache:
            return self._cache[key]
        idx = self._allocate(name_or_path, gamma)
        self._cache[key] = idx
        return idx

    def _allocate(self, name_or_path, gamma: bool) -> int:
        ir = self.texture_irs.get(name_or_path)
        if ir is None:
            # Bare filename reference
            return self._add_image_file(str(name_or_path), gamma)
        if ir.type == "imagemap":
            return self._add_image_file(ir.filename, gamma or ir.gamma,
                                        ir.uscale, ir.vscale)
        if ir.type == "checkerboard":
            return self._add_record(dict(
                ttype=TEX_CHECKER, flags=0, image_idx=-1,
                uscale=ir.uscale, vscale=ir.vscale,
                color1=np.asarray(ir.tex1, np.float32),
                color2=np.asarray(ir.tex2, np.float32),
                sub1=-1, sub2=-1,
            ))
        if ir.type == "scale":
            sub1 = self(ir.tex1_name, gamma) if ir.tex1_name else -1
            sub2 = self(ir.tex2_name, gamma) if ir.tex2_name else -1
            return self._add_record(dict(
                ttype=TEX_SCALE, flags=0, image_idx=-1,
                uscale=1.0, vscale=1.0,
                color1=np.asarray(
                    ir.tex1 if ir.tex1 is not None else (1, 1, 1),
                    np.float32),
                color2=np.asarray(
                    ir.tex2 if ir.tex2 is not None else (1, 1, 1),
                    np.float32),
                sub1=sub1, sub2=sub2,
            ))
        if ir.type in ("fbm", "wrinkled", "marble", "windy"):
            # Baked to an image record (256^2 over the UV unit square), as
            # the JAX package does; the reference parses but never shades
            # these types.
            self.images.append(bake_noise_texture(ir))
            return self._add_record(dict(
                ttype=TEX_IMAGE, flags=0,
                image_idx=len(self.images) - 1,
                uscale=ir.uscale, vscale=ir.vscale,
                color1=np.zeros(3, np.float32),
                color2=np.zeros(3, np.float32), sub1=-1, sub2=-1,
            ))
        # constant or unsupported: constant color record
        c = ir.tex1 if ir.tex1 is not None else (1, 1, 1)
        return self._add_record(dict(
            ttype=TEX_CONSTANT, flags=0, image_idx=-1,
            uscale=1.0, vscale=1.0,
            color1=np.asarray(c, np.float32),
            color2=np.zeros(3, np.float32), sub1=-1, sub2=-1,
        ))

    def _add_image_file(self, filename, gamma, uscale=1.0, vscale=1.0) -> int:
        from tracerboy_tpu_torch.core import image_io

        path = filename
        if not os.path.isabs(path):
            path = os.path.join(self.base_dir, filename)
        if not os.path.exists(path):
            warnings.warn(f"texture not found: {path}; using magenta")
            img = np.tile(
                np.array([[[1.0, 0.0, 1.0]]], np.float32), (4, 4, 1)
            )
            gamma = False
        else:
            # LDR formats stay encoded; the gamma flag decodes at sample
            # time like the reference (SharedRaytracing.h:120-129).
            img = image_io.read_texture(path, gamma_to_linear_ldr=False)
        is_hdr = os.path.splitext(path)[1].lower() in (".hdr", ".exr", ".pfm")
        self.images.append(np.asarray(img[..., :3], np.float32))
        rec = self._add_record(dict(
            ttype=TEX_IMAGE,
            flags=(GAMMA_FLAG if (gamma and not is_hdr) else 0),
            image_idx=len(self.images) - 1,
            uscale=uscale, vscale=vscale,
            color1=np.zeros(3, np.float32),
            color2=np.zeros(3, np.float32), sub1=-1, sub2=-1,
        ))
        # Alpha-channel detection (reference: TracerBoy.cpp texture alpha
        # detection + IsValidHit albedo-alpha fallback).
        if (img.ndim == 3 and img.shape[2] >= 4
                and float(img[..., 3].min()) < 0.999):
            self.images.append(
                np.repeat(img[..., 3:4], 3, axis=2).astype(np.float32)
            )
            self.alpha_companion[rec] = self._add_record(dict(
                ttype=TEX_IMAGE, flags=0,
                image_idx=len(self.images) - 1,
                uscale=uscale, vscale=vscale,
                color1=np.zeros(3, np.float32),
                color2=np.zeros(3, np.float32), sub1=-1, sub2=-1,
            ))
        return rec

    def _add_record(self, rec) -> int:
        self.records.append(rec)
        return len(self.records) - 1

    def to_arrays(self):
        """Pack images into one padded array + SoA records.

        Returns (images f32[n, H, W, 3], sizes i32[n, 2], records dict).
        """
        if not self.images:
            images = np.zeros((1, 4, 4, 3), np.float32)
            sizes = np.array([[4, 4]], np.int32)
        else:
            H = max(i.shape[0] for i in self.images)
            W = max(i.shape[1] for i in self.images)
            images = np.zeros((len(self.images), H, W, 3), np.float32)
            sizes = np.zeros((len(self.images), 2), np.int32)
            for k, img in enumerate(self.images):
                images[k, : img.shape[0], : img.shape[1]] = img
                sizes[k] = (img.shape[0], img.shape[1])
        recs = self.records or [
            dict(ttype=TEX_CONSTANT, flags=0, image_idx=-1, uscale=1.0,
                 vscale=1.0, color1=np.ones(3, np.float32),
                 color2=np.zeros(3, np.float32), sub1=-1, sub2=-1)
        ]
        records = dict(
            ttype=np.array([r["ttype"] for r in recs], np.int32),
            flags=np.array([r["flags"] for r in recs], np.int32),
            image_idx=np.array([r["image_idx"] for r in recs], np.int32),
            uscale=np.array([r["uscale"] for r in recs], np.float32),
            vscale=np.array([r["vscale"] for r in recs], np.float32),
            color1=np.stack([r["color1"] for r in recs]).astype(np.float32),
            color2=np.stack([r["color2"] for r in recs]).astype(np.float32),
            sub1=np.array([r["sub1"] for r in recs], np.int32),
            sub2=np.array([r["sub2"] for r in recs], np.int32),
        )
        return images, sizes, records
