"""Texture records: procedural checker / scale / constant textures.

A numpy copy of the procedural part of tracerboy_tpu/scene/textures.py
(the same record layout, so both packages compile the same tables).
Image files and baked noise textures are not ported yet: they raise
NotImplementedError (ROADMAP.md, Queue 1: item 22b).

TextureData SoA columns:
  ttype: 0=image, 1=checker, 2=scale, 3=constant
  flags: bit0 = needs gamma->linear decode on sample
  image_idx: index into the image array (type 0)
  uscale/vscale, color1/color2: checker params (type 1)
  sub1/sub2: nested texture indices for scale (type 2; -1 = use color)
"""

from __future__ import annotations

import numpy as np

TEX_IMAGE = 0
TEX_CHECKER = 1
TEX_SCALE = 2
TEX_CONSTANT = 3

GAMMA_FLAG = 0x1

_NOT_PORTED = ("image and noise textures are not ported yet (ROADMAP.md, "
               "Queue 1: item 22b, images and other scene files)")


class TextureAllocator:
    def __init__(self, base_dir: str, texture_irs: dict):
        self.base_dir = base_dir
        self.texture_irs = texture_irs
        self.images: list[np.ndarray] = []
        self.records: list[dict] = []
        self._cache: dict = {}
        # Image textures with an alpha channel would register a cutout
        # companion here; no image texture is ported, so it stays empty.
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
        if ir is None or ir.type in ("imagemap", "fbm", "wrinkled",
                                     "marble", "windy"):
            raise NotImplementedError(f"{name_or_path!r}: {_NOT_PORTED}")
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
        # constant or unsupported: constant color record
        c = ir.tex1 if ir.tex1 is not None else (1, 1, 1)
        return self._add_record(dict(
            ttype=TEX_CONSTANT, flags=0, image_idx=-1,
            uscale=1.0, vscale=1.0,
            color1=np.asarray(c, np.float32),
            color2=np.zeros(3, np.float32), sub1=-1, sub2=-1,
        ))

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
