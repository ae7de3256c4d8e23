"""Material conversion: pbrt material IR -> flat SoA material table.

Replicates the semantics of the reference's CreateMaterial
(TracerBoy/TracerBoy.cpp:273-505) and its flag system
(TracerBoy/SharedShaderStructs.h:116-124): each of the 12 pbrt material
classes maps onto one flat record {albedo, emissive, ior, roughness,
absorption, scattering, specular_coef, flags, texture indices}. The
renderer's BSDF dispatch keys off the flag bits exactly as the reference's
shading kernel does.

Layout is struct-of-arrays so the shading stage gathers one field across
a whole ray wave at a time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Flag bits (SharedShaderStructs.h:116-124)
DEFAULT_FLAG = 0x0
METALLIC_FLAG = 0x1
SUBSURFACE_SCATTER_FLAG = 0x2
NO_SPECULAR_FLAG = 0x4
MIX_FLAG = 0x8
LIGHT_FLAG = 0x10
NO_ALPHA_FLAG = 0x20
HAIR_FLAG = 0x40
SINGLE_SIDED_FLAG = 0x80

NO_TEXTURE = -1
AIR_IOR = 1.0


def specular_to_ior(specular: float) -> float:
    """Invert Schlick's F0 = ((n-1)/(n+1))^2 for n (TracerBoy.cpp:123-126)."""
    s = np.sqrt(max(specular, 0.0))
    return float((s + 1.0) / max(1.0 - s, 1e-6))


@dataclass
class FlatMaterial:
    albedo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ior: float = 1.5
    roughness: float = 0.0
    absorption: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scattering: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    specular_coef: float = 0.0
    flags: int = DEFAULT_FLAG
    albedo_tex: int = NO_TEXTURE
    alpha_tex: int = NO_TEXTURE
    normal_tex: int = NO_TEXTURE
    emissive_tex: int = NO_TEXTURE
    specular_tex: int = NO_TEXTURE


class MaterialTable:
    """Accumulates flat materials; the analog of the reference's
    MaterialTracker (TracerBoy.cpp:130-156), keyed by (name, emissive)."""

    def __init__(self):
        self.records: list[FlatMaterial] = []
        self._by_key: dict = {}

    def add(self, key, record: FlatMaterial) -> int:
        if key is not None and key in self._by_key:
            return self._by_key[key]
        idx = len(self.records)
        self.records.append(record)
        if key is not None:
            self._by_key[key] = idx
        return idx

    def get_index(self, key):
        return self._by_key.get(key)

    def to_soa(self) -> dict:
        n = max(len(self.records), 1)
        recs = self.records or [FlatMaterial()]
        return dict(
            albedo=np.stack([r.albedo for r in recs]).astype(np.float32),
            emissive=np.stack([r.emissive for r in recs]).astype(np.float32),
            ior=np.array([r.ior for r in recs], np.float32),
            roughness=np.array([r.roughness for r in recs], np.float32),
            absorption=np.stack([r.absorption for r in recs]).astype(np.float32),
            scattering=np.stack([r.scattering for r in recs]).astype(np.float32),
            specular_coef=np.array([r.specular_coef for r in recs], np.float32),
            flags=np.array([r.flags for r in recs], np.int32),
            albedo_tex=np.array([r.albedo_tex for r in recs], np.int32),
            alpha_tex=np.array([r.alpha_tex for r in recs], np.int32),
            normal_tex=np.array([r.normal_tex for r in recs], np.int32),
            emissive_tex=np.array([r.emissive_tex for r in recs], np.int32),
            specular_tex=np.array([r.specular_tex for r in recs], np.int32),
        )


def _v3(x, default=(0.0, 0.0, 0.0)):
    if x is None:
        return np.asarray(default, np.float32)
    return np.asarray(x, np.float32).reshape(3)


def convert_material(
    mat_ir,
    emissive,
    table: MaterialTable,
    texture_allocator,
    material_lookup,
    alpha_texture=None,
) -> int:
    """Convert one MaterialIR (+area-light emission) to a flat record index.

    `texture_allocator(name_or_ir, gamma) -> int` resolves texture refs;
    `material_lookup(name) -> MaterialIR` resolves mix sub-materials.
    Mirrors CreateMaterial's per-class mapping (TracerBoy.cpp:273-505).
    """
    emissive = _v3(emissive)
    m = FlatMaterial()
    m.emissive = emissive
    m.flags = LIGHT_FLAG if float(emissive.mean()) > 0.0 else DEFAULT_FLAG

    has_alpha = False
    if alpha_texture is not None:
        m.alpha_tex = texture_allocator(alpha_texture, gamma=False)
        has_alpha = True

    t = mat_ir.type if mat_ir is not None else None

    if mat_ir is None:
        pass  # default record
    elif t == "disney":
        m.albedo = _v3(mat_ir.color, (0.5, 0.5, 0.5))
        m.roughness = mat_ir.roughness
        m.ior = mat_ir.index
        if mat_ir.metallic > 0.5:
            m.flags |= METALLIC_FLAG
        if mat_ir.spec_trans > 0.001:
            m.flags |= SUBSURFACE_SCATTER_FLAG
            m.absorption = np.zeros(3, np.float32)
            m.roughness = 0.0
    elif t == "uber":
        if mat_ir.map_kd:
            m.albedo_tex = texture_allocator(mat_ir.map_kd, gamma=True)
        if mat_ir.map_normal:
            m.normal_tex = texture_allocator(mat_ir.map_normal, gamma=False)
        m.albedo = _v3(mat_ir.kd, (0.5, 0.5, 0.5))
        m.roughness = (
            mat_ir.uroughness if mat_ir.uroughness > 0.0 else mat_ir.roughness
        )
        opacity = _v3(mat_ir.opacity, (1, 1, 1))
        if float(opacity.mean()) < 1.0:
            m.flags |= SUBSURFACE_SCATTER_FLAG | SINGLE_SIDED_FLAG
            m.ior = mat_ir.index
            m.absorption = _v3(mat_ir.kt)
    elif t == "mix":
        sub0 = material_lookup(mat_ir.material0)
        sub1 = material_lookup(mat_ir.material1)
        i0 = convert_material(
            sub0, emissive, table, texture_allocator, material_lookup
        )
        i1 = convert_material(
            sub1, emissive, table, texture_allocator, material_lookup
        )
        m.flags = MIX_FLAG
        # Same packing trick as the reference: albedo carries
        # (mat0_index, mat1_index, mix_amount).
        m.albedo = np.array([i0, i1, mat_ir.amount], np.float32)
    elif t == "mirror":
        m.albedo = _v3(mat_ir.kr, (0.9, 0.9, 0.9))
        m.specular_coef = 1.0
        m.roughness = 0.0
        m.flags |= METALLIC_FLAG
    elif t == "metal":
        m.albedo = np.ones(3, np.float32)
        m.ior = mat_ir.index
        m.roughness = mat_ir.uroughness if mat_ir.uroughness > 0 else mat_ir.roughness
        m.flags |= METALLIC_FLAG
    elif t == "substrate":
        if mat_ir.map_kd:
            m.albedo_tex = texture_allocator(mat_ir.map_kd, gamma=False)
        m.albedo = _v3(mat_ir.kd, (0.5, 0.5, 0.5))
        ks_avg = float(_v3(mat_ir.ks).mean())
        m.ior = specular_to_ior(ks_avg)
        m.specular_coef = ks_avg
        m.roughness = mat_ir.uroughness
    elif t == "glass":
        m.albedo = np.zeros(3, np.float32)
        m.absorption = np.zeros(3, np.float32)
        m.ior = mat_ir.index
        # Rough glass: pow-lobe refraction kicks in above the
        # perfect-specular threshold (kernel.glsl:196-199).
        m.roughness = max(mat_ir.uroughness, mat_ir.roughness)
        m.flags |= SUBSURFACE_SCATTER_FLAG
    elif t == "subsurface":
        # pbrt SubsurfaceMaterial: IOR = eta, scattering = 1/mfp, SSS
        # flag — the mapping of the reference's pSubsurfaceMaterial
        # branch (TracerBoy.cpp:454-471; its body is compiled out behind
        # HANDLE_FAILURE/#if 0 — the intended conversion is implemented
        # here, so subsurface scenes no longer get the brown fallback).
        if mat_ir.map_kd:
            m.albedo_tex = texture_allocator(mat_ir.map_kd, gamma=True)
        m.ior = mat_ir.index          # parsed "eta"
        m.roughness = mat_ir.uroughness
        m.absorption = np.zeros(3, np.float32)
        mfp = _v3(getattr(mat_ir, "mfp", None), (1.0, 1.0, 1.0))
        m.scattering = (1.0 / np.maximum(mfp, 1e-6)).astype(np.float32)
        # "Disabling specular because it currently over-darkens"
        m.flags |= SUBSURFACE_SCATTER_FLAG | NO_SPECULAR_FLAG
    elif t == "hair":
        # pbrt HairMaterial: the shading kernel treats HAIR_FLAG like
        # the metallic lobe (kernel.glsl:188 IsMetallic). Approximate
        # the fiber color from the absorption coefficient.
        sig = _v3(getattr(mat_ir, "sigma_a", None), (0.6, 0.9, 1.3))
        m.albedo = np.exp(-np.asarray(sig, np.float32) * 0.8)
        m.roughness = max(mat_ir.roughness, 0.3)
        m.flags |= HAIR_FLAG
    elif t == "fourier":
        m.albedo = np.full(3, 0.6, np.float32)
        m.roughness = 0.2
    elif t == "matte":
        m.roughness = mat_ir.sigma
        if mat_ir.map_kd:
            m.albedo_tex = texture_allocator(mat_ir.map_kd, gamma=False)
        m.albedo = _v3(mat_ir.kd, (0.5, 0.5, 0.5))
        m.flags |= NO_SPECULAR_FLAG
    elif t == "plastic":
        m.roughness = mat_ir.roughness
        if mat_ir.map_kd:
            m.albedo_tex = texture_allocator(mat_ir.map_kd, gamma=False)
        m.albedo = _v3(mat_ir.kd, (0.5, 0.5, 0.5))
        ks_avg = float(_v3(mat_ir.ks).mean())
        m.ior = specular_to_ior(ks_avg)
        m.specular_coef = ks_avg
    elif t == "translucent":
        if mat_ir.map_kd:
            m.albedo_tex = texture_allocator(mat_ir.map_kd, gamma=False)
            m.albedo = _v3(mat_ir.kd, (0.5, 0.5, 0.5))
        else:
            m.albedo = np.zeros(3, np.float32)
            m.absorption = np.full(3, 0.001, np.float32)
            m.flags |= SUBSURFACE_SCATTER_FLAG
    else:
        # Unknown class: neutral brown fallback, as the reference does.
        m.albedo = np.array([153 / 255.0, 102 / 255.0, 58 / 255.0], np.float32)
        m.roughness = 0.2

    # Albedo-alpha fallback: an albedo image with a real alpha channel
    # doubles as the cutout mask (SharedHitGroup.h:171-178).
    if not has_alpha and m.albedo_tex >= 0:
        companion = getattr(texture_allocator, "alpha_companion", {})
        alpha_rec = companion.get(m.albedo_tex, -1)
        if alpha_rec >= 0:
            m.alpha_tex = alpha_rec
            has_alpha = True

    if not has_alpha:
        m.flags |= NO_ALPHA_FLAG

    key = (id(mat_ir), tuple(np.round(emissive, 6).tolist()))
    return table.add(key, m)
