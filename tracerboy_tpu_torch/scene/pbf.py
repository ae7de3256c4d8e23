"""PBF binary scene format: reader + writer for Ingo Wald's `.pbf` files.

The reference parses `.pbrt` once and caches/loads the semantic scene
graph as `.pbf` (~100x faster loads; TracerBoy.cpp:1200-1223,
PBRTParser/impl/semantic/BinaryFileFormat.cpp). This module implements
that wire format from its serialization code so pre-existing `.pbf`
assets open directly, and scenes can be exported for the reference
toolchain. Field orders are transcribed from each entity's
writeTo/readFrom pair (BinaryFileFormat.cpp:545-1620); the container is
a stream of [uint64 size][int32 tag][payload] entity blocks, children
serialized before their referents, references as int32 entity indices
(-1 = null), format tag 9 (BinaryFileFormat.cpp:36-48).

Reading maps onto the same SceneIR the text parser emits (instances are
kept; the compiler flattens them). Writing emits the subset our IR
carries (triangle meshes, the 12 material classes we track, image/
checker/scale/constant textures, area/infinite/distant/point lights).

A numpy copy of tracerboy_tpu/scene/pbf.py.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.scene.types import (
    CameraIR,
    DistantLightIR,
    FilmIR,
    InfiniteLightIR,
    InstanceIR,
    MaterialIR,
    ObjectIR,
    PointLightIR,
    SceneIR,
    TextureIR,
    TriangleMeshIR,
)

FORMAT_TAG = 9

# Entity type tags (BinaryFileFormat.cpp:50-104).
T_SCENE, T_OBJECT, T_SHAPE, T_INSTANCE, T_CAMERA = 1, 2, 3, 4, 5
T_FILM, T_SPECTRUM, T_SAMPLER, T_INTEGRATOR = 6, 7, 8, 9
T_MATERIAL = 10
T_DISNEY, T_UBER, T_MIX, T_GLASS, T_MIRROR, T_MATTE = 11, 12, 13, 14, 15, 16
T_SUBSTRATE, T_SUBSURFACE, T_FOURIER, T_METAL = 17, 18, 19, 20
T_PLASTIC, T_TRANSLUCENT, T_HAIR = 21, 22, 23
T_TEXTURE = 30
T_IMAGE_TEX, T_SCALE_TEX, T_PTEX, T_CONST_TEX, T_CHECKER_TEX = (
    31, 32, 33, 34, 35
)
T_WINDY_TEX, T_FBM_TEX, T_MARBLE_TEX, T_MIX_TEX, T_WRINKLED_TEX = (
    36, 37, 38, 39, 40
)
T_TRIANGLE_MESH, T_QUAD_MESH, T_SPHERE, T_DISK, T_CURVE = 50, 51, 52, 53, 54
T_AREALIGHT_BB, T_AREALIGHT_RGB = 60, 61
T_INFINITE_LIGHT, T_DISTANT_LIGHT, T_SPOT_LIGHT, T_POINT_LIGHT = (
    70, 71, 72, 73
)
T_PIXEL_FILTER = 80


# ----------------------------------------------------------------------------
# Payload cursors


class _R:
    """Little-endian cursor over one entity payload."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def raw(self, n):
        b = self.d[self.o:self.o + n]
        self.o += n
        return b

    def i32(self):
        return struct.unpack_from("<i", self.d, self._adv(4))[0]

    def u64(self):
        return struct.unpack_from("<Q", self.d, self._adv(8))[0]

    def f32(self):
        return struct.unpack_from("<f", self.d, self._adv(4))[0]

    def i8(self):
        return struct.unpack_from("<b", self.d, self._adv(1))[0]

    def u8(self):
        return struct.unpack_from("<B", self.d, self._adv(1))[0]

    def _adv(self, n):
        o = self.o
        self.o += n
        return o

    def vec(self, n=3):
        return np.frombuffer(self.raw(4 * n), "<f4").astype(np.float32)

    def vec2i(self):
        return struct.unpack_from("<ii", self.d, self._adv(8))

    def affine(self):
        """affine3f {vec3f vx,vy,vz,p} -> 4x4 row-major matrix."""
        m = np.frombuffer(self.raw(48), "<f4").reshape(4, 3)
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = m[:3].T  # columns vx vy vz
        out[:3, 3] = m[3]
        return out

    def string(self):
        n = self.i32()
        return self.raw(n).decode("utf-8", errors="replace")

    def array(self, comps, dtype="<f4"):
        n = self.u64()
        a = np.frombuffer(
            self.raw(n * comps * np.dtype(dtype).itemsize), dtype
        )
        return a.reshape(n, comps) if comps > 1 else a

    def spectrum(self):
        n = self.u64()
        return np.frombuffer(self.raw(n * 8), "<f4").reshape(n, 2)

    def tex_map(self):
        """std::map<string, Texture::SP>: int32 count + (string, id)."""
        n = self.i32()
        return {self.string(): self.i32() for _ in range(n)}


class _W:
    def __init__(self):
        self.b = bytearray()

    def i32(self, v):
        self.b += struct.pack("<i", int(v))

    def u64(self, v):
        self.b += struct.pack("<Q", int(v))

    def f32(self, v):
        self.b += struct.pack("<f", float(v))

    def i8(self, v):
        self.b += struct.pack("<b", int(v))

    def u8(self, v):
        self.b += struct.pack("<B", int(v))

    def vec(self, v, n=3):
        a = np.zeros(n, np.float32) if v is None else np.asarray(
            v, np.float32
        ).reshape(n)
        self.b += a.astype("<f4").tobytes()

    def affine(self, m4):
        m4 = np.asarray(m4, np.float32)
        cols = np.concatenate([m4[:3, 0], m4[:3, 1], m4[:3, 2], m4[:3, 3]])
        self.b += cols.astype("<f4").tobytes()

    def string(self, s):
        raw = s.encode("utf-8")
        self.i32(len(raw))
        self.b += raw

    def array(self, a, dtype="<f4"):
        if a is None:
            self.u64(0)
            return
        a = np.asarray(a)
        self.u64(a.shape[0])
        self.b += a.astype(dtype).tobytes()

    def tex_map(self, d):
        self.i32(len(d))
        for k, v in d.items():
            self.string(k)
            self.i32(v)


# ----------------------------------------------------------------------------
# Reader


def _read_entities(path: str):
    with open(path, "rb") as f:
        blob = f.read()
    (tag,) = struct.unpack_from("<i", blob, 0)
    if tag != FORMAT_TAG:
        import warnings

        warnings.warn(f"pbf format tag {tag} != {FORMAT_TAG}; trying anyway")
    off = 4
    out = []
    n = len(blob)
    while off + 12 <= n:
        size, etag = struct.unpack_from("<Qi", blob, off)
        off += 12
        out.append((etag, blob[off:off + size]))
        off += size
    return out


def _parse_material(tag, r: _R) -> MaterialIR:
    name = r.string()
    m = MaterialIR(name=name)
    if tag == T_DISNEY:
        m.type = "disney"
        _aniso = r.f32()
        _cc, _ccg = r.f32(), r.f32()
        m.color = r.vec()
        _difftrans = r.f32()
        m.index = r.f32()
        _flat = r.f32()
        m.metallic = r.f32()
        m.roughness = r.f32()
        _sheen, _sheen_t = r.f32(), r.f32()
        m.spec_trans = r.f32()
        _spec_tint = r.f32()
        _thin = r.i8()
    elif tag == T_UBER:
        m.type = "uber"
        m.kd = r.vec()
        m.map_kd = r.i32()
        m.ks = r.vec()
        m.map_ks = r.i32()
        m.kr = r.vec()
        _map_kr = r.i32()
        m.kt = r.vec()
        _map_kt = r.i32()
        m.opacity = r.vec()
        m.map_opacity = r.i32()
        _alpha = r.f32()
        _map_alpha = r.i32()
        _shadow_alpha = r.f32()
        _map_shadow_alpha = r.i32()
        m.index = r.f32()
        m.roughness = r.f32()
        _map_rough = r.i32()
        m.map_bump = r.i32()
    elif tag == T_MIX:
        m.type = "mix"
        m.material0 = r.i32()
        m.material1 = r.i32()
        _map_amount = r.i32()
        m.amount = float(r.vec().mean())
    elif tag == T_GLASS:
        m.type = "glass"
        m.kr = r.vec()
        m.kt = r.vec()
        m.index = r.f32()
    elif tag == T_MIRROR:
        m.type = "mirror"
        m.map_bump = r.i32()
        m.kr = r.vec()
    elif tag == T_MATTE:
        m.type = "matte"
        m.map_kd = r.i32()
        m.kd = r.vec()
        m.sigma = r.f32()
        _map_sigma = r.i32()
        m.map_bump = r.i32()
    elif tag == T_SUBSTRATE:
        m.type = "substrate"
        m.kd = r.vec()
        m.map_kd = r.i32()
        m.ks = r.vec()
        m.map_ks = r.i32()
        m.map_bump = r.i32()
        m.uroughness = r.f32()
        _map_ur = r.i32()
        m.vroughness = r.f32()
        _map_vr = r.i32()
        m.remap_roughness = bool(r.i8())
    elif tag == T_SUBSURFACE:
        m.type = "subsurface"
        m.uroughness = r.f32()
        m.vroughness = r.f32()
        m.remap_roughness = bool(r.i8())
        m.name = r.string() or name
    elif tag == T_FOURIER:
        m.type = "fourier"
        _file = r.string()
    elif tag == T_METAL:
        m.type = "metal"
        m.roughness = r.f32()
        m.uroughness = r.f32()
        m.vroughness = r.f32()
        m.remap_roughness = bool(r.i8())
        _spd_eta = r.spectrum()
        _spd_k = r.spectrum()
        _eta = r.vec()
        _k = r.vec()
        m.map_bump = r.i32()
        _mr, _mur, _mvr = r.i32(), r.i32(), r.i32()
    elif tag == T_PLASTIC:
        m.type = "plastic"
        m.map_kd = r.i32()
        m.map_ks = r.i32()
        m.kd = r.vec()
        m.ks = r.vec()
        m.roughness = r.f32()
        m.remap_roughness = bool(r.i8())
        _mr = r.i32()
        m.map_bump = r.i32()
    elif tag == T_TRANSLUCENT:
        m.type = "translucent"
        m.map_kd = r.i32()
        _reflect = r.vec()
        m.kt = r.vec()  # transmit
        m.kd = r.vec()
    elif tag == T_HAIR:
        m.type = "hair"
        _eumelanin = r.f32()
        _alpha = r.f32()
        _beta_m = r.f32()
    else:  # plain Material base
        m.type = "matte"
        m.kd = np.full(3, 0.5, np.float32)
    return m


def _parse_texture(tag, r: _R) -> TextureIR:
    t = TextureIR()
    if tag == T_IMAGE_TEX:
        t.type = "imagemap"
        t.filename = r.string()
        t.uscale = r.f32()
        t.vscale = r.f32()
    elif tag == T_CONST_TEX:
        t.type = "constant"
        t.tex1 = r.vec()
    elif tag == T_CHECKER_TEX:
        t.type = "checkerboard"
        t.uscale = r.f32()
        t.vscale = r.f32()
        t.tex1 = r.vec()
        t.tex2 = r.vec()
    elif tag == T_SCALE_TEX:
        t.type = "scale"
        t.tex1_name = r.i32()  # resolved to names later
        t.tex2_name = r.i32()
        t.tex1 = r.vec()
        t.tex2 = r.vec()
    elif tag == T_MIX_TEX:
        t.type = "mix"
        _map_amount = r.i32()
        t.tex1_name = r.i32()
        t.tex2_name = r.i32()
        t.tex1 = r.vec()
        t.tex2 = r.vec()
        t.scale = r.f32()  # amount
    elif tag == T_MARBLE_TEX:
        t.type = "constant"
        t.scale = r.f32()
        t.tex1 = np.full(3, 0.5, np.float32)
    else:  # windy/fbm/wrinkled/ptex -> neutral constant
        t.type = "constant"
        if tag == T_PTEX:
            t.filename = r.string()
        t.tex1 = np.full(3, 0.5, np.float32)
    return t


def read_pbf(path: str) -> SceneIR:
    """Parse a `.pbf` binary scene into SceneIR."""
    import os

    entities = _read_entities(path)
    parsed: list = [None] * len(entities)
    scene_idx = None

    # Pass 1: payload decode (references are forward-safe: children are
    # always serialized before their parents).
    for i, (tag, payload) in enumerate(entities):
        r = _R(payload)
        if tag == T_SCENE:
            parsed[i] = ("scene", r.i32(),
                         [r.i32() for _ in range(r.u64())], r.i32())
            scene_idx = i
        elif tag == T_CAMERA:
            fov = r.f32()
            focal = r.f32()
            lens = r.f32()
            frame = r.affine()
            parsed[i] = ("camera", CameraIR(
                type="perspective", fov=fov, camera_to_world=frame,
                lens_radius=lens, focal_distance=focal,
            ))
        elif tag == T_FILM:
            res = r.vec2i()
            parsed[i] = ("film", FilmIR(
                xresolution=res[0], yresolution=res[1],
                filename=r.string(),
            ))
        elif tag in (T_SAMPLER, T_INTEGRATOR, T_PIXEL_FILTER, T_SPECTRUM):
            parsed[i] = ("misc", None)
        elif tag == T_OBJECT:
            name = r.string()
            shapes = [r.i32() for _ in range(r.i32())]
            lights = [r.i32() for _ in range(r.i32())]
            instances = [r.i32() for _ in range(r.i32())]
            parsed[i] = ("object", name, shapes, lights, instances)
        elif tag == T_INSTANCE:
            xfm = r.affine()
            parsed[i] = ("instance", xfm, r.i32())
        elif tag in (T_TRIANGLE_MESH, T_QUAD_MESH, T_SPHERE, T_DISK,
                     T_CURVE):
            mat_id = r.i32()
            _textures = r.tex_map()
            area = r.i32()
            _rev = r.i8()
            _alpha = r.f32()
            if tag == T_TRIANGLE_MESH:
                v = r.array(3)
                n = r.array(3)
                uv = r.array(2)
                idx = r.array(3, "<i4")
                parsed[i] = ("mesh", mat_id, area, v, n, uv, idx)
            elif tag == T_QUAD_MESH:
                v = r.array(3)
                n = r.array(3)
                q = r.array(4, "<i4")
                idx = np.concatenate(
                    [q[:, (0, 1, 2)], q[:, (0, 2, 3)]]
                ) if len(q) else np.zeros((0, 3), np.int32)
                parsed[i] = ("mesh", mat_id, area, v, n, None, idx)
            else:
                parsed[i] = ("misc", None)  # sphere/disk/curve: skipped
        elif tag == T_AREALIGHT_RGB:
            parsed[i] = ("arealight", r.vec())
        elif tag == T_AREALIGHT_BB:
            _temp, _scale = r.f32(), r.f32()
            parsed[i] = ("arealight", np.full(3, 10.0, np.float32))
        elif tag == T_INFINITE_LIGHT:
            parsed[i] = ("light", InfiniteLightIR(
                mapname=r.string(), transform=r.affine(), L=r.vec(),
                scale=r.vec(),
            ))
        elif tag == T_DISTANT_LIGHT:
            frm, to = r.vec(), r.vec()
            L = r.vec()
            scale = r.vec()
            xf = r.affine()
            parsed[i] = ("light", DistantLightIR(
                L=L * scale, direction=(to - frm), transform=xf,
            ))
        elif tag == T_POINT_LIGHT:
            frm = r.vec()
            I = r.vec()
            _spd = r.spectrum()
            scale = r.vec()
            parsed[i] = ("light", PointLightIR(I=I * scale,
                                               from_point=frm))
        elif T_MATERIAL <= tag <= T_HAIR:
            parsed[i] = ("material", _parse_material(tag, r))
        elif T_TEXTURE <= tag <= T_WRINKLED_TEX:
            parsed[i] = ("texture", _parse_texture(tag, r))
        else:
            parsed[i] = ("misc", None)

    if scene_idx is None:
        raise ValueError(f"{path}: no Scene entity found")

    scene = SceneIR(base_dir=os.path.dirname(os.path.abspath(path)))

    # Name registries (entities are anonymous in pbf; synthesize names).
    def tex_name(tid):
        return None if tid < 0 else f"pbf_tex_{tid}"

    def mat_name(mid):
        return "" if mid < 0 else f"pbf_mat_{mid}"

    for i, p in enumerate(parsed):
        if p is None:
            continue
        kind = p[0]
        if kind == "texture":
            t = p[1]
            t.name = tex_name(i)
            if t.type in ("scale", "mix"):
                t.tex1_name = tex_name(t.tex1_name) if isinstance(
                    t.tex1_name, int) and t.tex1_name >= 0 else None
                t.tex2_name = tex_name(t.tex2_name) if isinstance(
                    t.tex2_name, int) and t.tex2_name >= 0 else None
            scene.textures[t.name] = t
        elif kind == "material":
            m = p[1]
            m.name = mat_name(i)
            for attr in ("map_kd", "map_ks", "map_bump", "map_opacity"):
                v = getattr(m, attr)
                if isinstance(v, int):
                    setattr(m, attr, tex_name(v) if v >= 0 else None)
            if m.type == "mix":
                m.material0 = mat_name(m.material0)
                m.material1 = mat_name(m.material1)
            scene.materials[m.name] = m

    def build_mesh(i) -> TriangleMeshIR | None:
        p = parsed[i]
        if p is None or p[0] != "mesh":
            return None
        _, mat_id, area, v, n, uv, idx = p
        mesh = TriangleMeshIR(
            indices=np.asarray(idx, np.int32).reshape(-1, 3),
            positions=np.asarray(v, np.float32),
            normals=np.asarray(n, np.float32) if len(n) else None,
            uvs=(np.asarray(uv, np.float32)
                 if uv is not None and len(uv) else None),
            material=mat_name(mat_id),
        )
        if area >= 0 and parsed[area] and parsed[area][0] == "arealight":
            mesh.emission = parsed[area][1]
        return mesh

    def walk_object(i, xform):
        p = parsed[i]
        if p is None or p[0] != "object":
            return
        _, _name, shape_ids, light_ids, inst_ids = p
        for sid in shape_ids:
            mesh = build_mesh(sid)
            if mesh is not None:
                mesh.transform = xform
                scene.shapes.append(mesh)
        for lid in light_ids:
            lp = parsed[lid]
            if lp and lp[0] == "light":
                scene.lights.append(lp[1])
        for iid in inst_ids:
            ip = parsed[iid]
            if ip and ip[0] == "instance":
                _, xfm, obj_id = ip
                walk_object(obj_id, xform @ xfm)

    _, film_id, camera_ids, world_id = parsed[scene_idx]
    if film_id >= 0 and parsed[film_id] and parsed[film_id][0] == "film":
        scene.film = parsed[film_id][1]
    for cid in camera_ids:
        if parsed[cid] and parsed[cid][0] == "camera":
            scene.camera = parsed[cid][1]
            break
    walk_object(world_id, np.eye(4, dtype=np.float32))
    return scene


# ----------------------------------------------------------------------------
# Writer


def write_pbf(path: str, scene: SceneIR) -> None:
    """Serialize SceneIR as a `.pbf` (format tag 9) the reference
    toolchain can read back."""
    blocks: list[tuple[int, bytes]] = []
    emitted: dict = {}

    def emit(tag, payload: _W) -> int:
        blocks.append((tag, bytes(payload.b)))
        return len(blocks) - 1

    def emit_texture(name) -> int:
        if name is None:
            return -1
        key = ("tex", name)
        if key in emitted:
            return emitted[key]
        t = scene.textures.get(name)
        w = _W()
        if t is None or t.type == "constant":
            w.vec(t.tex1 if t is not None else (1, 1, 1))
            tid = emit(T_CONST_TEX, w)
        elif t.type == "imagemap":
            w.string(t.filename)
            w.f32(t.uscale)
            w.f32(t.vscale)
            tid = emit(T_IMAGE_TEX, w)
        elif t.type == "checkerboard":
            w.f32(t.uscale)
            w.f32(t.vscale)
            w.vec(t.tex1 if t.tex1 is not None else (0, 0, 0))
            w.vec(t.tex2 if t.tex2 is not None else (1, 1, 1))
            tid = emit(T_CHECKER_TEX, w)
        elif t.type == "scale":
            s1 = emit_texture(t.tex1_name)
            s2 = emit_texture(t.tex2_name)
            w.i32(s1)
            w.i32(s2)
            w.vec(t.tex1 if t.tex1 is not None else (1, 1, 1))
            w.vec(t.tex2 if t.tex2 is not None else (1, 1, 1))
            tid = emit(T_SCALE_TEX, w)
        else:
            w.vec((0.5, 0.5, 0.5))
            tid = emit(T_CONST_TEX, w)
        emitted[key] = tid
        return tid

    def emit_material(name) -> int:
        key = ("mat", name)
        if key in emitted:
            return emitted[key]
        m = scene.materials.get(name)
        if m is None:
            m = MaterialIR(name=name or "default", type="matte",
                           kd=np.full(3, 0.5, np.float32))
        # Resolve texture children before the material buffer.
        map_kd = emit_texture(m.map_kd)
        map_ks = emit_texture(m.map_ks)
        map_bump = emit_texture(m.map_bump)
        w = _W()
        w.string(m.name)
        v3 = lambda x, d=(0, 0, 0): x if x is not None else d
        if m.type == "disney":
            w.f32(0.0)  # anisotropic
            w.f32(0.0)  # clearCoat
            w.f32(1.0)  # clearCoatGloss
            w.vec(v3(m.color, (0.5, 0.5, 0.5)))
            w.f32(1.0)  # diffTrans
            w.f32(m.index)
            w.f32(0.0)  # flatness
            w.f32(m.metallic)
            w.f32(m.roughness)
            w.f32(0.0)  # sheen
            w.f32(0.5)  # sheenTint
            w.f32(m.spec_trans)
            w.f32(0.0)  # specularTint
            w.i8(0)     # thin
            tid = emit(T_DISNEY, w)
        elif m.type == "uber":
            w.vec(v3(m.kd, (0.5, 0.5, 0.5)))
            w.i32(map_kd)
            w.vec(v3(m.ks))
            w.i32(map_ks)
            w.vec(v3(m.kr))
            w.i32(-1)
            w.vec(v3(m.kt))
            w.i32(-1)
            w.vec(v3(m.opacity, (1, 1, 1)))
            w.i32(emit_texture(m.map_opacity))
            w.f32(1.0)   # alpha
            w.i32(-1)
            w.f32(1.0)   # shadowAlpha
            w.i32(-1)
            w.f32(m.index)
            w.f32(m.roughness)
            w.i32(-1)
            w.i32(map_bump)
            tid = emit(T_UBER, w)
        elif m.type == "mix":
            i0 = emit_material(m.material0)
            i1 = emit_material(m.material1)
            w.i32(i0)
            w.i32(i1)
            w.i32(-1)
            w.vec(np.full(3, m.amount, np.float32))
            tid = emit(T_MIX, w)
        elif m.type == "glass":
            w.vec(v3(m.kr, (1, 1, 1)))
            w.vec(v3(m.kt, (1, 1, 1)))
            w.f32(m.index)
            tid = emit(T_GLASS, w)
        elif m.type == "mirror":
            w.i32(map_bump)
            w.vec(v3(m.kr, (0.9, 0.9, 0.9)))
            tid = emit(T_MIRROR, w)
        elif m.type == "metal":
            w.f32(m.roughness)
            w.f32(m.uroughness)
            w.f32(m.vroughness)
            w.i8(1 if m.remap_roughness else 0)
            w.u64(0)  # spectrum_eta
            w.u64(0)  # spectrum_k
            w.vec((1, 1, 1))  # eta
            w.vec((1, 1, 1))  # k
            w.i32(map_bump)
            w.i32(-1)
            w.i32(-1)
            w.i32(-1)
            tid = emit(T_METAL, w)
        elif m.type == "plastic":
            w.i32(map_kd)
            w.i32(map_ks)
            w.vec(v3(m.kd, (0.5, 0.5, 0.5)))
            w.vec(v3(m.ks))
            w.f32(m.roughness)
            w.i8(1 if m.remap_roughness else 0)
            w.i32(-1)
            w.i32(map_bump)
            tid = emit(T_PLASTIC, w)
        elif m.type == "substrate":
            w.vec(v3(m.kd, (0.5, 0.5, 0.5)))
            w.i32(map_kd)
            w.vec(v3(m.ks))
            w.i32(map_ks)
            w.i32(map_bump)
            w.f32(m.uroughness)
            w.i32(-1)
            w.f32(m.vroughness)
            w.i32(-1)
            w.i8(1 if m.remap_roughness else 0)
            tid = emit(T_SUBSTRATE, w)
        elif m.type == "translucent":
            w.i32(map_kd)
            w.vec((0.5, 0.5, 0.5))  # reflect
            w.vec(v3(m.kt, (0.5, 0.5, 0.5)))  # transmit
            w.vec(v3(m.kd, (0.25, 0.25, 0.25)))
            tid = emit(T_TRANSLUCENT, w)
        else:  # matte and everything unmapped
            w.i32(map_kd)
            w.vec(v3(m.kd, (0.5, 0.5, 0.5)))
            w.f32(m.sigma)
            w.i32(-1)
            w.i32(map_bump)
            tid = emit(T_MATTE, w)
        emitted[key] = tid
        return tid

    def emit_mesh(mesh: TriangleMeshIR) -> int:
        mat_id = emit_material(mesh.material)
        area_id = -1
        if mesh.emission is not None and np.asarray(mesh.emission).max() > 0:
            aw = _W()
            aw.vec(mesh.emission)
            area_id = emit(T_AREALIGHT_RGB, aw)
        # Bake the IR transform (pbf meshes are world-space within their
        # object; instance transforms handle the rest).
        M = np.asarray(mesh.transform, np.float32)
        pos = mesh.positions @ M[:3, :3].T + M[:3, 3]
        nrm = mesh.normals
        if nrm is not None:
            nit = np.linalg.inv(M[:3, :3]).T
            nrm = mesh.normals @ nit.T
        w = _W()
        w.i32(mat_id)
        w.tex_map({})
        w.i32(area_id)
        w.i8(1 if mesh.reverse_orientation else 0)
        w.f32(1.0)  # shape alpha
        w.array(pos)
        w.array(nrm)
        w.array(mesh.uvs)
        w.array(np.asarray(mesh.indices, np.int32), "<i4")
        return emit(T_TRIANGLE_MESH, w)

    def emit_light(light) -> int:
        w = _W()
        if isinstance(light, InfiniteLightIR):
            w.string(light.mapname or "")
            w.affine(light.transform)
            w.vec(light.L if light.L is not None else (1, 1, 1))
            w.vec(light.scale if light.scale is not None else (1, 1, 1))
            w.i32(1)  # nSamples
            return emit(T_INFINITE_LIGHT, w)
        if isinstance(light, DistantLightIR):
            w.vec((0, 0, 0))
            w.vec(light.direction)
            w.vec(light.L if light.L is not None else (1, 1, 1))
            w.vec((1, 1, 1))
            w.affine(light.transform)
            return emit(T_DISTANT_LIGHT, w)
        if isinstance(light, PointLightIR):
            w.vec(light.from_point if light.from_point is not None
                  else (0, 0, 0))
            w.vec(light.I if light.I is not None else (1, 1, 1))
            w.u64(0)  # Ispectrum
            w.vec((1, 1, 1))
            return emit(T_POINT_LIGHT, w)
        return -1

    # World object: flattened shapes + named-object instances.
    obj_ids = {}
    for name, obj in scene.objects.items():
        shape_ids = [emit_mesh(s) for s in obj.shapes
                     if isinstance(s, TriangleMeshIR)]
        w = _W()
        w.string(name)
        w.i32(len(shape_ids))
        for sid in shape_ids:
            w.i32(sid)
        w.i32(0)
        w.i32(0)
        obj_ids[name] = emit(T_OBJECT, w)

    inst_ids = []
    for inst in scene.instances:
        if inst.object_name not in obj_ids:
            continue
        w = _W()
        w.affine(inst.transform)
        w.i32(obj_ids[inst.object_name])
        inst_ids.append(emit(T_INSTANCE, w))

    shape_ids = [emit_mesh(s) for s in scene.shapes
                 if isinstance(s, TriangleMeshIR)]
    light_ids = [emit_light(l) for l in scene.lights]
    light_ids = [l for l in light_ids if l >= 0]

    w = _W()
    w.string("world")
    w.i32(len(shape_ids))
    for sid in shape_ids:
        w.i32(sid)
    w.i32(len(light_ids))
    for lid in light_ids:
        w.i32(lid)
    w.i32(len(inst_ids))
    for iid in inst_ids:
        w.i32(iid)
    world_id = emit(T_OBJECT, w)

    fw = _W()
    fw.i32(scene.film.xresolution)
    fw.i32(scene.film.yresolution)
    fw.string(scene.film.filename)
    film_id = emit(T_FILM, fw)

    cw = _W()
    cw.f32(scene.camera.fov)
    cw.f32(scene.camera.focal_distance)
    cw.f32(scene.camera.lens_radius)
    cw.affine(scene.camera.camera_to_world)
    cw.b += b"\0" * (18 * 4)  # 'simplified' block (derived; zeros ok)
    cam_id = emit(T_CAMERA, cw)

    sw = _W()
    sw.i32(film_id)
    sw.u64(1)
    sw.i32(cam_id)
    sw.i32(world_id)
    emit(T_SCENE, sw)

    with open(path, "wb") as f:
        f.write(struct.pack("<i", FORMAT_TAG))
        for tag, payload in blocks:
            f.write(struct.pack("<Qi", len(payload), tag))
            f.write(payload)
