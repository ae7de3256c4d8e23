"""PBRT scene file parser: tokenizer + directive parser -> typed scene IR.

A from-scratch reimplementation of the capability of the vendored PBRTParser
in the reference (PBRTParser/impl/syntactic/{Lexer,Parser}.inl for the token
stage, impl/semantic/* for the typed graph; entry point importPBRT at
PBRTParser/impl/semantic/importPBRT.cpp:26-42). Produces the entity set the
reference's renderer actually consumes: triangle meshes (inline or PLY),
curves, spheres, the 12 material classes, area/infinite/distant/point lights,
image/checkerboard/scale textures, perspective camera, film and sampler
settings.

Grammar notes (pbrt-v3): a scene file is a sequence of directives; arguments
are quoted "type name" strings followed by values, with [ ] around lists
being optional. Include pulls in another file; Attribute/Transform blocks
push/pop graphics state; object instancing via ObjectBegin/End +
ObjectInstance.

A numpy copy of tracerboy_tpu/scene/pbrt_parser.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from tracerboy_tpu_torch.scene.types import (
    SceneIR,
    CameraIR,
    FilmIR,
    SamplerIR,
    IntegratorIR,
    TriangleMeshIR,
    SphereIR,
    CurveIR,
    MaterialIR,
    TextureIR,
    AreaLightIR,
    InfiniteLightIR,
    DistantLightIR,
    PointLightIR,
    InstanceIR,
    ObjectIR,
)


# ----------------------------------------------------------------------------
# Tokenizer


def tokenize(text: str):
    """Yield tokens: quoted strings keep quotes; brackets are tokens."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "#":
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == '"':
            j = text.index('"', i + 1)
            yield text[i : j + 1]
            i = j + 1
            continue
        if c in "[]":
            yield c
            i += 1
            continue
        j = i
        while j < n and text[j] not in ' \t\r\n"[]#':
            j += 1
        yield text[i:j]
        i = j


class _TokenStream:
    """Token stream with pushback and Include support."""

    def __init__(self, path: str):
        self.stack = []
        self._push_file(path)
        self.base_dir = os.path.dirname(os.path.abspath(path))
        self._peeked = None

    def _push_file(self, path: str):
        with open(path, "r", errors="replace") as f:
            text = f.read()
        self.stack.append(tokenize(text))

    def include(self, relpath: str):
        self._push_file(os.path.join(self.base_dir, relpath))

    def next(self):
        if self._peeked is not None:
            t = self._peeked
            self._peeked = None
            return t
        while self.stack:
            try:
                return next(self.stack[-1])
            except StopIteration:
                self.stack.pop()
        return None

    def peek(self):
        if self._peeked is None:
            self._peeked = self.next()
        return self._peeked


_DIRECTIVES = {
    "Integrator", "Transform", "ConcatTransform", "Sampler", "PixelFilter",
    "Film", "Camera", "WorldBegin", "WorldEnd", "AttributeBegin",
    "AttributeEnd", "TransformBegin", "TransformEnd", "ObjectBegin",
    "ObjectEnd", "ObjectInstance", "MakeNamedMaterial", "NamedMaterial",
    "Material", "Texture", "Shape", "AreaLightSource", "LightSource",
    "Translate", "Rotate", "Scale", "LookAt", "Identity", "Include",
    "ReverseOrientation", "MediumInterface", "MakeNamedMedium",
    "CoordinateSystem", "CoordSysTransform", "ActiveTransform",
    "TransformTimes", "Accelerator", "Filter",
}


def _parse_params(ts: _TokenStream) -> dict:
    """Parse the `"type name" [values...]` parameter list after a directive."""
    params = {}
    while True:
        tok = ts.peek()
        if tok is None:
            break
        if not (tok.startswith('"') and " " in tok):
            break  # next directive or a bare string argument
        ts.next()
        decl = tok[1:-1]
        ptype, pname = decl.split(None, 1)
        values = []
        tok = ts.peek()
        bracketed = tok == "["
        if bracketed:
            ts.next()
            while True:
                tok = ts.next()
                if tok == "]" or tok is None:
                    break
                values.append(tok)
        else:
            values.append(ts.next())
        params[pname] = _convert_values(ptype, values)
    return params


def _convert_values(ptype: str, values):
    if ptype in ("integer",):
        return np.array([int(float(v)) for v in values], np.int64)
    if ptype in ("float", "point", "point3", "point2", "vector", "vector3",
                 "normal", "normal3", "rgb", "color", "spectrum", "blackbody",
                 "xyz"):
        try:
            return np.array([float(v) for v in values], np.float64)
        except ValueError:
            # "spectrum" may carry a filename
            return [v.strip('"') for v in values]
    if ptype == "bool":
        return np.array([v.strip('"') == "true" for v in values])
    if ptype in ("string", "texture"):
        out = [v.strip('"') for v in values]
        return out
    return values


def _scalar(params, name, default=None):
    v = params.get(name)
    if v is None:
        return default
    if isinstance(v, list):
        return v[0]
    return v.flat[0] if hasattr(v, "flat") else v


def _vec3(params, name, default=None):
    v = params.get(name)
    if v is None or (isinstance(v, list) and v and isinstance(v[0], str)):
        # Absent, or bound to a texture name (handled via _tex_or_none).
        return None if default is None else np.asarray(default, np.float32)
    a = np.asarray(v, np.float32).reshape(-1)
    if a.size == 1:
        return np.full((3,), a[0], np.float32)
    return a[:3]


# ----------------------------------------------------------------------------
# Transform helpers (column-vector 4x4, pbrt convention)


def _translate(d):
    m = np.eye(4)
    m[:3, 3] = d
    return m


def _scale_m(s):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def _rotate(angle_deg, axis):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) * c + s * K + (1 - c) * np.outer(a, a)
    m = np.eye(4)
    m[:3, :3] = R
    return m


def _look_at(eye, look, up):
    """pbrt LookAt: composes a *world-to-camera* transform into the CTM
    (the camera frame built here is inverted before returning)."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, eye
    return np.linalg.inv(m)


@dataclass
class _GraphicsState:
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    material: str | None = None          # named material reference
    inline_material: MaterialIR | None = None
    area_light: np.ndarray | None = None  # emissive radiance if set
    reverse_orientation: bool = False

    def copy(self):
        return _GraphicsState(
            self.transform.copy(),
            self.material,
            self.inline_material,
            None if self.area_light is None else self.area_light.copy(),
            self.reverse_orientation,
        )


# ----------------------------------------------------------------------------
# Parser


def parse_pbrt(path: str) -> SceneIR:
    """Parse a .pbrt file into the typed SceneIR."""
    ts = _TokenStream(path)
    scene = SceneIR(base_dir=os.path.dirname(os.path.abspath(path)))

    state = _GraphicsState()
    state_stack: list[_GraphicsState] = []
    transform_stack: list[np.ndarray] = []
    in_world = False
    current_object: ObjectIR | None = None
    anonymous_mat_count = 0

    def current_shapes():
        return current_object.shapes if current_object is not None else scene.shapes

    def emit_shape(shape):
        if state.area_light is not None:
            shape.emission = state.area_light.copy()
        shape.reverse_orientation = state.reverse_orientation
        current_shapes().append(shape)

    def resolve_material() -> str:
        nonlocal anonymous_mat_count
        if state.inline_material is not None:
            name = state.inline_material.name
            if name not in scene.materials:
                scene.materials[name] = state.inline_material
            return name
        if state.material is not None:
            return state.material
        return ""  # default material

    while True:
        tok = ts.next()
        if tok is None:
            break
        if tok.startswith('"'):
            continue  # stray string; skip

        if tok == "Include":
            ts.include(ts.next().strip('"'))
        elif tok == "Integrator":
            name = ts.next().strip('"')
            params = _parse_params(ts)
            scene.integrator = IntegratorIR(
                type=name, max_depth=int(_scalar(params, "maxdepth", 5))
            )
        elif tok == "Transform":
            vals = _read_num_list(ts, 16)
            # pbrt matrices are given column-major
            m = np.array(vals, np.float64).reshape(4, 4).T
            state.transform = m if not in_world else m
        elif tok == "ConcatTransform":
            vals = _read_num_list(ts, 16)
            m = np.array(vals, np.float64).reshape(4, 4).T
            state.transform = state.transform @ m
        elif tok == "Identity":
            state.transform = np.eye(4)
        elif tok == "Translate":
            state.transform = state.transform @ _translate(_read_floats(ts, 3))
        elif tok == "Scale":
            state.transform = state.transform @ _scale_m(_read_floats(ts, 3))
        elif tok == "Rotate":
            v = _read_floats(ts, 4)
            state.transform = state.transform @ _rotate(v[0], v[1:])
        elif tok == "LookAt":
            v = _read_floats(ts, 9)
            state.transform = state.transform @ _look_at(v[0:3], v[3:6], v[6:9])
        elif tok == "Sampler":
            name = ts.next().strip('"')
            params = _parse_params(ts)
            scene.sampler = SamplerIR(
                type=name, pixel_samples=int(_scalar(params, "pixelsamples", 16))
            )
        elif tok in ("PixelFilter", "Filter"):
            name = ts.next().strip('"')
            params = _parse_params(ts)
            scene.pixel_filter = name
            scene.filter_xwidth = float(_scalar(params, "xwidth", 1.0))
        elif tok == "Film":
            ts.next()  # "image"
            params = _parse_params(ts)
            scene.film = FilmIR(
                xresolution=int(_scalar(params, "xresolution", 640)),
                yresolution=int(_scalar(params, "yresolution", 480)),
                filename=str(_scalar(params, "filename", "out.png")),
            )
        elif tok == "Camera":
            name = ts.next().strip('"')
            params = _parse_params(ts)
            # camera-to-world is the inverse of the current (world-to-camera) CTM
            scene.camera = CameraIR(
                type=name,
                fov=float(_scalar(params, "fov", 90.0)),
                camera_to_world=np.linalg.inv(state.transform),
                lens_radius=float(_scalar(params, "lensradius", 0.0)),
                focal_distance=float(_scalar(params, "focaldistance", 1e6)),
            )
        elif tok == "WorldBegin":
            in_world = True
            state = _GraphicsState()
        elif tok == "WorldEnd":
            pass
        elif tok == "AttributeBegin":
            state_stack.append(state.copy())
        elif tok == "AttributeEnd":
            state = state_stack.pop()
        elif tok == "TransformBegin":
            transform_stack.append(state.transform.copy())
        elif tok == "TransformEnd":
            state.transform = transform_stack.pop()
        elif tok == "ObjectBegin":
            name = ts.next().strip('"')
            state_stack.append(state.copy())
            current_object = ObjectIR(name=name)
            scene.objects[name] = current_object
        elif tok == "ObjectEnd":
            current_object = None
            state = state_stack.pop()
        elif tok == "ObjectInstance":
            name = ts.next().strip('"')
            scene.instances.append(
                InstanceIR(object_name=name, transform=state.transform.copy())
            )
        elif tok == "MakeNamedMaterial":
            name = ts.next().strip('"')
            params = _parse_params(ts)
            mtype = _scalar(params, "type", "matte")
            scene.materials[name] = _make_material(name, str(mtype), params, scene)
        elif tok == "NamedMaterial":
            state.material = ts.next().strip('"')
            state.inline_material = None
        elif tok == "Material":
            mtype = ts.next().strip('"')
            params = _parse_params(ts)
            anonymous_mat_count += 1
            name = f"__inline_{anonymous_mat_count}_{mtype}"
            state.inline_material = _make_material(name, mtype, params, scene)
            state.material = None
        elif tok == "Texture":
            name = ts.next().strip('"')
            ttype = ts.next().strip('"')  # "spectrum"/"float"
            tclass = ts.next().strip('"')  # "imagemap"/"checkerboard"/"scale"
            params = _parse_params(ts)
            scene.textures[name] = _make_texture(name, tclass, params)
        elif tok == "Shape":
            stype = ts.next().strip('"')
            params = _parse_params(ts)
            shape = _make_shape(stype, params, state, resolve_material(), scene)
            if shape is not None:
                emit_shape(shape)
        elif tok == "AreaLightSource":
            ts.next()  # "diffuse"
            params = _parse_params(ts)
            state.area_light = np.asarray(_vec3(params, "L", [1, 1, 1]), np.float32)
            scale = _scalar(params, "scale", None)
            if scale is not None:
                state.area_light *= float(scale)
        elif tok == "LightSource":
            ltype = ts.next().strip('"')
            params = _parse_params(ts)
            _make_light(ltype, params, state, scene)
        elif tok == "ReverseOrientation":
            state.reverse_orientation = not state.reverse_orientation
        elif tok == "MakeNamedMedium":
            # pbrt-v3 grid medium -> the scene's single heterogeneous
            # volume (the reference's one-volume model; first one wins).
            ts.next()  # medium name
            params = _parse_params(ts)
            mtype = params.get("type")
            mtype = (mtype[0] if isinstance(mtype, list) and mtype
                     else mtype) or ""
            if scene.volume is None and "heterogeneous" in str(mtype):
                from tracerboy_tpu_torch.scene.volume import from_pbrt_medium

                scene.volume = from_pbrt_medium(params)
        elif tok in ("MediumInterface", "CoordinateSystem",
                     "CoordSysTransform", "ActiveTransform", "TransformTimes",
                     "Accelerator"):
            _parse_params(ts)  # consume and ignore
        else:
            # Unknown directive: consume its params defensively
            _parse_params(ts)

    return scene


def _read_num_list(ts: _TokenStream, count: int):
    vals = []
    while len(vals) < count:
        tok = ts.next()
        if tok in ("[", "]"):
            continue
        vals.append(float(tok))
    # consume trailing ']' if present
    if ts.peek() == "]":
        ts.next()
    return vals


def _read_floats(ts: _TokenStream, count: int):
    return np.array(_read_num_list(ts, count), np.float64)


# ----------------------------------------------------------------------------
# Entity constructors


def _tex_or_none(params, name):
    v = params.get(name)
    if isinstance(v, list) and v and isinstance(v[0], str):
        return v[0]
    return None


def _make_material(name, mtype, params, scene) -> MaterialIR:
    """Map pbrt material parameters into the IR.

    Field semantics mirror the reference's pbrt scene graph materials
    (PBRTParser/include/pbrtParser/Scene.h:89-1247): 12 classes, each with
    the kd/ks/roughness/index/opacity parameters the renderer consumes.
    """
    m = MaterialIR(name=name, type=mtype)
    m.kd = _vec3(params, "Kd", [0.5, 0.5, 0.5])
    m.ks = _vec3(params, "Ks", [0.0, 0.0, 0.0])
    m.kr = _vec3(params, "Kr", [0.9, 0.9, 0.9])
    m.kt = _vec3(params, "Kt", [0.0, 0.0, 0.0])
    m.map_kd = _tex_or_none(params, "Kd")
    m.map_ks = _tex_or_none(params, "Ks")
    m.map_bump = _tex_or_none(params, "bumpmap")
    m.map_normal = _tex_or_none(params, "normalmap")
    m.map_opacity = _tex_or_none(params, "opacity")
    rough = _scalar(params, "roughness", None)
    urough = _scalar(params, "uroughness", None)
    m.roughness = float(rough) if rough is not None else 0.0
    m.uroughness = float(urough) if urough is not None else 0.0
    m.vroughness = float(_scalar(params, "vroughness", m.uroughness))
    m.remap_roughness = bool(_scalar(params, "remaproughness", True))
    m.index = float(_scalar(params, "index", _scalar(params, "eta", 1.5) if mtype != "metal" else 0.0) or 1.5)
    if mtype == "metal":
        eta = _vec3(params, "eta", [0.2, 0.92, 1.1])
        m.index = float(np.mean(eta))
    m.opacity = _vec3(params, "opacity", [1.0, 1.0, 1.0])
    m.sigma = float(_scalar(params, "sigma", 0.0))
    # subsurface / hair parameters
    m.mfp = _vec3(params, "mfp", [1.0, 1.0, 1.0])
    m.sigma_a = _vec3(params, "sigma_a", [0.6, 0.9, 1.3])
    # disney parameters
    m.color = _vec3(params, "color", m.kd)
    m.metallic = float(_scalar(params, "metallic", 0.0))
    m.spec_trans = float(_scalar(params, "spectrans", 0.0))
    # mix material
    mats = params.get("namedmaterial1")
    if mats:
        m.material0 = mats[0] if isinstance(mats, list) else str(mats)
    mats = params.get("namedmaterial2")
    if mats:
        m.material1 = mats[0] if isinstance(mats, list) else str(mats)
    amt = params.get("amount")
    m.amount = float(np.mean(amt)) if amt is not None else 0.5
    return m


def _make_texture(name, tclass, params) -> TextureIR:
    t = TextureIR(name=name, type=tclass)
    if tclass == "imagemap":
        t.filename = str(_scalar(params, "filename", ""))
        t.gamma = bool(_scalar(params, "gamma", True))
        t.uscale = float(_scalar(params, "uscale", 1.0))
        t.vscale = float(_scalar(params, "vscale", 1.0))
        t.scale = float(_scalar(params, "scale", 1.0))
    elif tclass == "checkerboard":
        t.uscale = float(_scalar(params, "uscale", 1.0))
        t.vscale = float(_scalar(params, "vscale", 1.0))
        t.tex1 = _vec3(params, "tex1", [0.0, 0.0, 0.0])
        t.tex2 = _vec3(params, "tex2", [1.0, 1.0, 1.0])
    elif tclass == "scale":
        t.tex1_name = _tex_or_none(params, "tex1")
        t.tex2_name = _tex_or_none(params, "tex2")
        t.tex1 = _vec3(params, "tex1", [1.0, 1.0, 1.0])
        t.tex2 = _vec3(params, "tex2", [1.0, 1.0, 1.0])
    elif tclass == "constant":
        t.tex1 = _vec3(params, "value", [1.0, 1.0, 1.0])
    elif tclass == "mix":
        t.tex1 = _vec3(params, "tex1", [0.0, 0.0, 0.0])
        t.tex2 = _vec3(params, "tex2", [1.0, 1.0, 1.0])
        t.tex1_name = _tex_or_none(params, "tex1")
        t.tex2_name = _tex_or_none(params, "tex2")
    elif tclass in ("fbm", "wrinkled", "marble", "windy"):
        # Noise-based procedural textures (the reference's parser
        # models these, PBRTParser Scene.h:297-420; its renderer drops
        # them — TracerBoy.cpp:177-251 handles image/checker/scale
        # only). We keep the parameters; the texture allocator bakes
        # them to an image so they actually shade.
        t.octaves = int(_scalar(params, "octaves", 8))
        t.roughness = float(_scalar(params, "roughness", 0.5))
        t.scale = float(_scalar(params, "scale", 1.0))
        t.variation = float(_scalar(params, "variation", 0.2))
    elif tclass == "ptex":
        # Per-face Ptex needs face ids no runtime here carries (the
        # reference drops it too); record the file for the IR, shade
        # as mid-gray constant.
        t.filename = str(_scalar(params, "filename", ""))
        t.tex1 = np.array([0.5, 0.5, 0.5], np.float32)
    return t


def _make_shape(stype, params, state, material_name, scene):
    xf = state.transform.copy()
    if stype == "trianglemesh":
        idx = np.asarray(params["indices"], np.int32).reshape(-1, 3)
        pos = np.asarray(params["P"], np.float32).reshape(-1, 3)
        nrm = params.get("N")
        uv = params.get("uv", params.get("st"))
        tan = params.get("S")
        return TriangleMeshIR(
            indices=idx,
            positions=pos,
            normals=None if nrm is None else np.asarray(nrm, np.float32).reshape(-1, 3),
            uvs=None if uv is None else np.asarray(uv, np.float32).reshape(-1, 2),
            tangents=None if tan is None else np.asarray(tan, np.float32).reshape(-1, 3),
            material=material_name,
            transform=xf,
            alpha_texture=_tex_or_none(params, "alpha"),
        )
    if stype == "plymesh":
        fname = str(_scalar(params, "filename"))
        from tracerboy_tpu_torch.scene.ply import read_ply

        path = os.path.join(scene.base_dir, fname)
        if not os.path.exists(path):
            # Some shipped scenes reference meshes absent from the asset
            # checkout (e.g. dragon's Mesh008/012/013). Warn and continue.
            import warnings

            warnings.warn(f"plymesh not found, skipping: {path}")
            return None
        pos, idx, nrm, uv = read_ply(path)
        return TriangleMeshIR(
            indices=idx,
            positions=pos,
            normals=nrm,
            uvs=uv,
            tangents=None,
            material=material_name,
            transform=xf,
            alpha_texture=_tex_or_none(params, "alpha"),
        )
    if stype == "sphere":
        return SphereIR(
            radius=float(_scalar(params, "radius", 1.0)),
            material=material_name,
            transform=xf,
        )
    if stype == "curve":
        pts = np.asarray(params["P"], np.float32).reshape(-1, 3)
        w0 = float(_scalar(params, "width0", _scalar(params, "width", 1.0)))
        w1 = float(_scalar(params, "width1", _scalar(params, "width", 1.0)))
        return CurveIR(
            control_points=pts,
            width0=w0,
            width1=w1,
            degree=int(_scalar(params, "degree", 3)),
            material=material_name,
            transform=xf,
        )
    if stype == "disk" or stype == "loopsubdiv":
        return None  # recorded unsupported in reference as well
    return None


def _make_light(ltype, params, state, scene):
    if ltype == "infinite":
        scale = _vec3(params, "scale", [1, 1, 1])
        L = _vec3(params, "L", [1, 1, 1])
        scene.lights.append(
            InfiniteLightIR(
                mapname=str(_scalar(params, "mapname", "")),
                L=L,
                scale=scale,
                transform=state.transform.copy(),
            )
        )
    elif ltype == "distant":
        from_p = _vec3(params, "from", [0, 0, 0])
        to_p = _vec3(params, "to", [0, 0, 1])
        scene.lights.append(
            DistantLightIR(
                L=_vec3(params, "L", [1, 1, 1]),
                direction=(to_p - from_p),
                transform=state.transform.copy(),
            )
        )
    elif ltype == "point":
        scene.lights.append(
            PointLightIR(
                I=_vec3(params, "I", [1, 1, 1]),
                from_point=_vec3(params, "from", [0, 0, 0]),
                transform=state.transform.copy(),
            )
        )
