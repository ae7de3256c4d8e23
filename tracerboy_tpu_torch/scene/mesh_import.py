"""Generic mesh-format import: OBJ (+MTL) and STL -> SceneIR.

The capability of the reference's AssimpImporter (TracerBoy/
AssimpImporter.cpp:41-177): load non-PBRT mesh formats, map Phong-style
materials onto the uber material model, emissive materials onto area
lights, and synthesize a default camera framing the scene bounds. The
reference links Assimp for ~40 formats; here the two most common
interchange formats are parsed natively (no external deps), through the
same SceneIR the PBRT parser emits, so everything downstream is shared.

A numpy copy of tracerboy_tpu/scene/mesh_import.py.
"""

from __future__ import annotations

import os

import numpy as np

from tracerboy_tpu_torch.scene.types import (
    CameraIR,
    MaterialIR,
    SceneIR,
    TextureIR,
    TriangleMeshIR,
)


def import_mesh_scene(path: str) -> SceneIR:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".stl":
        return load_stl(path)
    if ext in (".gltf", ".glb"):
        return load_gltf(path)
    raise ValueError(f"unsupported mesh format: {ext}")


# ----------------------------------------------------------------------------
# OBJ + MTL


def _parse_mtl(path: str, scene: SceneIR):
    """Map MTL materials to uber/matte records (AssimpImporter.cpp:75-140
    maps Phong constants the same way)."""
    if not os.path.exists(path):
        return {}
    emissive = {}
    cur = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "newmtl":
                cur = MaterialIR(name=parts[1], type="uber")
                cur.kd = np.array([0.6, 0.6, 0.6], np.float32)
                cur.ks = np.zeros(3, np.float32)
                cur.opacity = np.ones(3, np.float32)
                cur.roughness = 0.3
                scene.materials[parts[1]] = cur
                emissive[parts[1]] = None
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = np.array([float(x) for x in parts[1:4]], np.float32)
            elif key == "Ks":
                cur.ks = np.array([float(x) for x in parts[1:4]], np.float32)
            elif key == "Ke":
                e = np.array([float(x) for x in parts[1:4]], np.float32)
                if e.max() > 0:
                    emissive[cur.name] = e
            elif key == "Ns":
                # Phong exponent -> roughness (Beckmann-style mapping)
                ns = float(parts[1])
                cur.roughness = float(np.sqrt(2.0 / (ns + 2.0)))
            elif key == "d":
                cur.opacity = np.full(3, float(parts[1]), np.float32)
            elif key == "Ni":
                cur.index = float(parts[1])
            elif key == "map_Kd":
                texname = parts[-1]
                cur.map_kd = f"__tex_{cur.name}"
                scene.textures[cur.map_kd] = TextureIR(
                    name=cur.map_kd, type="imagemap", filename=texname,
                )
    return emissive


def load_obj(path: str) -> SceneIR:
    scene = SceneIR(base_dir=os.path.dirname(os.path.abspath(path)))
    positions, normals, uvs = [], [], []
    # Faces accumulate per active material.
    by_mat: dict = {}
    current_mat = ""
    emissive_map = {}

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                emissive_map.update(
                    _parse_mtl(os.path.join(scene.base_dir, parts[1]), scene)
                )
            elif key == "usemtl":
                current_mat = parts[1]
            elif key == "f":
                corners = []
                for vert in parts[1:]:
                    ids = vert.split("/")
                    vi = int(ids[0])
                    ti = int(ids[1]) if len(ids) > 1 and ids[1] else 0
                    ni = int(ids[2]) if len(ids) > 2 and ids[2] else 0
                    corners.append((vi, ti, ni))
                faces = by_mat.setdefault(current_mat, [])
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))

    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32) if normals else None
    uvs = np.asarray(uvs, np.float32) if uvs else None

    def resolve(idx, count):
        return idx - 1 if idx > 0 else count + idx

    for mat_name, faces in by_mat.items():
        # Re-index into compact per-mesh vertex arrays.
        vert_map = {}
        v_out, n_out, uv_out, tris = [], [], [], []
        for tri in faces:
            ids = []
            for (vi, ti, ni) in tri:
                keyv = (vi, ti, ni)
                if keyv not in vert_map:
                    vert_map[keyv] = len(v_out)
                    v_out.append(positions[resolve(vi, len(positions))])
                    if normals is not None and ni:
                        n_out.append(normals[resolve(ni, len(normals))])
                    if uvs is not None and ti:
                        uv_out.append(uvs[resolve(ti, len(uvs))])
                ids.append(vert_map[keyv])
            tris.append(ids)
        mesh = TriangleMeshIR(
            indices=np.asarray(tris, np.int32),
            positions=np.asarray(v_out, np.float32),
            normals=(np.asarray(n_out, np.float32)
                     if len(n_out) == len(v_out) else None),
            uvs=(np.asarray(uv_out, np.float32)
                 if len(uv_out) == len(v_out) else None),
            material=mat_name,
        )
        e = emissive_map.get(mat_name)
        if e is not None:
            mesh.emission = e
        scene.shapes.append(mesh)

    _default_camera(scene)
    return scene


# ----------------------------------------------------------------------------
# glTF 2.0 (.gltf JSON + .bin / data URIs, and the .glb binary container)

_GLTF_COMPONENT = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_GLTF_ARITY = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def _gltf_buffers(doc: dict, base_dir: str, glb_bin: bytes | None):
    import base64

    bufs = []
    for b in doc.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(glb_bin or b"")
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote

            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                bufs.append(f.read())
    return bufs


def _gltf_accessor(doc: dict, bufs: list, idx: int) -> np.ndarray:
    """Accessor -> (count, arity) float32/int array (sparse unsupported)."""
    acc = doc["accessors"][idx]
    arity = _GLTF_ARITY[acc["type"]]
    dtype = _GLTF_COMPONENT[acc["componentType"]]
    count = acc["count"]
    bv = doc["bufferViews"][acc["bufferView"]]
    data = bufs[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or arity * np.dtype(dtype).itemsize
    raw = np.frombuffer(
        data, np.uint8, count=max((count - 1) * stride, 0)
        + arity * np.dtype(dtype).itemsize, offset=start,
    )
    out = np.lib.stride_tricks.as_strided(
        raw[: 1].view(dtype), shape=(count, arity),
        strides=(stride, np.dtype(dtype).itemsize), writeable=False,
    ) if stride != arity * np.dtype(dtype).itemsize else (
        raw.view(dtype)[: count * arity].reshape(count, arity)
    )
    out = np.array(out)  # own the memory
    if acc.get("normalized") and dtype != np.float32:
        out = out.astype(np.float32) / float(np.iinfo(dtype).max)
    return out


def _gltf_node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        r4 = np.eye(4, dtype=np.float32)
        r4[:3, :3] = r
        m = r4 @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def load_gltf(path: str) -> SceneIR:
    """glTF 2.0 importer: node hierarchy flattened to world space,
    pbrMetallicRoughness mapped onto the uber/metal material models, and
    emissive materials promoted to area lights — the AssimpImporter
    semantics (AssimpImporter.cpp:41-177) for the modern interchange
    format."""
    import json

    scene = SceneIR(base_dir=os.path.dirname(os.path.abspath(path)))
    glb_bin = None
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            blob = f.read()
        assert blob[:4] == b"glTF", "bad GLB magic"
        n = len(blob)
        off = 12
        doc = None
        while off + 8 <= n:
            (clen,) = np.frombuffer(blob, np.uint32, 1, off)
            ctype = blob[off + 4: off + 8]
            payload = blob[off + 8: off + 8 + int(clen)]
            if ctype == b"JSON":
                doc = json.loads(payload)
            elif ctype == b"BIN\x00":
                glb_bin = payload
            off += 8 + int(clen) + ((-int(clen)) % 4)
        assert doc is not None, "GLB without JSON chunk"
    else:
        with open(path, "r") as f:
            doc = json.load(f)

    bufs = _gltf_buffers(doc, scene.base_dir, glb_bin)

    # Texture index -> image file path (data-URI images unsupported).
    def tex_file(tex_idx):
        try:
            img = doc["images"][doc["textures"][tex_idx]["source"]]
            return img.get("uri")
        except (KeyError, IndexError):
            return None

    # Materials -> IR.
    mat_names = []
    emissive_of = {}
    for mi, gm in enumerate(doc.get("materials", [])):
        name = gm.get("name") or f"gltf_mat_{mi}"
        pbr = gm.get("pbrMetallicRoughness", {})
        base = np.asarray(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
        )
        metallic = float(pbr.get("metallicFactor", 1.0))
        rough = float(pbr.get("roughnessFactor", 1.0))
        m = MaterialIR(
            name=name, type="disney" if metallic > 0.5 else "uber",
            color=base[:3], kd=base[:3], roughness=rough,
            metallic=metallic, index=1.5,
            opacity=np.ones(3, np.float32),
        )
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            fn = tex_file(bct["index"])
            if fn:
                m.map_kd = f"__gltf_tex_{mi}"
                scene.textures[m.map_kd] = TextureIR(
                    name=m.map_kd, type="imagemap", filename=fn,
                )
        nt = gm.get("normalTexture")
        if nt is not None:
            fn = tex_file(nt["index"])
            if fn:
                m.map_normal = f"__gltf_nrm_{mi}"
                scene.textures[m.map_normal] = TextureIR(
                    name=m.map_normal, type="imagemap", filename=fn,
                    gamma=False,
                )
        scene.materials[name] = m
        mat_names.append(name)
        emis = np.asarray(gm.get("emissiveFactor", [0, 0, 0]), np.float32)
        emissive_of[name] = emis if emis.max() > 0 else None

    if not mat_names:
        scene.materials["default"] = MaterialIR(
            name="default", type="matte",
            kd=np.array([0.7, 0.7, 0.7], np.float32),
        )

    # Node hierarchy -> world-space meshes.
    nodes = doc.get("nodes", [])
    scene_nodes = doc.get("scenes", [{}])[doc.get("scene", 0)].get(
        "nodes", list(range(len(nodes)))
    )

    def emit_mesh(mesh_idx, xform):
        gmesh = doc["meshes"][mesh_idx]
        nrm_mat = np.linalg.inv(xform[:3, :3]).T
        for prim in gmesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _gltf_accessor(doc, bufs, attrs["POSITION"]).astype(
                np.float32
            )
            pos = pos @ xform[:3, :3].T + xform[:3, 3]
            nrm = None
            if "NORMAL" in attrs:
                nrm = _gltf_accessor(doc, bufs, attrs["NORMAL"]).astype(
                    np.float32
                ) @ nrm_mat.T
                nrm /= np.maximum(
                    np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12
                )
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _gltf_accessor(doc, bufs, attrs["TEXCOORD_0"]).astype(
                    np.float32
                )[:, :2]
                # glTF v points down; pbrt convention points up.
                uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=1)
            if "indices" in prim:
                idx = _gltf_accessor(doc, bufs, prim["indices"])
                idx = idx.reshape(-1).astype(np.int64).reshape(-1, 3)
            else:
                idx = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)
            mat = (
                mat_names[prim["material"]]
                if "material" in prim and prim["material"] < len(mat_names)
                else (mat_names[0] if mat_names else "default")
            )
            mesh = TriangleMeshIR(
                indices=idx.astype(np.int32),
                positions=pos.astype(np.float32),
                normals=nrm, uvs=uv, material=mat,
            )
            e = emissive_of.get(mat)
            if e is not None:
                mesh.emission = e
            scene.shapes.append(mesh)

    def walk(node_idx, parent):
        node = nodes[node_idx]
        xform = parent @ _gltf_node_transform(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], xform)
        for child in node.get("children", []):
            walk(child, xform)

    for root in scene_nodes:
        walk(root, np.eye(4, dtype=np.float32))

    _default_camera(scene)
    return scene


# ----------------------------------------------------------------------------
# STL


def load_stl(path: str) -> SceneIR:
    scene = SceneIR(base_dir=os.path.dirname(os.path.abspath(path)))
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head == b"solid" and b"facet" in data[:500]:
        tris = _parse_stl_ascii(data.decode("ascii", errors="replace"))
    else:
        (n,) = np.frombuffer(data, np.uint32, 1, offset=80)
        rec = np.frombuffer(
            data, np.dtype([("n", "<3f4"), ("v", "<9f4"), ("attr", "<u2")]),
            count=n, offset=84,
        )
        tris = rec["v"].reshape(-1, 3, 3)
    verts = tris.reshape(-1, 3).astype(np.float32)
    idx = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    scene.materials["default"] = MaterialIR(
        name="default", type="matte", kd=np.array([0.7, 0.7, 0.7], np.float32)
    )
    scene.shapes.append(
        TriangleMeshIR(
            indices=idx, positions=verts, normals=None, uvs=None,
            material="default",
        )
    )
    _default_camera(scene)
    return scene


def _parse_stl_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0] == "vertex":
            verts.append([float(x) for x in parts[1:4]])
    return np.asarray(verts, np.float32).reshape(-1, 3, 3)


def _default_camera(scene: SceneIR):
    """Frame the scene bounds with a 3/4 view (what a viewer would do;
    the reference relies on pbrt camera frames instead)."""
    all_pts = [s.positions for s in scene.shapes if s.positions is not None]
    if not all_pts:
        return
    pts = np.concatenate(all_pts)
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-6
    eye = center + np.array([1.0, 0.6, 1.0]) * radius * 2.2
    forward = center - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, forward, eye
    scene.camera = CameraIR(type="perspective", fov=40.0, camera_to_world=c2w)
    # A sky light so untextured scans are visible.
    from tracerboy_tpu_torch.scene.types import InfiniteLightIR

    if not scene.lights:
        scene.lights.append(
            InfiniteLightIR(mapname="", L=np.ones(3, np.float32),
                            scale=np.ones(3, np.float32))
        )
