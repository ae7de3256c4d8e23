"""Scene compiler: SceneIR -> CompiledScene -> dict of torch tensors.

A jax-free numpy copy of tracerboy_tpu/scene/compile.py (the JAX package
imports jax on any import, and the machine with the card has none). It
builds the same leaves, bit for bit, as the JAX package's
CompiledScene.as_pytree(pack_pallas=True): world-space triangles in BVH
order, fused attribute rows, material / texture / light tables, blue
noise, and the packed BVH tables of the traversal kernels (a main BVH and
a shadow BVH over non-light triangles), with attribute rows in packed
order for kernel hit ids.

load_scene takes the procedural scenes, PBRT files (scene/pbrt_parser.py,
with PLY meshes, spheres, curves, image and noise textures, and infinite,
distant and point lights; environment maps from .png/.hdr/.pfm/.exr) and
compiled .npz scenes. It keeps the JAX package's .npz cache: a compiled
PBRT file is saved as <scene>.tbcache.npz beside it (or under
$TB_SCENE_CACHE when its directory is read-only) in the JAX file format,
key for key, so a cache written by either package loads in the other.
What the port does not have yet raises NotImplementedError naming its
ROADMAP.md item: instanced scenes (15), volumes (14), OBJ/STL/glTF and
.pbf files (22b).
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass, replace

import numpy as np
import torch

from tracerboy_tpu_torch.accel.native import build_bvh_native
from tracerboy_tpu_torch.scene import types as ir
from tracerboy_tpu_torch.scene.curves import tessellate_curve
from tracerboy_tpu_torch.scene.materials import (
    LIGHT_FLAG,
    MaterialTable,
    convert_material,
)
from tracerboy_tpu_torch.scene.textures import TextureAllocator
from tracerboy_tpu_torch.trace.camera import Camera

LEAF_SIZE = 4


@dataclass
class CompiledScene:
    """Host-side compiled scene; `as_tensors()` moves it to a device.

    All triangle-indexed arrays are in BVH order and padded to a multiple
    of the BVH leaf size with copies of a leaf's last triangle.
    """

    tri_v0: np.ndarray
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_n0: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_uv0: np.ndarray
    tri_uv1: np.ndarray
    tri_uv2: np.ndarray
    tri_material: np.ndarray     # (T_padded,) int32
    num_tris: int
    bvh_lo: np.ndarray
    bvh_hi: np.ndarray
    bvh_children: np.ndarray
    leaf_size: int
    materials: dict
    tex_images: np.ndarray
    tex_sizes: np.ndarray
    tex_records: dict
    lights: dict                 # SoA: p0..p2, n0..n2, color, area,
                                 # ltype, direction
    num_lights: int
    env_map: np.ndarray          # (H, W, 3) float32 (black 1x1 if none)
    env_transform: np.ndarray    # (3, 3)
    env_color_scale: np.ndarray  # (3,)
    has_env: bool
    camera: Camera
    film_width: int
    film_height: int
    sampler_spp: int
    max_depth: int
    blue_noise0: np.ndarray      # (256, 256, 4) in [0,1)
    blue_noise1: np.ndarray

    # Instancing and volumes are not ported (compile_scene raises).
    has_instances = False
    has_volume = False

    def as_numpy(self) -> dict:
        """The leaves of the JAX package's as_pytree(pack_pallas=True),
        as numpy arrays with the dtypes JAX gives them."""
        tri9 = np.concatenate(
            [self.tri_v0, self.tri_v1, self.tri_v2], axis=1
        ).astype(np.float32)
        # Per-triangle tangent from the UV parameterization (flat frame).
        e1 = self.tri_v1 - self.tri_v0
        e2 = self.tri_v2 - self.tri_v0
        d1 = self.tri_uv1 - self.tri_uv0
        d2 = self.tri_uv2 - self.tri_uv0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        bad = np.abs(det) < 1e-12
        tan = e1 * d2[:, 1:2] - e2 * d1[:, 1:2]
        tan = np.where(
            bad[:, None], e1, tan / np.where(bad, 1.0, det)[:, None]
        )
        tan = tan / np.maximum(
            np.linalg.norm(tan, axis=1, keepdims=True), 1e-12
        )
        tri_attr_t = np.concatenate(
            [
                self.tri_n0.T, self.tri_n1.T, self.tri_n2.T,   # 0:9
                self.tri_uv0.T, self.tri_uv1.T, self.tri_uv2.T,  # 9:15
                self.tri_material[None, :].astype(np.float32),   # 15
                tan.T,                                           # 16:19
            ],
            axis=0,
        ).astype(np.float32)
        tri_attr_rows = np.ascontiguousarray(tri_attr_t.T)   # (T, 19)

        env_flat = self.env_map.reshape(-1, 3).astype(np.float32)
        # Bilinear quad rows: row i = the 2x2 texel neighbourhood of
        # texel i (x+1 wrapped, y+1 clamped), 12 floats.
        eh, ew = self.env_map.shape[0], self.env_map.shape[1]
        x1 = (np.arange(ew) + 1) % ew
        y1 = np.minimum(np.arange(eh) + 1, eh - 1)
        em = self.env_map.astype(np.float32)
        env_quad = np.concatenate(
            [em, em[:, x1], em[y1], em[y1][:, x1]], axis=2
        ).reshape(-1, 12)

        leaves = dict(
            **self.packed_tables(tri_attr_rows),
            tri9=tri9,
            tri_attr_t=tri_attr_t,
            tri_attr_rows=tri_attr_rows,
            env_quad=env_quad,
            env_r=env_flat[:, 0], env_g=env_flat[:, 1],
            env_b=env_flat[:, 2],
            blue0_t=self.blue_noise0.reshape(-1, 4).T.copy(),
            blue1_t=self.blue_noise1.reshape(-1, 4).T.copy(),
            world_lo=np.minimum(
                np.minimum(self.tri_v0, self.tri_v1), self.tri_v2
            ).min(axis=0).astype(np.float32),
            world_hi=np.maximum(
                np.maximum(self.tri_v0, self.tri_v1), self.tri_v2
            ).max(axis=0).astype(np.float32),
            tri_v0=self.tri_v0, tri_v1=self.tri_v1, tri_v2=self.tri_v2,
            tri_n0=self.tri_n0, tri_n1=self.tri_n1, tri_n2=self.tri_n2,
            tri_uv0=self.tri_uv0, tri_uv1=self.tri_uv1,
            tri_uv2=self.tri_uv2,
            tri_material=self.tri_material,
            # Shadow rays ignore emissive (light) geometry (the
            # reference's IsLight pass-through in shadow feelers).
            tri_shadow_opaque=(
                (self.materials["flags"][self.tri_material] & LIGHT_FLAG)
                == 0
            ),
            bvh_lo=self.bvh_lo, bvh_hi=self.bvh_hi,
            bvh_children=self.bvh_children,
            materials=dict(self.materials),
            tex_images=self.tex_images, tex_sizes=self.tex_sizes,
            tex_records=dict(self.tex_records),
            lights=dict(self.lights),
            env_map=self.env_map, env_transform=self.env_transform,
            env_color_scale=self.env_color_scale,
            blue_noise0=self.blue_noise0, blue_noise1=self.blue_noise1,
            camera=self.camera.as_numpy(),
        )
        return _canonical(leaves)

    def as_tensors(self, device="cuda") -> dict:
        """The scene leaves as torch tensors on `device`."""
        return from_jax_pytree(self.as_numpy(), device)

    def packed_tables(self, tri_attr_rows) -> dict:
        """Packed tables of the traversal kernels: a leaf-8 BVH over the
        scene triangles and a second one over non-light triangles for
        shadow rays, plus attribute rows in PACKED triangle order, so
        per-hit fetches need no packed->scene remap.

        The opt-in backends' tables, as the JAX package gates them (read
        from the environment here, at compile time):
        - TB_CUT=1 and more than 2048 triangles: the cut tables of both
          BVHs (pk_cut_top / pk_cut_roots, pk_sh_cut_top /
          pk_sh_cut_roots; trace/cut.py), subtrees of at most TB_CUT_TRIS
          triangles (512, or 2048 above 300k triangles);
        - TB_BINNED=1: the binned tables bn_nodes / bn_mot / bn_base
          (trace/binned.py), from the main BVH's 9-float rows."""
        from tracerboy_tpu_torch.accel.pack import pack_scene

        binned = os.environ.get("TB_BINNED") == "1"
        pk, bvh = pack_scene(self.tri_v0, self.tri_v1, self.tri_v2,
                             raw_rows=binned)
        opaque = (self.materials["flags"][self.tri_material]
                  & LIGHT_FLAG) == 0
        so_idx = np.where(opaque)[0]
        if len(so_idx) == 0:
            so_idx = np.arange(1)
        pk_sh, bvh_sh = pack_scene(
            self.tri_v0[so_idx], self.tri_v1[so_idx], self.tri_v2[so_idx]
        )
        T = tri_attr_rows.shape[0]
        order = np.clip(pk["tri_map"], 0, T - 1)
        sh_order = np.clip(so_idx[pk_sh["tri_map"]], 0, T - 1)
        out = dict(
            pk_nodes=pk["nodes"],
            pk_tris_bw=pk["tris_bw"],
            pk_tri_map=pk["tri_map"],
            pk_sh_nodes=pk_sh["nodes"],
            pk_sh_tris_bw=pk_sh["tris_bw"],
            pk_sh_tri_map=so_idx.astype(np.int32)[pk_sh["tri_map"]],
            pk_attr_rows=tri_attr_rows[order],
            pk_sh_attr_rows=tri_attr_rows[sh_order],
        )
        T_tris = self.tri_v0.shape[0]
        if T_tris > 2048 and os.environ.get("TB_CUT") == "1":
            from tracerboy_tpu_torch.trace.cut import build_cut

            cut_tris = int(os.environ.get(
                "TB_CUT_TRIS", 512 if T_tris <= 300_000 else 2048))
            for prefix, p, b in (("pk_", pk, bvh), ("pk_sh_", pk_sh, bvh_sh)):
                cut = build_cut(p["nodes"], b.children, b.leaf_size,
                                cut_tris)
                out[prefix + "cut_top"] = cut["top_nodes"]
                out[prefix + "cut_roots"] = cut["roots"]
        if binned:
            from tracerboy_tpu_torch.trace.binned import pack_scene_binned

            out.update(pack_scene_binned(pk["tris"]))
        return out


def _canonical(x):
    """numpy leaves with JAX's default dtypes (no 64-bit types)."""
    if isinstance(x, dict):
        return {k: _canonical(v) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.uint64:
        a = a.astype(np.uint32)
    return a


def from_jax_pytree(d: dict, device="cuda") -> dict:
    """Scene tensors from a dict of numpy arrays: either as_numpy() of the
    port's CompiledScene, or np.asarray of every leaf of the JAX package's
    CompiledScene.as_pytree(pack_pallas=True). Nested dicts (materials,
    lights, tex_records, camera) stay nested."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = from_jax_pytree(v, device)
        elif isinstance(v, (list, tuple)):
            raise NotImplementedError(
                f"scene leaf {k!r}: instanced scenes are not ported yet "
                "(ROADMAP.md, Queue 1: item 15, trace/instanced.py)")
        else:
            a = np.array(_canonical(v), order="C", copy=True)
            out[k] = torch.from_numpy(a).to(device)
    return out


def _transform_mesh(mesh: ir.TriangleMeshIR):
    """Bake the mesh transform: world-space verts, inverse-transpose
    normals."""
    M = mesh.transform
    pos = mesh.positions @ M[:3, :3].T + M[:3, 3]
    if mesh.normals is not None and len(mesh.normals) == len(mesh.positions):
        it = np.linalg.inv(M[:3, :3]).T
        nrm = mesh.normals @ it.T
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-12)
    else:
        nrm = None
    return pos.astype(np.float32), nrm


def _sphere_mesh(radius: float, lat: int = 16, lon: int = 32):
    """UV-sphere tessellation for pbrt `sphere` shapes."""
    th = np.linspace(0, np.pi, lat + 1)
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], axis=-1
    ).reshape(-1, 3)
    idx = []
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            if i > 0:
                idx.append((a, b, c))
            if i < lat - 1:
                idx.append((b, d, c))
    pts = pts.astype(np.float32)
    return pts * radius, np.asarray(idx, np.int32), pts.copy()


def _place(pos, nrm0, M):
    """Object-space points and normals of a sphere or curve mesh into
    the shape's frame."""
    pos = (pos @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    it = np.linalg.inv(M[:3, :3]).T
    nrm = nrm0 @ it.T
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return pos, nrm.astype(np.float32)


def _shape_to_tris(shape, scene, table, tex_alloc, material_lookup):
    """One shape -> (tri_pos (t,3,3), tri_nrm, tri_uv, mat_id, emission)
    in world space; None for a shape type the compiler does not know (the
    JAX package skips those too)."""
    emission = getattr(shape, "emission", None)
    mat_ir = scene.materials.get(shape.material)
    alpha_tex = getattr(shape, "alpha_texture", None)
    mat_id = convert_material(
        mat_ir, emission if emission is not None else (0, 0, 0),
        table, tex_alloc, material_lookup, alpha_texture=alpha_tex,
    )
    uv = None
    if isinstance(shape, ir.TriangleMeshIR):
        pos, nrm = _transform_mesh(shape)
        idx, uv = shape.indices, shape.uvs
    elif isinstance(shape, ir.SphereIR):
        pos, idx, nrm0 = _sphere_mesh(shape.radius)
        pos, nrm = _place(pos, nrm0, shape.transform)
    elif isinstance(shape, ir.CurveIR):
        pos, idx, nrm0 = tessellate_curve(
            shape.control_points, shape.width0, shape.width1)
        pos, nrm = _place(pos, nrm0, shape.transform)
    else:
        return None
    tri_pos = pos[idx]
    if nrm is not None and len(nrm) == len(pos):
        tri_nrm = nrm[idx]
    else:
        e1 = tri_pos[:, 1] - tri_pos[:, 0]
        e2 = tri_pos[:, 2] - tri_pos[:, 0]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        tri_nrm = np.repeat(fn[:, None, :], 3, axis=1)
    if shape.reverse_orientation:
        tri_nrm = -tri_nrm
    if uv is not None:
        tri_uv = uv[idx]
    else:
        tri_uv = np.zeros((len(idx), 3, 2), np.float32)
    return (tri_pos.astype(np.float32), tri_nrm.astype(np.float32),
            tri_uv.astype(np.float32), mat_id, emission)


def _light_record(p0, p1, p2, n, color, area):
    """One area-light triangle (ltype 0)."""
    return dict(
        p0=p0, p1=p1, p2=p2, n0=n[0], n1=n[1], n2=n[2],
        color=np.asarray(color, np.float32), area=float(area), ltype=0,
        direction=np.zeros(3, np.float32),
    )


def compile_scene(scene: ir.SceneIR, leaf_size: int = LEAF_SIZE,
                  film_size: tuple | None = None) -> CompiledScene:
    """Flatten a SceneIR into BVH-ordered triangle tables (the JAX
    package's compile_scene with instancing "flatten")."""
    if scene.instances:
        raise NotImplementedError(
            "instanced scenes are not ported yet (ROADMAP.md, Queue 1: "
            "item 15, trace/instanced.py)")
    if getattr(scene, "volume", None) is not None:
        raise NotImplementedError(
            "volumes are not ported yet (ROADMAP.md, Queue 1: item 14, "
            "shade/volumetric.py)")
    table = MaterialTable()
    tex_alloc = TextureAllocator(scene.base_dir, scene.textures)

    def material_lookup(name):
        return scene.materials.get(name)

    v_chunks, n_chunks, uv_chunks, mat_chunks = [], [], [], []
    light_records = []
    for shape in scene.shapes:
        r = _shape_to_tris(shape, scene, table, tex_alloc, material_lookup)
        if r is None:
            continue
        tri_pos, tri_nrm, tri_uv, mat_id, emission = r
        v_chunks.append(tri_pos)
        n_chunks.append(tri_nrm)
        uv_chunks.append(tri_uv)
        mat_chunks.append(np.full(len(tri_pos), mat_id, np.int32))
        if emission is not None and np.mean(emission) > 0:
            for k in range(len(tri_pos)):
                p0, p1, p2 = tri_pos[k]
                area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0))
                light_records.append(_light_record(
                    p0, p1, p2, tri_nrm[k], emission, area))
    if not v_chunks:
        raise ValueError("scene contains no supported geometry")

    tri_pos = np.concatenate(v_chunks)     # (T, 3, 3)
    tri_nrm = np.concatenate(n_chunks)
    tri_uv = np.concatenate(uv_chunks)
    tri_mat = np.concatenate(mat_chunks)
    T = tri_pos.shape[0]

    bvh = build_bvh_native(
        tri_pos[:, 0], tri_pos[:, 1], tri_pos[:, 2], leaf_size=leaf_size
    )
    order = bvh.tri_order
    tri_pos = tri_pos[order]
    tri_nrm = tri_nrm[order]
    tri_uv = tri_uv[order]
    tri_mat = tri_mat[order]

    env = _non_area_lights(scene, light_records)

    L = max(len(light_records), 1)
    lights = dict(
        p0=np.zeros((L, 3), np.float32), p1=np.zeros((L, 3), np.float32),
        p2=np.zeros((L, 3), np.float32), n0=np.zeros((L, 3), np.float32),
        n1=np.zeros((L, 3), np.float32), n2=np.zeros((L, 3), np.float32),
        color=np.zeros((L, 3), np.float32), area=np.zeros(L, np.float32),
        ltype=np.zeros(L, np.int32), direction=np.zeros((L, 3), np.float32),
    )
    for i, r in enumerate(light_records):
        for k in ("p0", "p1", "p2", "n0", "n1", "n2", "color", "direction"):
            lights[k][i] = r[k]
        lights["area"][i] = r["area"]
        lights["ltype"][i] = r["ltype"]

    tex_images, tex_sizes, tex_records = tex_alloc.to_arrays()
    blue0, blue1 = _load_blue_noise()

    width = scene.film.xresolution
    height = scene.film.yresolution
    if film_size is not None:
        width, height = film_size
    return CompiledScene(
        tri_v0=tri_pos[:, 0], tri_v1=tri_pos[:, 1], tri_v2=tri_pos[:, 2],
        tri_n0=tri_nrm[:, 0], tri_n1=tri_nrm[:, 1], tri_n2=tri_nrm[:, 2],
        tri_uv0=tri_uv[:, 0], tri_uv1=tri_uv[:, 1], tri_uv2=tri_uv[:, 2],
        tri_material=tri_mat, num_tris=T,
        bvh_lo=bvh.bounds_lo, bvh_hi=bvh.bounds_hi,
        bvh_children=bvh.children, leaf_size=leaf_size,
        materials=table.to_soa(),
        tex_images=tex_images, tex_sizes=tex_sizes, tex_records=tex_records,
        lights=lights, num_lights=len(light_records),
        # Without an infinite light: black; procedural scenes set theirs
        # afterwards.
        **env,
        camera=Camera.from_pbrt(scene.camera, width, height),
        film_width=width, film_height=height,
        sampler_spp=scene.sampler.pixel_samples,
        max_depth=scene.integrator.max_depth,
        blue_noise0=blue0, blue_noise1=blue1,
    )


def _non_area_lights(scene: ir.SceneIR, light_records: list) -> dict:
    """The scene's infinite, distant and point lights, as the JAX
    compiler converts them: the infinite light becomes the environment
    (its map, L * scale and the world->env rotation) and is returned as
    CompiledScene fields; a distant light appends an ltype 1 record and a
    point light a small two-triangle emissive quad to light_records."""
    env = dict(env_map=np.zeros((1, 1, 3), np.float32),
               env_transform=np.eye(3, dtype=np.float32),
               env_color_scale=np.ones(3, np.float32), has_env=False)
    for light in scene.lights:
        if isinstance(light, ir.InfiniteLightIR):
            env_map = np.ones((1, 1, 3), np.float32)
            if light.mapname:
                path = os.path.join(scene.base_dir, light.mapname)
                if os.path.exists(path):
                    from tracerboy_tpu_torch.core import image_io

                    env_map = image_io.read_texture(path).astype(np.float32)
                else:
                    import warnings

                    warnings.warn(f"env map not found: {path}")
            scale = light.scale if light.scale is not None else np.ones(3)
            L = light.L if light.L is not None else np.ones(3)
            env = dict(
                env_map=env_map,
                env_color_scale=(np.asarray(scale) * np.asarray(L)).astype(
                    np.float32),
                # World->env rotation; the shader rotates the lookup
                # direction (RayGenCommon.h:21-27).
                env_transform=np.linalg.inv(
                    light.transform[:3, :3]).astype(np.float32),
                has_env=True,
            )
        elif isinstance(light, ir.DistantLightIR):
            d = light.transform[:3, :3] @ np.asarray(light.direction,
                                                     np.float64)
            d = d / np.linalg.norm(d)
            n = -d.astype(np.float32)
            light_records.append(dict(
                p0=np.zeros(3, np.float32), p1=np.zeros(3, np.float32),
                p2=np.zeros(3, np.float32), n0=n, n1=n, n2=n,
                color=np.asarray(light.L, np.float32), area=1.0, ltype=1,
                direction=d.astype(np.float32),
            ))
        elif isinstance(light, ir.PointLightIR):
            # A tiny emissive quad stands in for the point
            # (AssimpImporter.cpp:141-171).
            c = (light.transform[:3, :3] @ light.from_point
                 + light.transform[:3, 3])
            eps = 0.02
            quad = np.array([c + [-eps, -eps, 0], c + [eps, -eps, 0],
                             c + [eps, eps, 0], c + [-eps, eps, 0]],
                            np.float32)
            n = np.array([0, 0, -1], np.float32)
            intensity = np.asarray(light.I, np.float32) / (eps * eps * 2)
            for a, b, cc in ((0, 1, 2), (0, 2, 3)):
                area = 0.5 * np.linalg.norm(
                    np.cross(quad[b] - quad[a], quad[cc] - quad[a]))
                light_records.append(_light_record(
                    quad[a], quad[b], quad[cc], (n, n, n), intensity, area))
    return env


def _load_blue_noise():
    """The two 256x256 RGBA noise textures (SURVEY G5). The reference's
    blue-noise images are not in the repository, so this is the hashed
    white noise the JAX package falls back to without them."""
    rng = np.random.default_rng(0xB1E)
    return (
        rng.random((256, 256, 4)).astype(np.float32),
        rng.random((256, 256, 4)).astype(np.float32),
    )


# ----------------------------------------------------------------------------
# .npz scene cache (the .pbf analog, TracerBoy.cpp:1200-1223), in the JAX
# package's format

_SCALAR_FIELDS = (
    "num_tris", "leaf_size", "num_lights", "has_env", "film_width",
    "film_height", "sampler_spp", "max_depth",
)
_ARRAY_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_material", "bvh_lo", "bvh_hi",
    "bvh_children", "tex_images", "tex_sizes", "env_map",
    "env_transform", "env_color_scale", "blue_noise0", "blue_noise1",
)


def save_compiled(path: str, cs: CompiledScene) -> None:
    flat = {name: getattr(cs, name) for name in _ARRAY_FIELDS}
    for d, prefix in ((cs.materials, "mat."), (cs.tex_records, "tex."),
                      (cs.lights, "light.")):
        for k, v in d.items():
            flat[prefix + k] = v
    for name in _SCALAR_FIELDS:
        flat["scalar." + name] = np.asarray(getattr(cs, name))
    cam = cs.camera
    flat["cam.position"] = cam.position
    flat["cam.look_at"] = cam.look_at
    flat["cam.up"] = cam.up
    flat["cam.right"] = cam.right
    flat["cam.scalars"] = np.array([cam.lens_height, cam.focal_distance])
    np.savez_compressed(path, **flat)


def load_compiled(path: str) -> CompiledScene:
    with np.load(path) as z:
        if any(k.startswith("vol.") for k in z.files):
            raise NotImplementedError(
                f"{path}: a cached scene with a volume; volumes are not "
                "ported yet (ROADMAP.md, Queue 1: item 14, "
                "shade/volumetric.py)")
        mats = {k[4:]: z[k] for k in z.files if k.startswith("mat.")}
        texr = {k[4:]: z[k] for k in z.files if k.startswith("tex.")}
        lights = {k[6:]: z[k] for k in z.files if k.startswith("light.")}
        scal = {n: z["scalar." + n][()] for n in _SCALAR_FIELDS}
        arrays = {name: z[name] for name in _ARRAY_FIELDS}
        cam = Camera(
            position=z["cam.position"], look_at=z["cam.look_at"],
            up=z["cam.up"], right=z["cam.right"],
            lens_height=float(z["cam.scalars"][0]),
            focal_distance=float(z["cam.scalars"][1]),
        )
    return CompiledScene(
        **arrays, num_tris=int(scal["num_tris"]),
        leaf_size=int(scal["leaf_size"]), materials=mats,
        tex_records=texr, lights=lights, num_lights=int(scal["num_lights"]),
        has_env=bool(scal["has_env"]), camera=cam,
        film_width=int(scal["film_width"]),
        film_height=int(scal["film_height"]),
        sampler_spp=int(scal["sampler_spp"]),
        max_depth=int(scal["max_depth"]),
    )


def load_scene_async(path: str, use_cache: bool = True, film_size=None,
                     on_progress=None):
    """Load a scene on a worker thread (the reference's async scene-load
    thread, D3D12App.cpp:53-68). Returns a Future; poll .done() for the
    loading screen, .result() for the CompiledScene."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def run():
        if on_progress:
            on_progress("parsing")
        cs = load_scene(path, use_cache=use_cache, film_size=film_size)
        if on_progress:
            on_progress("done")
        return cs

    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def _cache_path(path: str) -> str:
    """Where the compiled .npz for `path` lives: `<scene>.tbcache.npz`
    beside it when the scene directory is writable (the cache travels
    with the scene, like the reference's .pbf sidecar); otherwise a keyed
    file under $TB_SCENE_CACHE (default ~/.cache/tracerboy_tpu, the JAX
    package's), which covers read-only scene checkouts."""
    scene_dir = os.path.dirname(os.path.abspath(path))
    if os.access(scene_dir, os.W_OK):
        return path + ".tbcache.npz"
    import hashlib

    cache_dir = os.environ.get(
        "TB_SCENE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "tracerboy_tpu"))
    key = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"{os.path.basename(path)}.{key}.npz")


def load_scene(path: str, use_cache: bool = True,
               film_size=None) -> CompiledScene:
    """Parse + compile a scene file, with transparent .npz caching.

    The cache stores the scene at its NATIVE film resolution; a film_size
    override only replaces the film dims on the returned CompiledScene
    (the camera does not depend on it), so one cached compile serves
    every render resolution. A cache older than its scene file is
    compiled again; an unreadable one is ignored.

    "shadertoy" / "shadertoy:<name>" selects a built-in procedural scene
    (scene/procedural.py); a .npz path is a compiled scene."""
    if path == "shadertoy" or path.startswith("shadertoy:"):
        from tracerboy_tpu_torch.scene.procedural import shadertoy_scene

        name = path.split(":", 1)[1] if ":" in path else "benchmark"
        return shadertoy_scene(name, film_size=film_size)

    def with_film(cs):
        if film_size is not None:
            cs = replace(cs, film_width=film_size[0],
                         film_height=film_size[1])
        return cs

    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        return with_film(load_compiled(path))
    if ext in (".obj", ".stl", ".gltf", ".glb", ".pbf"):
        raise NotImplementedError(
            f"{path}: OBJ/STL/glTF and .pbf scene files are not ported yet "
            "(ROADMAP.md, Queue 1: item 22b, the other scene and image "
            "files)")
    cache = _cache_path(path)
    if use_cache and os.path.exists(cache) and (
            os.path.getmtime(cache) >= os.path.getmtime(path)):
        try:
            return with_film(load_compiled(cache))
        except (OSError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile):
            pass        # unreadable cache: compile again
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt

    cs = compile_scene(parse_pbrt(path))
    if use_cache:
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            save_compiled(cache, cs)
        except OSError:
            pass        # unwritable cache directory: skip caching
    return with_film(cs)
