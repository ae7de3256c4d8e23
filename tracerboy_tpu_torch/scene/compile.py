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
distant and point lights; environment maps from .png/.hdr/.pfm/.exr),
OBJ/STL/glTF/.glb meshes (scene/mesh_import.py), the reference's binary
.pbf scenes (scene/pbf.py) and compiled .npz scenes. It keeps the JAX
package's .npz cache: a compiled scene file is saved as
<scene>.tbcache.npz beside it (or under $TB_SCENE_CACHE when its
directory is read-only or under the reference checkout) in the JAX file
format, key for key, so a cache written by either package loads in the
other; TLAS scenes are not cached.

Instanced scenes (ObjectBegin / ObjectInstance) compile as the JAX
package compiles them (compile_scene's `instancing`): flattened into the
triangle soup, or as a two-level TLAS/BLAS, one packed BVH per unique
object and a row of transforms and bounds per instance, traversed by
trace/instanced.py. A heterogeneous volume (scene.volume: a PBRT
MakeNamedMedium "heterogeneous", or Renderer(volume=)) rides along as the
JAX package carries it: the density grid and its box on the compiled
scene, and for the wave the (D*H*W, 8) trilinear stencil table vol_oct,
the delta-tracking majorant and the triangle areas of the phase/light
MIS (shade/volumetric.py).
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
# The reference TracerBoy checkout that SURVEY.md cites: scenes under it
# cache under $TB_SCENE_CACHE, never beside themselves, as in the JAX
# package's _cache_path.
REFERENCE_CHECKOUT = "/root/reference"


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
    # TLAS/BLAS instancing (trace/instanced.py): instanced objects are not
    # flattened; memory scales with the unique geometry.
    inst_tables: dict = None     # inst_obj / inst_inv / inst_lo / inst_hi
    inst_objects: list = None    # per object: packed tables, packed and
                                 # topology-order attribute rows, vertices,
                                 # object-space bounds
    inst_world_lo: np.ndarray = None
    inst_world_hi: np.ndarray = None
    # Heterogeneous volume (reference TracerBoy.cpp:1096-1184: one density
    # grid + world bounds; shaded by shade/volumetric.py in the wave).
    vol_density: np.ndarray = None   # (D, H, W) float32; None = no volume
    vol_lo: np.ndarray = None        # (3,)
    vol_hi: np.ndarray = None
    vol_sigma_a: np.ndarray = None   # (3,)
    vol_sigma_s: np.ndarray = None   # (3,)
    vol_g: float = 0.0

    @property
    def has_instances(self) -> bool:
        return self.inst_tables is not None

    @property
    def has_volume(self) -> bool:
        return self.vol_density is not None

    def volume_tables(self, pk_tri_map=None) -> dict:
        """The volume leaves of the JAX package's as_pytree, for volume
        scenes only: the (D*H*W, 8) trilinear stencil rows vol_oct (row c
        holds the 8 corner densities of the trilerp cell anchored at voxel
        c), the grid and its box, the delta-tracking majorant (max density
        times the largest channel's extinction, 10% above the true bound
        so that the null-collision branch keeps a nonzero probability),
        and the triangle areas of the phase/light MIS in scene order
        (tri_area) and in the packed order of pk_tri_map (pk_tri_area)."""
        if not self.has_volume:
            return {}
        dd = self.vol_density
        sig_t = self.vol_sigma_a + self.vol_sigma_s
        D_, H_, W_ = dd.shape
        zs = np.minimum(np.arange(D_) + 1, D_ - 1)
        ys = np.minimum(np.arange(H_) + 1, H_ - 1)
        xs = np.minimum(np.arange(W_) + 1, W_ - 1)
        oct_rows = np.stack(
            [dd, dd[:, :, xs], dd[:, ys], dd[:, ys][:, :, xs],
             dd[zs], dd[zs][:, :, xs], dd[zs][:, ys],
             dd[zs][:, ys][:, :, xs]],
            axis=-1,
        ).reshape(-1, 8).astype(np.float32)
        te1 = self.tri_v1 - self.tri_v0
        te2 = self.tri_v2 - self.tri_v0
        tri_area = np.maximum(
            0.5 * np.linalg.norm(np.cross(te1, te2), axis=1), 1e-12
        ).astype(np.float32)
        out = dict(tri_area=tri_area)
        if pk_tri_map is not None:
            pk_order = np.clip(np.asarray(pk_tri_map), 0,
                               tri_area.shape[0] - 1)
            out["pk_tri_area"] = tri_area[pk_order]
        out.update(
            vol_density=dd.reshape(-1),
            vol_oct=oct_rows,
            vol_dims=np.array(dd.shape, np.int32),
            vol_lo=self.vol_lo, vol_hi=self.vol_hi,
            vol_sigma_a=self.vol_sigma_a, vol_sigma_s=self.vol_sigma_s,
            vol_g=np.float32(self.vol_g),
            vol_majorant=np.float32(
                max(float(dd.max()) * float(sig_t.max()), 1e-8) * 1.1),
        )
        return out

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

        packed = self.packed_tables(tri_attr_rows)
        world_lo = np.minimum(
            np.minimum(self.tri_v0, self.tri_v1), self.tri_v2).min(axis=0)
        world_hi = np.maximum(
            np.maximum(self.tri_v0, self.tri_v1), self.tri_v2).max(axis=0)
        if self.has_instances:
            # The objects' packed-order attribute rows follow the flat
            # scene's: one id space for per-hit fetches (instanced_closest
            # returns ids offset by each object's base).
            base = packed["pk_attr_rows"].shape[0]
            packed["pk_attr_rows"] = np.concatenate(
                [packed["pk_attr_rows"],
                 *(o["attrs"] for o in self.inst_objects)])
            packed.update(self.inst_tables)
            objs = []
            for o in self.inst_objects:
                objs.append(dict(packed=dict(nodes=o["packed"]["nodes"],
                                             tris_bw=o["packed"]["tris_bw"]),
                                 base=np.int32(base)))
                base += o["attrs"].shape[0]
            packed["inst_objs"] = objs
            world_lo = np.minimum(world_lo, self.inst_world_lo)
            world_hi = np.maximum(world_hi, self.inst_world_hi)
        leaves = dict(
            **packed,
            **self.volume_tables(packed["pk_tri_map"]),
            tri9=tri9,
            tri_attr_t=tri_attr_t,
            tri_attr_rows=tri_attr_rows,
            env_quad=env_quad,
            env_r=env_flat[:, 0], env_g=env_flat[:, 1],
            env_b=env_flat[:, 2],
            blue0_t=self.blue_noise0.reshape(-1, 4).T.copy(),
            blue1_t=self.blue_noise1.reshape(-1, 4).T.copy(),
            world_lo=world_lo.astype(np.float32),
            world_hi=world_hi.astype(np.float32),
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

    def shadow_tri_ids(self) -> np.ndarray:
        """Scene-order ids of the triangles the shadow BVH holds: the
        non-light ones (shadow rays pass light geometry, the reference's
        IsLight skip), or triangle 0 where every triangle is a light."""
        opaque = (self.materials["flags"][self.tri_material]
                  & LIGHT_FLAG) == 0
        ids = np.flatnonzero(opaque)
        return ids if len(ids) else np.arange(1)

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
        so_idx = self.shadow_tri_ids()
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
    if isinstance(x, (list, tuple)):
        return [_canonical(v) for v in x]
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
    lights, tex_records, camera) stay nested, and so does a TLAS scene's
    inst_objs list (one dict of packed tables and base a unique object).
    A volume scene also gets vol_shape, the grid's (D, H, W) as python
    ints, so that the walk and the march read it without a device sync."""
    def convert(v):
        if isinstance(v, dict):
            return from_jax_pytree(v, device)
        if isinstance(v, (list, tuple)):
            return [convert(x) for x in v]
        a = np.array(_canonical(v), order="C", copy=True)
        return torch.from_numpy(a).to(device)

    out = {k: convert(v) for k, v in d.items()}
    if "vol_dims" in d:
        out["vol_shape"] = tuple(int(x) for x in np.asarray(d["vol_dims"]))
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
    in the shape's transform frame (world space for flattened shapes,
    object space for TLAS objects); None for a shape type the compiler
    does not know (the JAX package skips those too)."""
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


def _attr_rows_np(tri_pos, tri_nrm, tri_uv, tri_mat):
    """(T, 19) attribute rows: normals (9), uvs (6), material (1), tangent
    (3), the layout of as_numpy's tri_attr tables."""
    v0, v1, v2 = tri_pos[:, 0], tri_pos[:, 1], tri_pos[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    d1 = tri_uv[:, 1] - tri_uv[:, 0]
    d2 = tri_uv[:, 2] - tri_uv[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    bad = np.abs(det) < 1e-12
    tan = e1 * d2[:, 1:2] - e2 * d1[:, 1:2]
    tan = np.where(bad[:, None], e1, tan / np.where(bad, 1.0, det)[:, None])
    tan = tan / np.maximum(np.linalg.norm(tan, axis=1, keepdims=True), 1e-12)
    return np.concatenate(
        [tri_nrm[:, 0], tri_nrm[:, 1], tri_nrm[:, 2], tri_uv.reshape(-1, 6),
         tri_mat[:, None].astype(np.float32), tan],
        axis=1,
    ).astype(np.float32)


def _light_record(p0, p1, p2, n, color, area):
    """One area-light triangle (ltype 0)."""
    return dict(
        p0=p0, p1=p1, p2=p2, n0=n[0], n1=n[1], n2=n[2],
        color=np.asarray(color, np.float32), area=float(area), ltype=0,
        direction=np.zeros(3, np.float32),
    )


def _box_corners(lo, hi):
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


def _flat_instanced_tris(scene: ir.SceneIR) -> int:
    """Triangles the instances would add to a flattened soup (a sphere or
    curve counts 2048, the JAX package's estimate)."""
    total = 0
    for inst in scene.instances:
        obj = scene.objects.get(inst.object_name)
        if obj is None:
            continue
        for shp in obj.shapes:
            if getattr(shp, "indices", None) is not None:
                total += len(shp.indices)
            else:
                total += 2048
    return total


def compile_scene(scene: ir.SceneIR, leaf_size: int = LEAF_SIZE,
                  film_size: tuple | None = None,
                  instancing: str = "auto") -> CompiledScene:
    """Compile a SceneIR into BVH-ordered triangle tables (the JAX
    package's compile_scene).

    instancing: "flatten" composes every instance into the flat triangle
    soup; "tlas" keeps one BLAS per unique object and a per-instance
    transform table (TracerBoy.cpp:1305-1410); "auto" takes the TLAS only
    with at least 16 instances and 1M flattened instanced triangles, the
    JAX package's rule."""
    table = MaterialTable()
    tex_alloc = TextureAllocator(scene.base_dir, scene.textures)

    def material_lookup(name):
        return scene.materials.get(name)

    use_tlas = instancing == "tlas" or (
        instancing == "auto" and len(scene.instances) >= 16
        and _flat_instanced_tris(scene) >= 1_000_000)

    v_chunks, n_chunks, uv_chunks, mat_chunks = [], [], [], []
    light_records = []

    def add_light_records(tri_pos, tri_nrm, emission):
        for k in range(len(tri_pos)):
            p0, p1, p2 = tri_pos[k]
            area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0))
            light_records.append(_light_record(
                p0, p1, p2, tri_nrm[k], emission, area))

    for shape in scene.shapes if use_tlas else scene.all_shapes():
        r = _shape_to_tris(shape, scene, table, tex_alloc, material_lookup)
        if r is None:
            continue
        tri_pos, tri_nrm, tri_uv, mat_id, emission = r
        v_chunks.append(tri_pos)
        n_chunks.append(tri_nrm)
        uv_chunks.append(tri_uv)
        mat_chunks.append(np.full(len(tri_pos), mat_id, np.int32))
        if emission is not None and np.mean(emission) > 0:
            add_light_records(tri_pos, tri_nrm, emission)

    inst = (_compile_instances(scene, table, tex_alloc, material_lookup,
                               add_light_records)
            if use_tlas else {})
    if not v_chunks:
        if not inst:
            raise ValueError("scene contains no supported geometry")
        # All geometry is instanced: one degenerate flat triangle.
        v_chunks = [np.zeros((1, 3, 3), np.float32)]
        n_chunks = [np.zeros((1, 3, 3), np.float32)]
        uv_chunks = [np.zeros((1, 3, 2), np.float32)]
        mat_chunks = [np.zeros(1, np.int32)]

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
        **inst,
        **(dict(vol_density=scene.volume.density,
                vol_lo=scene.volume.lo, vol_hi=scene.volume.hi,
                vol_sigma_a=scene.volume.sigma_a,
                vol_sigma_s=scene.volume.sigma_s, vol_g=scene.volume.g)
           if getattr(scene, "volume", None) is not None else {}),
    )


def _compile_instances(scene, table, tex_alloc, material_lookup,
                       add_light_records) -> dict:
    """The TLAS/BLAS half of compile_scene (the JAX package's use_tlas
    branch): world-space light records for the instances' emissive
    shapes, one packed BLAS with packed-order attribute rows per unique
    object (objects sorted by name), and a TLAS row per instance: object
    id, the world->object 3x4 affine, the world box of the object's
    box. Returns the CompiledScene fields, or {} when no instance names
    an object with geometry."""
    import copy

    from tracerboy_tpu_torch.accel.pack import pack_scene

    for inst in scene.instances:
        obj = scene.objects.get(inst.object_name)
        if obj is None:
            continue
        for shp in obj.shapes:
            emission = getattr(shp, "emission", None)
            if emission is None or np.mean(emission) <= 0:
                continue
            s2 = copy.copy(shp)
            s2.transform = inst.transform @ shp.transform
            r = _shape_to_tris(s2, scene, table, tex_alloc, material_lookup)
            if r is not None:
                add_light_records(r[0], r[1], emission)

    names = sorted({i.object_name for i in scene.instances
                    if i.object_name in scene.objects})
    objects, obj_index = [], {}
    for n in names:
        chunks = [r for r in (
            _shape_to_tris(shp, scene, table, tex_alloc, material_lookup)
            for shp in scene.objects[n].shapes) if r is not None]
        if not chunks:
            continue
        tp = np.concatenate([c[0] for c in chunks])
        tn = np.concatenate([c[1] for c in chunks])
        tu = np.concatenate([c[2] for c in chunks])
        tm = np.concatenate([np.full(len(c[0]), c[3], np.int32)
                             for c in chunks])
        pk, _ = pack_scene(tp[:, 0], tp[:, 1], tp[:, 2])
        attrs_topo = _attr_rows_np(tp, tn, tu, tm)
        obj_index[n] = len(objects)
        objects.append(dict(
            packed=dict(nodes=pk["nodes"], tris_bw=pk["tris_bw"]),
            attrs=attrs_topo[np.clip(pk["tri_map"], 0, len(tp) - 1)],
            # Topology-order rows, vertices and the object-space box: what
            # a rebuild of the object's BLAS and a TLAS refit need.
            attrs_topo=attrs_topo,
            verts=tp,
            lo=tp.reshape(-1, 3).min(0),
            hi=tp.reshape(-1, 3).max(0),
        ))
    inst_obj, inst_inv, inst_lo, inst_hi = [], [], [], []
    for inst in scene.instances:
        if inst.object_name not in obj_index:
            continue
        oi = obj_index[inst.object_name]
        M = inst.transform
        inst_obj.append(oi)
        inst_inv.append(np.linalg.inv(M)[:3, :4].reshape(12).astype(
            np.float32))
        wc = (_box_corners(objects[oi]["lo"], objects[oi]["hi"])
              @ M[:3, :3].T + M[:3, 3])
        inst_lo.append(wc.min(0).astype(np.float32))
        inst_hi.append(wc.max(0).astype(np.float32))
    if not inst_obj:
        return {}
    return dict(
        inst_tables=dict(inst_obj=np.asarray(inst_obj, np.int32),
                         inst_inv=np.stack(inst_inv),
                         inst_lo=np.stack(inst_lo),
                         inst_hi=np.stack(inst_hi)),
        inst_objects=objects,
        inst_world_lo=np.stack(inst_lo).min(0),
        inst_world_hi=np.stack(inst_hi).max(0),
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
_VOLUME_FIELDS = ("density", "lo", "hi", "sigma_a", "sigma_s", "g")


def save_compiled(path: str, cs: CompiledScene) -> None:
    flat = {name: getattr(cs, name) for name in _ARRAY_FIELDS}
    for d, prefix in ((cs.materials, "mat."), (cs.tex_records, "tex."),
                      (cs.lights, "light.")):
        for k, v in d.items():
            flat[prefix + k] = v
    for name in _SCALAR_FIELDS:
        flat["scalar." + name] = np.asarray(getattr(cs, name))
    if cs.has_volume:
        for name in _VOLUME_FIELDS:
            flat["vol." + name] = np.asarray(getattr(cs, "vol_" + name))
    cam = cs.camera
    flat["cam.position"] = cam.position
    flat["cam.look_at"] = cam.look_at
    flat["cam.up"] = cam.up
    flat["cam.right"] = cam.right
    flat["cam.scalars"] = np.array([cam.lens_height, cam.focal_distance])
    np.savez_compressed(path, **flat)


def load_compiled(path: str) -> CompiledScene:
    with np.load(path) as z:
        vol = {"vol_" + n: z["vol." + n] for n in _VOLUME_FIELDS
               if "vol." + n in z.files}
        if "vol_g" in vol:
            vol["vol_g"] = float(vol["vol_g"])
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
        max_depth=int(scal["max_depth"]), **vol,
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
    beside it when the scene directory is writable and not under the
    reference checkout (the cache travels with the scene, like the
    reference's .pbf sidecar); otherwise a keyed file under
    $TB_SCENE_CACHE (default ~/.cache/tracerboy_tpu, the JAX package's),
    which covers read-only scene checkouts."""
    scene_dir = os.path.dirname(os.path.abspath(path))
    if os.access(scene_dir, os.W_OK) and not os.path.abspath(
            path).startswith(REFERENCE_CHECKOUT):
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
    (scene/procedural.py); a .npz path is a compiled scene; .obj, .stl,
    .gltf and .glb are meshes (scene/mesh_import.py), .pbf the reference's
    binary scene (scene/pbf.py), anything else PBRT text."""
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
    cache = _cache_path(path)
    if use_cache and os.path.exists(cache) and (
            os.path.getmtime(cache) >= os.path.getmtime(path)):
        try:
            return with_film(load_compiled(cache))
        except (OSError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile):
            pass        # unreadable cache: compile again
    if ext in (".obj", ".stl", ".gltf", ".glb"):
        from tracerboy_tpu_torch.scene.mesh_import import import_mesh_scene

        scene_ir = import_mesh_scene(path)
    elif ext == ".pbf":
        from tracerboy_tpu_torch.scene.pbf import read_pbf

        scene_ir = read_pbf(path)
    else:
        from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt

        scene_ir = parse_pbrt(path)
    cs = compile_scene(scene_ir)
    # TLAS scenes skip the cache: their per-object tables are not part of
    # the flat-array format.
    if use_cache and not cs.has_instances:
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            save_compiled(cache, cs)
        except OSError:
            pass        # unwritable cache directory: skip caching
    return with_film(cs)
