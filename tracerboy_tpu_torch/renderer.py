"""Renderer: the progressive rendering driver (tracerboy_tpu/renderer.py).

Owns the scene tensors and the accumulation state, and steps the
wavefront integrator. Progressive semantics match the JAX package:

- the colour accumulator stores (sum of radiance * filter weight, sum of
  filter weight); display divides rgb by alpha;
- a secondary "jittered" accumulator receives each sample (or batch)
  with probability 1/2, for the convergence estimate;
- world-position AOVs ping-pong between even and odd samples;
- the last wave's first-hit AOVs feed the debug views of
  current_image(), pixel inspection and the aux-guided denoiser.

RealTime mode (RenderMode.REAL_TIME) traces one demodulated sample per
frame with a fixed per-frame Halton jitter and runs the post chain of
post/realtime.py on it: render_realtime_frame, and
render_realtime_frame_fused, which adds the adaptive mask and the
frame-rate governor. The JAX package compiles the latter into one program
per frame; here both run the same eager code. trace_decoupled and
render_denoised are the batch form of the same design: k demodulated
samples, the OIDN UNet on the lighting, then the albedo composite.

The traversal backend is brute force up to 2048 triangles and the CUDA
kernels above; TB_TRAVERSAL=brute|pallas|jnp overrides it under the JAX
package's names (pallas = the kernels, jnp = the wide traversal in plain
torch, the portable oracle).

Unbiased mode takes the JAX package's estimators: the tent splat
(CameraSettings.filter_splat: merged full-film waves on every backend),
adaptive sampling (PerformanceSettings.enable_adaptive_sampling: after
ADAPTIVE_MIN_SPP samples a per-pixel convergence mask), and the adaptive
burst render_sample_adaptive, which spends a fixed sample budget by the
pilot's per-pixel variance in one residual wave whose lanes repeat
pixels. A heterogeneous volume (Renderer(volume=), or the scene's own)
is delta-tracked by the wave; set_material edits one material live.

Animated geometry: update_geometry moves the flat scene's triangles and
rebuilds both packed BVHs on the render device (accel/bvh_device.py, the
reference's per-change GPU LBVH rebuild); TLAS-instanced scenes animate
through update_instance_transforms and update_object_geometry (one
object's BLAS rebuilt on the device).

Multi-device scaling (Renderer(shard=), parallel/sharding.py): "tiles"
splits the pixel pool over a mesh of devices, "spp" gives every mesh
entry its own sample indices and sums the accumulators in mesh order.
Each entry after the first renders on its own replica of the scene
tensors; every method that edits the scene bumps a version, and the
sharded paths refresh stale replicas before they trace.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from tracerboy_tpu_torch.core import rng as tbrng
from tracerboy_tpu_torch.core.tonemap import _luma
from tracerboy_tpu_torch.post.pipeline import (
    display_transform,
    post_process,
    resolve_accumulator,
)
from tracerboy_tpu_torch.scene.compile import (
    CompiledScene,
    _box_corners,
    _canonical,
    from_jax_pytree,
    load_scene,
)
from tracerboy_tpu_torch.scene.materials import LIGHT_FLAG
from tracerboy_tpu_torch.trace.wavefront import (
    PACKED_BACKENDS,
    WaveConfig,
    make_blue_noise_params,
    render_wave,
    render_wave_batch,
    render_wave_merged,
)
from tracerboy_tpu_torch.utils.config import (
    OutputSettings,
    OutputType,
    RenderMode,
    default_output_settings,
    invalidates_history,
)

BRUTE_FORCE_MAX_TRIS = 2048
MERGED_WAVE_LANES = 8_388_608   # lane cap of one merged wave
MERGED_WAVE_MAX_K = 48          # samples per merged wave
TRAVERSAL_NAMES = {"brute": "brute", "pallas": "kernel", "jnp": "wide"}
RT_HISTORY_WEIGHT = 0.95


def _demod_ratio(rad_d, rad):
    """Per-channel albedo-modulation ratio D / I for composite_albedo.
    A pixel without indirect light (I == 0) composites to E whatever the
    ratio; 1 keeps the convention of the miss pixels (albedo 0 there)."""
    return torch.clamp(
        torch.where(rad > 1e-12, rad_d / torch.clamp_min(rad, 1e-12), 1.0),
        0.0, 1.0)


def flat_attr_rows(v0, v1, v2, uv0, uv1, uv2, material, normals=None):
    """(T, 19) attribute rows of moved triangles, the layout of
    CompiledScene.as_numpy: the flat normal three times (normals, or the
    normalised cross(e1, e2)), the three UVs, the material id and the UV
    tangent (the compile-time formula)."""
    e1 = v1 - v0
    e2 = v2 - v0
    if normals is None:
        n = torch.linalg.cross(e1, e2)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=1, keepdim=True),
                            min=1e-12)
    else:
        n = torch.as_tensor(normals, dtype=torch.float32).to(v0.device)
    d1 = uv1 - uv0
    d2 = uv2 - uv0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    bad = torch.abs(det) < 1e-12
    tan = e1 * d2[:, 1:2] - e2 * d1[:, 1:2]
    tan = torch.where(bad[:, None], e1,
                      tan / torch.where(bad, 1.0, det)[:, None])
    tan = tan / torch.clamp(torch.linalg.vector_norm(tan, dim=1,
                                                     keepdim=True), min=1e-12)
    return torch.cat([n, n, n, uv0, uv1, uv2,
                      material[:, None].to(torch.float32), tan], 1)


@dataclass
class RenderState:
    """Persistent accumulation state (tensors on the render device)."""

    accum: torch.Tensor            # (H, W, 4): rgb * weight, weight
    accum_jittered: torch.Tensor   # (H, W, 4)
    world_pos: list                # two (H, W, 4) ping-pong buffers
    spp: int = 0


class Renderer:
    def __init__(self, scene, settings: OutputSettings | None = None,
                 film_size: tuple | None = None, seed: int = 0,
                 volume=None, device="cuda", shard: str | None = None,
                 mesh=None, n_devices: int | None = None):
        """scene: a CompiledScene or a name for load_scene ("shadertoy",
        "shadertoy:cornell", the path of a .pbrt file, compiled through
        its .tbcache.npz cache, or of a compiled .npz scene). volume: a
        VolumeIR (scene/volume.py: load_volume, procedural_cloud) that
        attaches or replaces the scene's heterogeneous medium.

        shard: the multi-device axis of render_sample, as in the JAX
        package: None (one device), "tiles" (the pixel pool split over the
        mesh) or "spp" (every mesh entry traces the full image at its own
        sample indices; the accumulators are summed in mesh order). mesh:
        a parallel.sharding.Mesh; by default make_mesh(n_devices) of the
        `device` argument's type (the first n_devices cards, or all; on
        the CPU n_devices entries of it, 1 by default). With shard, the
        renderer's device is the mesh's first."""
        if isinstance(scene, str):
            scene = load_scene(scene, film_size=film_size)
        if not isinstance(scene, CompiledScene):
            raise TypeError(f"scene must be a CompiledScene or a name, got "
                            f"{type(scene).__name__}")
        if volume is not None:
            scene = replace(
                scene, vol_density=volume.density, vol_lo=volume.lo,
                vol_hi=volume.hi, vol_sigma_a=volume.sigma_a,
                vol_sigma_s=volume.sigma_s, vol_g=volume.g)
        self.compiled = scene
        if shard not in (None, "tiles", "spp"):
            raise ValueError(f"shard must be None|'tiles'|'spp': {shard}")
        self.shard = shard
        self.mesh = mesh
        if shard is not None and mesh is None:
            from tracerboy_tpu_torch.parallel.sharding import make_mesh

            self.mesh = make_mesh(n_devices,
                                  device_type=torch.device(device).type)
        if shard is not None:
            device = self.mesh.devices[0]
        self.device = torch.device(device)
        self.seed = int(seed)
        self.settings = settings or default_output_settings()
        self.width = scene.film_width
        self.height = scene.film_height
        if film_size is not None:
            self.width, self.height = film_size
        self.traversal = self._pick_traversal(scene)
        self.scene = scene.as_tensors(self.device)
        self.pixel_ids = torch.arange(self.width * self.height,
                                      dtype=torch.int64, device=self.device)
        self._bn_cache = None
        # Sharding: the scene's version (bumped by every method that edits
        # self.scene), the mesh entries' replicas with the version they
        # copy, the tiled pool and its blue-noise pre-gather.
        self._scene_version = 0
        self._replicas = None
        self._tiled_pixels = None
        self._bn_cache_tiled = None
        self._shadow_idx = None  # the shadow BVH triangles of update_geometry
        self.rays_traced = 0     # closest-hit + shadow rays, all calls
        self._last_aovs = None   # the last accumulated wave's output
        # RealTime mode: the temporal history of each entry point, the
        # previous frame's camera, the adaptive mask and its count.
        self._rt_history = {}
        self._rt_hist_fused = None
        self._cam_prev = None
        self._live_pixels = None
        self._rt_live_pixels = None
        self._governor = None
        self._rt_last_time = None
        # With time_realtime_stages, each RealTime frame records CUDA
        # events (start, traced, done) into rt_stage_events.
        self.time_realtime_stages = False
        self.rt_stage_events = None
        self.state = self.make_state()
        self._start_time = time.time()

    @staticmethod
    def _pick_traversal(scene: CompiledScene) -> str:
        """Brute force for tiny scenes (no traversal beats testing every
        triangle there), the traversal kernels otherwise and on every TLAS
        scene; TB_TRAVERSAL = brute | pallas | jnp overrides it."""
        forced = os.environ.get("TB_TRAVERSAL")
        if forced in TRAVERSAL_NAMES:
            return TRAVERSAL_NAMES[forced]
        if scene.has_instances:
            return "kernel"     # the TLAS/BLAS path walks packed BVHs
        if scene.tri_v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
            return "brute"
        return "kernel"

    def make_state(self) -> RenderState:
        def zeros():
            return torch.zeros((self.height, self.width, 4),
                               dtype=torch.float32, device=self.device)

        return RenderState(accum=zeros(), accum_jittered=zeros(),
                           world_pos=[zeros(), zeros()], spp=0)

    def invalidate_history(self):
        """Restart accumulation (TracerBoy::InvalidateHistory)."""
        self.state = self.make_state()
        self._start_time = time.time()

    def update_settings(self, new_settings: OutputSettings):
        if invalidates_history(self.settings, new_settings):
            self.invalidate_history()
        self.settings = new_settings

    def move_camera(self, forward=0.0, strafe=0.0, upward=0.0, yaw=0.0,
                    pitch=0.0):
        """Move and turn the camera (TracerBoy::Update), then restart
        accumulation. RealTime's temporal history stays and is reprojected
        through the previous camera."""
        cam = self.compiled.camera
        view = cam.look_at - cam.position
        view = view / np.linalg.norm(view)
        right = cam.right / np.linalg.norm(cam.right)
        up = cam.up / np.linalg.norm(cam.up)
        delta = forward * view + strafe * right + upward * up
        cam.position = (cam.position + delta).astype(np.float32)
        if yaw != 0.0 or pitch != 0.0:
            def rot(axis, ang):
                axis = axis / np.linalg.norm(axis)
                K = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                return (np.eye(3) + np.sin(ang) * K
                        + (1 - np.cos(ang)) * (K @ K))
            R = rot(up, yaw) @ rot(right, pitch)
            view = R @ view
            right = rot(up, yaw) @ right
            up = np.cross(right, view)
            cam.right = right.astype(np.float32)
            cam.up = (up / np.linalg.norm(up)).astype(np.float32)
        cam.look_at = (cam.position + view).astype(np.float32)
        self.scene["camera"] = from_jax_pytree(cam.as_numpy(), self.device)
        self._scene_version += 1
        self.invalidate_history()

    def wave_config(self) -> WaveConfig:
        s = self.settings
        perf = s.performance_settings
        mats = self.compiled.materials
        ttype = self.compiled.tex_records["ttype"]
        realtime = s.render_mode == RenderMode.REAL_TIME
        return WaveConfig(
            width=self.width,
            height=self.height,
            max_bounces=min(perf.max_bounces, 32),
            num_lights=self.compiled.num_lights,
            enable_nee=perf.enable_next_event_estimation,
            enable_ris=perf.enable_sampling_importance_resampling,
            filter_type=int(s.camera_settings.filter_type),
            filter_width=s.camera_settings.filter_width,
            filter_splat=bool(s.camera_settings.filter_splat
                              and not realtime),
            use_blue_noise=perf.use_blue_noise,
            sampler=perf.sampler,
            has_env=self.compiled.has_env,
            env_nee=bool(
                self.compiled.has_env
                and perf.environment_nee != "off"
                and (perf.environment_nee == "on"
                     or (self.compiled.num_lights == 0
                         and perf.enable_next_event_estimation))
            ),
            env_nee_samples=max(1, min(8,
                                       int(perf.environment_nee_samples))),
            has_mix=bool((mats["flags"] & 0x8).any()),
            has_textures=bool(
                (mats["albedo_tex"] >= 0).any()
                | (mats["emissive_tex"] >= 0).any()
                | (mats["specular_tex"] >= 0).any()),
            has_emissive_tex=bool((mats["emissive_tex"] >= 0).any()),
            has_specular_tex=bool((mats["specular_tex"] >= 0).any()),
            has_image_tex=bool((ttype == 0).any()),
            has_scale_tex=bool((ttype == 2).any()),
            has_alpha=bool((mats["alpha_tex"] >= 0).any()),
            has_instances=self.compiled.has_instances,
            has_volume=self.compiled.has_volume,
            volume_light_mis=perf.volume_light_mis,
            has_normal_maps=bool(perf.enable_normal_maps
                                 and (mats["normal_tex"] >= 0).any()),
            transparent_shadows=perf.transparent_shadows,
            want_heatmap=(s.output_type == OutputType.HEATMAP),
            traversal=self.traversal,
            leaf_size=self.compiled.leaf_size,
            decouple_albedo=realtime,
            cut=self._use_cut(),
            cut_k=int(os.environ.get("TB_CUT_K", "8")),
            binned_bounces=self._use_binned(),
        )

    def _use_cut(self) -> bool:
        """The binned-subtree path (trace/cut.py) for every closest-hit
        and shadow wave: opt-in with TB_CUT=1, as in the JAX package, on
        the packed backends of a scene compiled with its tables."""
        return (os.environ.get("TB_CUT") == "1"
                and self.traversal in PACKED_BACKENDS
                and "pk_cut_top" in self.scene)

    def _use_binned(self) -> bool:
        """The binned-cluster backend (trace/binned.py) for the bounce
        waves: opt-in with TB_BINNED=1, as in the JAX package
        (Renderer._use_binned there), on the packed backends of a scene
        compiled with its tables."""
        return (os.environ.get("TB_BINNED") == "1"
                and self.traversal in PACKED_BACKENDS
                and "bn_nodes" in self.scene)

    def update_geometry(self, v0, v1, v2, normals=None):
        """Move the scene's triangles and rebuild its BVHs on the render
        device (the JAX method; the reference's per-change GPU LBVH
        rebuild, GpuBVH2Builder.cpp:167-280). Refreshes the vertex tables,
        the flat normals and UV tangents, tri9, the attribute rows and the
        world bounds; on the packed backends also both BVHs' packed tables
        (accel/bvh_device.py: no host builder, no host copy of the
        vertices), the shadow BVH over the non-light triangles of the
        first update. Then restarts accumulation. Triangle count, UVs and
        materials stay.

        v0, v1, v2: (T, 3) in the scene's triangle order; normals: (T, 3)
        flat normals, by default the normalised cross(e1, e2).

        As in the JAX package, the light records, tri_area and pk_tri_area
        keep their load-time values (NEE samples emitters where they were
        loaded; ROADMAP.md Queue 3), and the host-side CompiledScene keeps
        the load-time geometry. Refused: TLAS scenes (as in the JAX
        package), the wide backend (as the JAX jnp oracle refuses), and
        scenes compiled with cut or binned tables, which a rebuild would
        leave describing the old tree (the JAX method walks them stale;
        ROADMAP.md Queue 3)."""
        if self.compiled.has_instances:
            raise NotImplementedError(
                "update_geometry: use update_instance_transforms / "
                "update_object_geometry on TLAS-instanced scenes")
        if self.traversal == "wide":
            raise NotImplementedError(
                "update_geometry: the wide backend keeps its host build, as "
                "the JAX jnp oracle does; use the brute or kernel backend")
        stale = [k for k in ("pk_cut_top", "pk_sh_cut_top", "bn_nodes")
                 if k in self.scene]
        if stale:
            raise NotImplementedError(
                f"update_geometry: the scene carries {stale}, compiled with "
                "TB_CUT=1 / TB_BINNED=1 from the load-time tree, which a "
                "rebuild does not refresh (ROADMAP.md Queue 3: "
                "update_geometry leaves the cut and binned tables of the "
                "load-time tree)")
        sc = self.scene
        T = sc["tri_v0"].shape[0]
        v0, v1, v2 = (torch.as_tensor(v, dtype=torch.float32).to(self.device)
                      for v in (v0, v1, v2))
        if v0.shape != (T, 3):
            raise ValueError(f"update_geometry keeps topology: expected "
                             f"({T}, 3), got {tuple(v0.shape)}")
        attr_rows = flat_attr_rows(
            v0, v1, v2, sc["tri_uv0"], sc["tri_uv1"], sc["tri_uv2"],
            sc["tri_material"], normals)
        n = attr_rows[:, 0:3]
        sc.update(
            tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_n0=n, tri_n1=n, tri_n2=n,
            tri9=torch.cat([v0, v1, v2], 1),
            tri_attr_rows=attr_rows,
            tri_attr_t=attr_rows.T.contiguous(),
            world_lo=torch.minimum(torch.minimum(v0, v1), v2).amin(0),
            world_hi=torch.maximum(torch.maximum(v0, v1), v2).amax(0))
        if self.traversal in PACKED_BACKENDS:
            from tracerboy_tpu_torch.accel.bvh_device import (
                build_bvh_device,
                pack_for_pallas_device,
            )

            pk = pack_for_pallas_device(build_bvh_device(v0, v1, v2), v0,
                                        v1, v2)
            order = torch.clamp(pk["tri_map"], 0, T - 1).long()
            sc.update(pk_nodes=pk["nodes"], pk_tris_bw=pk["tris_bw"],
                      pk_tri_map=pk["tri_map"],
                      pk_attr_rows=attr_rows[order])
            # The shadow BVH over the opaque triangles of the first update
            # (the JAX method's _shadow_idx, kept from then on).
            if self._shadow_idx is None:
                self._shadow_idx = torch.from_numpy(
                    self.compiled.shadow_tri_ids()).to(self.device)
            so = self._shadow_idx
            s0, s1, s2 = v0[so], v1[so], v2[so]
            pk_sh = pack_for_pallas_device(build_bvh_device(s0, s1, s2), s0,
                                           s1, s2)
            sh_order = so[torch.clamp(pk_sh["tri_map"], 0,
                                      so.shape[0] - 1).long()]
            sc.update(pk_sh_nodes=pk_sh["nodes"],
                      pk_sh_tris_bw=pk_sh["tris_bw"],
                      pk_sh_tri_map=sh_order.to(torch.int32),
                      pk_sh_attr_rows=attr_rows[sh_order])
        self._scene_version += 1
        self.invalidate_history()

    def _refresh_instance_tables(self):
        """Push the host instance tables to the device and refresh the
        world bounds over the flat triangles and the instance boxes."""
        it = self.compiled.inst_tables
        for k in ("inst_obj", "inst_inv", "inst_lo", "inst_hi"):
            self.scene[k] = torch.from_numpy(
                np.ascontiguousarray(it[k])).to(self.device)
        c = self.compiled
        flo = np.minimum(np.minimum(c.tri_v0, c.tri_v1), c.tri_v2).min(0)
        fhi = np.maximum(np.maximum(c.tri_v0, c.tri_v1), c.tri_v2).max(0)
        for key, v in (
                ("world_lo", np.minimum(flo, it["inst_lo"].min(0))),
                ("world_hi", np.maximum(fhi, it["inst_hi"].max(0)))):
            self.scene[key] = torch.from_numpy(
                v.astype(np.float32)).to(self.device)
        self._scene_version += 1
        self.invalidate_history()

    def update_instance_transforms(self, transforms):
        """Animate the TLAS: replace every instance's world<-object
        transform and refit its box (the reference's per-frame top-level
        rebuild, TracerBoy.cpp:1963-2026). The BLASes are untouched.

        transforms: (I, 4, 4) world<-object matrices in instance order."""
        if not self.compiled.has_instances:
            raise ValueError("scene has no TLAS instances")
        it = self.compiled.inst_tables
        M = np.asarray(transforms, np.float64)
        n_inst = it["inst_obj"].shape[0]
        if M.shape != (n_inst, 4, 4):
            raise ValueError(
                f"expected ({n_inst}, 4, 4) transforms, got {M.shape}")
        objs = self.compiled.inst_objects
        inv_rows = np.empty((n_inst, 12), np.float32)
        lo_rows = np.empty((n_inst, 3), np.float32)
        hi_rows = np.empty((n_inst, 3), np.float32)
        for i in range(n_inst):
            inv_rows[i] = np.linalg.inv(M[i])[:3, :4].reshape(12).astype(
                np.float32)
            o = objs[int(it["inst_obj"][i])]
            lo, hi = o["lo"], o["hi"]
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            wc = corners @ M[i, :3, :3].T + M[i, :3, 3]
            lo_rows[i] = wc.min(0)
            hi_rows[i] = wc.max(0)
        it["inst_inv"] = inv_rows
        it["inst_lo"] = lo_rows
        it["inst_hi"] = hi_rows
        self._refresh_instance_tables()

    def update_object_geometry(self, obj_index: int, v0, v1, v2):
        """Deform one instanced object and rebuild its BLAS on the render
        device (the JAX method; the reference's per-object bottom-level
        rebuild, TracerBoy.cpp:1963-2026). Topology, UVs and materials
        stay; the flat normals and UV tangents are derived again into the
        object's packed-order rows of pk_attr_rows, and the boxes of the
        object's instances are refit on the host from its new bounds.

        v0, v1, v2: (T, 3) object-space vertices in the object's triangle
        order."""
        if not self.compiled.has_instances:
            raise ValueError("scene has no TLAS instances")
        from tracerboy_tpu_torch.accel.bvh_device import (
            build_bvh_device,
            pack_for_pallas_device,
        )

        obj = self.compiled.inst_objects[obj_index]
        topo = obj["attrs_topo"]
        T = topo.shape[0]
        v0, v1, v2 = (torch.as_tensor(v, dtype=torch.float32).to(self.device)
                      for v in (v0, v1, v2))
        if v0.shape != (T, 3):
            raise ValueError(f"update_object_geometry keeps topology: "
                             f"expected ({T}, 3), got {tuple(v0.shape)}")
        pk = pack_for_pallas_device(build_bvh_device(v0, v1, v2), v0, v1, v2)
        P = int(obj["attrs"].shape[0])
        if pk["tri_map"].shape[0] > P:
            raise ValueError("device pack emitted more triangle rows than "
                             "the compile-time layout reserved")
        topo_t = torch.from_numpy(np.ascontiguousarray(topo)).to(self.device)
        rows = flat_attr_rows(v0, v1, v2, topo_t[:, 9:11], topo_t[:, 11:13],
                              topo_t[:, 13:15], topo_t[:, 15])
        rows = rows[torch.clamp(pk["tri_map"], 0, T - 1).long()]
        if rows.shape[0] < P:
            # The host pack's order runs past T; device ids stay below T,
            # so the tail is never fetched: pad with the last row to keep
            # the bases of later objects.
            rows = torch.cat([rows, rows[-1:].expand(P - rows.shape[0], 19)])
        entry = self.scene["inst_objs"][obj_index]
        entry["packed"]["nodes"] = pk["nodes"]
        entry["packed"]["tris_bw"] = pk["tris_bw"]
        base = int(entry["base"])
        self.scene["pk_attr_rows"][base:base + P] = rows
        self._scene_version += 1
        # TLAS refit of the object's instances, on the host (the tables
        # are small and the transforms live there).
        v0h, v1h, v2h = (v.cpu().numpy() for v in (v0, v1, v2))
        obj["lo"] = np.minimum(np.minimum(v0h, v1h), v2h).min(0)
        obj["hi"] = np.maximum(np.maximum(v0h, v1h), v2h).max(0)
        obj["verts"] = np.stack([v0h, v1h, v2h], axis=1)
        it = self.compiled.inst_tables
        lo_t = np.asarray(it["inst_lo"]).copy()
        hi_t = np.asarray(it["inst_hi"]).copy()
        corners = _box_corners(obj["lo"], obj["hi"])
        for i in np.flatnonzero(np.asarray(it["inst_obj"]) == obj_index):
            inv = np.asarray(it["inst_inv"][i], np.float64).reshape(3, 4)
            M = np.linalg.inv(np.vstack([inv, [0.0, 0.0, 0.0, 1.0]]))
            wc = corners @ M[:3, :3].T + M[:3, 3]
            lo_t[i] = wc.min(0)
            hi_t[i] = wc.max(0)
        it["inst_lo"] = lo_t
        it["inst_hi"] = hi_t
        self._refresh_instance_tables()

    def frame_params(self, fixed_offset=None) -> dict:
        """The wave's per-frame parameters; fixed_offset: every lane's
        sub-pixel jitter (RealTime mode's per-frame Halton offset)."""
        s = self.settings
        p = dict(
            dof_focus=float(np.float32(s.camera_settings.dof_focus_distance)),
            dof_aperture=float(
                np.float32(s.camera_settings.dof_aperture_width)),
            firefly_clamp=float(np.float32(s.fireflies_clamp)),
            seed=self.seed,
        )
        if s.performance_settings.use_blue_noise:
            if self._bn_cache is None:
                self._bn_cache = make_blue_noise_params(
                    self.scene, self.pixel_ids, self.width)
            p["bn"] = self._bn_cache
        if fixed_offset is not None:
            p["fixed_pixel_offset"] = fixed_offset
        return p

    # -- adaptive sampling (VarianceUtil.h ShouldSkipRay) -----------------
    ADAPTIVE_MIN_SPP = 64  # the reference starts comparing after many spp

    def active_pixel_mask(self) -> torch.Tensor | None:
        """Per-pixel convergence mask (H*W,) bool; None when adaptive
        sampling is off or not warmed up. A pixel goes inactive when the
        two accumulator estimates agree within min_convergence (relative
        luma error)."""
        perf = self.settings.performance_settings
        if (not perf.enable_adaptive_sampling
                or self.state.spp < self.ADAPTIVE_MIN_SPP):
            return None
        a = self.state.accum
        j = self.state.accum_jittered
        la = _luma(a[..., :3] / torch.clamp_min(a[..., 3:4], 1e-8))[..., 0]
        lj = _luma(j[..., :3] / torch.clamp_min(j[..., 3:4], 1e-8))[..., 0]
        err = torch.abs(la - lj) / torch.clamp_min(la, 1e-4)
        return (err > perf.min_convergence).reshape(-1)

    # -- stepping --------------------------------------------------------
    def render_sample(self, n: int = 1):
        """Trace n progressive samples, accumulating into state. On the
        packed backends, and on every backend with the tent splat
        (filter_splat, k = 1 included), n > 1 merges up to k samples into
        one wave of k*N lanes; otherwise brute force and the wide backend
        batch single-sample waves (so the AOVs are the last sample's, as
        in the JAX package). With adaptive sampling warmed up, pixels
        outside active_pixel_mask() trace nothing. A sharded renderer
        dispatches to _render_sample_spp_sharded or _render_sample_tiled."""
        if self.shard == "spp":
            return self._render_sample_spp_sharded(n)
        if self.shard == "tiles":
            return self._render_sample_tiled(n)
        cfg = self.wave_config()
        params = self.frame_params()
        mask = self.active_pixel_mask()
        if mask is not None:
            params["active_mask"] = mask
            self._live_pixels = mask
        ids = self.pixel_ids
        merged = ((cfg.traversal in PACKED_BACKENDS or cfg.filter_splat)
                  and params.get("selected_pixel") is None)
        if merged and (n > 1 or cfg.filter_splat):
            k_max = max(1, min(MERGED_WAVE_MAX_K,
                               MERGED_WAVE_LANES // max(ids.shape[0], 1)))
            done = 0
            while done < n:
                kk = min(n - done, k_max)
                if kk == 1 and not cfg.filter_splat:
                    out = render_wave(self.scene, params, ids,
                                      self.state.spp, cfg)
                else:
                    out = render_wave_merged(self.scene, params, ids,
                                             self.state.spp, kk, cfg)
                self._accumulate(out, samples=kk)
                done += kk
        elif n > 1:
            out = render_wave_batch(self.scene, params, ids,
                                    self.state.spp, n, cfg)
            self._accumulate(out, samples=n)
        else:
            out = render_wave(self.scene, params, ids, self.state.spp, cfg)
            self._accumulate(out)
        return self.state

    def render_sample_adaptive(self, spp: int = 8, pilot: int = 0,
                               exponent: float = 0.5,
                               max_per_pixel: int = 256):
        """Variance-guided redistribution of a FIXED budget of spp samples
        a pixel (the JAX package's adaptive burst). A uniform merged pilot
        of `pilot` samples (spp // 2 by default) measures each pixel's
        tonemapped-luma variance; the residual budget is water-filled
        (_waterfill, float64 on the host) so that the total a pixel gets
        tracks var**exponent (0.5 is the L2-optimal allocation), and the
        residual traces as ONE wave whose lanes repeat pixels, sample index
        spp + occurrence. Each pixel's lanes are summed in a fixed order
        (occurrence by occurrence), so a run is reproducible bit for bit.
        The counts of the last call are kept in _last_adaptive_counts.
        A sharded renderer refuses it, as in the JAX package."""
        if self.shard is not None:
            raise NotImplementedError(
                "adaptive burst is single-chip; shard the spp loop "
                "outside it")
        pilot = pilot or max(1, spp // 2)
        pilot = min(pilot, spp)
        h, w = self.height, self.width
        N = h * w
        params = self.frame_params()
        cfg = self.wave_config()
        out = render_wave_merged(self.scene, params, self.pixel_ids,
                                 self.state.spp, pilot, cfg, fold_var=True)
        lum = out["lum"].cpu().numpy().astype(np.float64)
        lum_sq = out["lum_sq"].cpu().numpy().astype(np.float64)
        self._accumulate(out, samples=pilot)
        budget = (spp - pilot) * N
        if budget <= 0:
            return self.state
        var = np.maximum(lum_sq / pilot - (lum / pilot) ** 2, 0.0)
        # 3x3 box smooth: a pilot of a few samples is itself noisy, and
        # selecting on raw estimates funnels budget to lucky outliers.
        v = var.reshape(h, w)
        vp = np.pad(v, 1, mode="edge")
        v = sum(vp[dy:dy + h, dx:dx + w]
                for dy in range(3) for dx in range(3)) / 9.0
        target = v.reshape(-1) ** exponent
        counts = self._waterfill(target, pilot, budget, max_per_pixel)
        self._last_adaptive_counts = counts
        ids_r = np.repeat(np.arange(N, dtype=np.int64), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int64)
        occ = np.arange(budget, dtype=np.int64) - starts[ids_r]
        dev = self.device
        ids_dev = torch.from_numpy(ids_r).to(dev)
        sidx = self.state.spp + torch.from_numpy(occ).to(dev)
        p2 = dict(params)
        if p2.get("bn") is not None:
            p2["bn"] = tuple(b[ids_dev] for b in p2["bn"])
        out_r = render_wave(self.scene, p2, ids_dev, sidx, cfg, aov_lanes=0)
        del ids_dev, sidx, p2
        vals = torch.cat([out_r["radiance"], out_r["filter_weight"][:, None]],
                         dim=-1)
        self.rays_traced += int(out_r["rays_traced"])
        del out_r
        # The segment sum over the repeated pixel ids in a fixed order:
        # occurrence j of every pixel with more than j lanes at once (the
        # ids of one level are distinct, so no two writes meet).
        sample = torch.zeros((N, 4), dtype=torch.float32, device=dev)
        for j in range(int(counts.max())):
            pix = np.nonzero(counts > j)[0]
            lanes = torch.from_numpy(starts[pix] + j).to(dev)
            pix = torch.from_numpy(pix).to(dev)
            sample[pix] = sample[pix] + vals[lanes]
        del vals
        sample = sample.reshape(h, w, 4)
        st = self.state
        st.accum = st.accum + sample
        coin = tbrng.uniform(self.pixel_ids, st.spp, 0,
                             tbrng.STREAM_ACCUM_JITTER).reshape(h, w)
        take = coin < 0.5 if st.spp != 0 else torch.ones_like(
            coin, dtype=bool)
        st.accum_jittered = torch.where(take[..., None],
                                        st.accum_jittered + sample,
                                        st.accum_jittered)
        st.spp += spp - pilot
        return st

    @staticmethod
    def _waterfill(target, pilot, budget, cap):
        """Integer allocation m_p >= 0 with sum m_p == budget such that
        pilot + m_p tracks c*target (water-filling above the pilot floor,
        capped): bisection on c, largest-remainder rounding. The JAX
        package's function as it is, float64 numpy, so that the counts
        are equal."""
        t = np.asarray(target, np.float64)
        N = t.shape[0]
        if not np.isfinite(t).all():
            t = np.nan_to_num(t)
        if t.sum() <= 0.0:
            m = np.full(N, budget // N, np.int64)
            m[: budget - int(m.sum())] += 1
            return m

        def alloc(c):
            return np.minimum(np.maximum(c * t - pilot, 0.0), cap)

        lo, hi = 0.0, 1.0
        while alloc(hi).sum() < budget and hi < 1e18:
            hi *= 2.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if alloc(mid).sum() < budget:
                lo = mid
            else:
                hi = mid
        frac = alloc(hi)
        m = np.floor(frac).astype(np.int64)
        short = budget - int(m.sum())
        if short > 0:
            rem = frac - m
            # Deterministic largest-remainder top-up.
            order = np.argsort(-rem, kind="stable")[:short]
            m[order] += 1
        elif short < 0:
            order = np.argsort(frac - m, kind="stable")
            gz = order[m[order] > 0][: -short]
            m[gz] -= 1
        return m

    # -- multi-device paths (parallel/sharding.py) -----------------------
    def _mesh_scenes(self) -> list:
        """The scene of each mesh entry: self.scene for the first, a
        replica for every other (a clone where the device repeats),
        copied again whenever the scene's version moved since."""
        from tracerboy_tpu_torch.parallel.sharding import replicate

        if self._replicas is None or self._replicas[0] != self._scene_version:
            self._replicas = (self._scene_version, [self.scene] + [
                replicate(self.scene, d) for d in self.mesh.devices[1:]])
        return self._replicas[1]

    def _render_sample_spp_sharded(self, n: int):
        """n progressive samples sharded over the mesh by sample index:
        n rounds UP to a multiple of the mesh size, each of the D entries
        tracing spd = ceil(n / D) samples (one merged wave on the packed
        backends while spd * N <= MERGED_WAVE_LANES). The jittered
        accumulator takes the whole batch under one coin, as the JAX
        package's does."""
        from tracerboy_tpu_torch.parallel.sharding import render_spp_sharded

        cfg = self.wave_config()
        D = self.mesh.size
        spd = -(-n // D)
        params = self.frame_params()
        mask = self.active_pixel_mask()
        if mask is not None:
            params["active_mask"] = mask
            self._live_pixels = mask
        ids = self.pixel_ids
        use_merged = (cfg.traversal in PACKED_BACKENDS and spd > 1
                      and spd * ids.shape[0] <= MERGED_WAVE_LANES)
        rad, fw, rays = render_spp_sharded(
            self.mesh, self._mesh_scenes(), params, ids, self.state.spp, cfg,
            samples_per_device=spd, use_merged=use_merged)
        h, w = self.height, self.width
        sample = torch.cat([rad.reshape(h, w, 3), fw.reshape(h, w, 1)], -1)
        st = self.state
        st.accum = st.accum + sample
        coin = tbrng.uniform(self.pixel_ids, st.spp, 0,
                             tbrng.STREAM_ACCUM_JITTER).reshape(h, w)
        take = coin < 0.5 if st.spp != 0 else torch.ones_like(
            coin, dtype=bool)
        st.accum_jittered = torch.where(take[..., None],
                                        st.accum_jittered + sample,
                                        st.accum_jittered)
        st.spp += spd * D
        self.rays_traced += int(rays)
        return st

    def _render_sample_tiled(self, n: int):
        """n progressive samples with the pixel pool split over the mesh
        (shard_pixels pads it to a multiple of the mesh size): n waves of
        one sample, each sliced back to the film's N lanes and
        accumulated as an unsharded wave is."""
        from tracerboy_tpu_torch.parallel.sharding import (
            render_wave_tiled,
            shard_pixels,
        )

        cfg = self.wave_config()
        h, w = self.height, self.width
        N = w * h
        if self._tiled_pixels is None:
            self._tiled_pixels = shard_pixels(self.mesh, w, h)
        pixel_ids, pad = self._tiled_pixels
        params = self.frame_params()
        if "bn" in params:
            # The blue-noise pre-gather over the padded pool's lanes.
            if self._bn_cache_tiled is None:
                self._bn_cache_tiled = make_blue_noise_params(
                    self.scene, pixel_ids, w)
            params["bn"] = self._bn_cache_tiled
        mask = self.active_pixel_mask()
        if mask is not None:
            self._live_pixels = mask
            params["active_mask"] = torch.cat([mask, mask.new_zeros(pad)])
        n_lanes = N + pad
        for _ in range(n):
            out = render_wave_tiled(self.mesh, self._mesh_scenes(), params,
                                    pixel_ids, self.state.spp, cfg)
            out = {k: (v[:N] if k != "viz_rays" and v.ndim >= 1
                       and v.shape[0] == n_lanes else v)
                   for k, v in out.items()}
            self._accumulate(out)
        return self.state

    def _accumulate(self, out, samples: int = 1):
        h, w = self.height, self.width
        sample = torch.cat([out["radiance"].reshape(h, w, 3),
                            out["filter_weight"].reshape(h, w, 1)], dim=-1)
        st = self.state
        if self.settings.render_mode == RenderMode.REAL_TIME:
            st.accum = sample
        else:
            st.accum = st.accum + sample
            # Jittered accumulator: first sample/batch always, then a
            # per-pixel coin flip (RayGenCommon.h:719-727).
            coin = tbrng.uniform(self.pixel_ids, st.spp, 0,
                                 tbrng.STREAM_ACCUM_JITTER).reshape(h, w)
            take = coin < 0.5 if st.spp != 0 else torch.ones_like(
                coin, dtype=bool)
            st.accum_jittered = torch.where(take[..., None],
                                            st.accum_jittered + sample,
                                            st.accum_jittered)
        st.world_pos[st.spp % 2] = torch.cat(
            [out["world_pos"].reshape(h, w, 3),
             out["neighbor_dist"].reshape(h, w, 1)], dim=-1)
        st.spp += samples
        self.rays_traced += int(out["rays_traced"])
        self._last_aovs = out

    # -- RealTime mode (1 spp, temporal accumulation, a-trous, composite) --
    def _rt_aovs(self, out) -> dict:
        """The (H, W, ...) planes of one demodulated wave that the post
        chain reads."""
        h, w = self.height, self.width
        return dict(
            albedo=out["albedo"].reshape(h, w, 3),
            normal=out["normal"].reshape(h, w, 3),
            world_pos=torch.cat([out["world_pos"].reshape(h, w, 3),
                                 out["neighbor_dist"].reshape(h, w, 1)], -1),
            emissive=out["emissive"].reshape(h, w, 3),
            # The exact per-channel ratio D / I of the two-plane trace:
            # composite(albedo, D / I, I, E) is the plain radiance.
            diffuse_contrib=_demod_ratio(
                out["radiance_d"].reshape(h, w, 3),
                out["radiance"].reshape(h, w, 3)),
        )

    def _rt_trace(self, frame: int, active=None):
        """One demodulated sample at the frame's Halton jitter; marks the
        stage events when asked to."""
        if self.time_realtime_stages:
            self.rt_stage_events = [torch.cuda.Event(enable_timing=True)
                                    for _ in range(3)]
            self.rt_stage_events[0].record()
        offset = tbrng.halton23(torch.as_tensor(frame, device=self.device))
        params = self.frame_params(fixed_offset=offset)
        if active is not None:
            params["active_mask"] = active
        out = render_wave(self.scene, params, self.pixel_ids, frame,
                          self.wave_config())
        if self.time_realtime_stages:
            self.rt_stage_events[1].record()
        return out

    def _rt_finish(self, display, exposure, as_numpy):
        ps = self.settings.post_settings
        img = display_transform(
            display, exposure, int(ps.tonemap_type),
            ps.enable_gamma_correction, ps.enable_auto_exposure)
        self._cam_prev = dict(self.scene["camera"])
        if self.time_realtime_stages:
            self.rt_stage_events[2].record()
        return img.cpu().numpy() if as_numpy else img

    def render_realtime_frame(self, as_numpy: bool = True):
        """One RealTime frame: a 1-spp demodulated trace -> temporal
        accumulation -> a-trous -> albedo composite -> temporal
        accumulation -> display transform. Returns the display image
        (H, W, 3), on the host unless as_numpy is False."""
        from tracerboy_tpu_torch.post.realtime import realtime_frame

        out = self._rt_trace(self.state.spp)
        self._accumulate(out)
        h, w = self.height, self.width
        display, self._rt_history = realtime_frame(
            out["radiance"].reshape(h, w, 3), self._rt_aovs(out),
            self._rt_history, self._cam_prev or self.scene["camera"],
            float(self.compiled.camera.lens_height),
            self.settings.denoiser_settings)
        return self._rt_finish(
            display, self.settings.post_settings.exposure_multiplier,
            as_numpy)

    def render_realtime_frame_fused(self, as_numpy: bool = False):
        """One RealTime frame with adaptive dispatch and the frame-rate
        governor (TracerBoy.cpp:2691-2727, 2846-2849): once
        target_frame_rate > 0, a per-pixel mask from the temporal moment
        buffer skips converged pixels (their lighting and AOVs are taken
        from the history), and the governor's pad widens the skip
        threshold while the measured frame rate lags the target. The
        first frame after a restart (state.spp == 0) ignores the history.
        Returns the display image, on the device unless as_numpy."""
        from tracerboy_tpu_torch.post.realtime import (
            FrameRateGovernor,
            adaptive_active_mask,
            frame_chain,
        )

        h, w = self.height, self.width
        frame = self.state.spp
        if self._rt_hist_fused is None:
            self._rt_hist_fused = self.empty_realtime_history()
        history = self._rt_hist_fused
        first = frame == 0
        perf = self.settings.performance_settings
        adaptive = perf.target_frame_rate > 0

        if self._governor is None:
            self._governor = FrameRateGovernor(
                target_fps=perf.target_frame_rate,
                pad=perf.convergence_percent_pad)
        now = time.time()
        if self._rt_last_time is not None:
            self._governor.update(now - self._rt_last_time)
        self._rt_last_time = now
        threshold = float(np.float32(perf.min_convergence
                                     + self._governor.pad))

        active = None
        if adaptive and not first:
            active = adaptive_active_mask(history["moments"], threshold, 0.0,
                                          frame)
        out = self._rt_trace(frame, active)
        raw = out["radiance"].reshape(h, w, 3)
        aovs = self._rt_aovs(out)
        if active is None:
            active = torch.ones(h * w, dtype=torch.bool, device=self.device)
        else:
            am = active.reshape(h, w, 1)
            raw = torch.where(am, raw, history["raw"])
            aovs = {k: torch.where(am, v, history["aovs"][k])
                    for k, v in aovs.items()}
        display, new_hist = frame_chain(
            raw, aovs, history, self._cam_prev or self.scene["camera"],
            float(self.compiled.camera.lens_height),
            self.settings.denoiser_settings, RT_HISTORY_WEIGHT,
            ignore_history=first)
        new_hist["raw"] = raw
        new_hist["aovs"] = aovs
        self._rt_hist_fused = new_hist
        self._live_pixels = active
        self._rt_live_pixels = active.sum()
        self._last_aovs = out
        self.rays_traced += int(out["rays_traced"])
        self.state.spp += 1
        return self._rt_finish(display, 1.0, as_numpy)

    def empty_realtime_history(self) -> dict:
        """The fused RealTime path's history before its first frame:
        zeros of the shapes the JAX renderer's _rt_hist_fused has."""
        def z(c=3):
            return torch.zeros((self.height, self.width, c),
                               dtype=torch.float32, device=self.device)

        return dict(
            indirect=z(), moments=z(), final=z(), prev_world_pos=z(4),
            raw=z(),
            aovs=dict(albedo=z(), normal=z(), world_pos=z(4), emissive=z(),
                      diffuse_contrib=z()))

    def load_realtime_history(self, history: dict | None,
                              cam_prev: dict | None = None,
                              fused: bool = True):
        """Take a RealTime temporal history given as numpy arrays (the JAX
        renderer's _rt_hist_fused: indirect, moments, final,
        prev_world_pos, raw and the nested aovs; or its _rt_history
        without raw and aovs, with fused=False) and the previous frame's
        camera leaves, so that a frame can continue from another
        renderer's state. None clears them."""
        hist = None if history is None else from_jax_pytree(history,
                                                            self.device)
        if fused:
            self._rt_hist_fused = hist
        else:
            self._rt_history = hist or {}
        self._cam_prev = (None if cam_prev is None
                          else from_jax_pytree(cam_prev, self.device))

    # -- readout ---------------------------------------------------------
    def resolve_radiance(self) -> torch.Tensor:
        """Mean radiance image (H, W, 3) from the weighted accumulator."""
        return resolve_accumulator(self.state.accum)

    def current_image(self, tonemapped: bool = True) -> np.ndarray:
        """The display image (H, W, 3) float32 in [0, 1], on the host: the
        lit image, or the debug view settings.output_type selects.
        tonemapped: taken for the JAX package's signature; as there, the
        post chain of the settings decides the image either way."""
        aovs = self._last_aovs
        if aovs is not None:
            aovs = dict(aovs, variance=self._estimate_gap()[..., 0])
            if self._live_pixels is not None:
                aovs["live_pixels"] = self._live_pixels
            if self._cam_prev is not None:
                from tracerboy_tpu_torch.post.temporal import (
                    generate_motion_vectors,
                )

                aovs["motion"] = generate_motion_vectors(
                    aovs["world_pos"].reshape(self.height, self.width, 3),
                    self._cam_prev, self.scene["camera"],
                    float(self.compiled.camera.lens_height), self.width,
                    self.height)
        return post_process(self.state.accum, self.settings, aovs=aovs,
                            width=self.width,
                            height=self.height).cpu().numpy()

    def _estimate_gap(self):
        """(H, W, 1) |main - jittered| luminance of the two accumulator
        estimates (the VarianceUtil metric): the variance view and the
        convergence error."""
        la = _luma(self.resolve_radiance())
        lj = _luma(resolve_accumulator(self.state.accum_jittered))
        return torch.abs(la - lj)

    def convergence_error(self) -> float:
        """Mean |main - jittered| luminance difference of the two
        accumulator estimates (the adaptive-sampling convergence
        metric)."""
        return float(torch.mean(self._estimate_gap()))

    def select_pixel(self, x: int, y: int) -> dict:
        """The last wave's first-hit AOVs at pixel (x, y) (the reference's
        SelectPixel round trip); {} before the first sample."""
        aovs = self._last_aovs
        if aovs is None:
            return {}
        idx = y * self.width + x
        return dict(
            material_id=int(aovs["material"][idx]),
            depth=float(aovs["depth"][idx]),
            albedo=aovs["albedo"][idx].cpu().numpy(),
            normal=aovs["normal"][idx].cpu().numpy(),
            world_pos=aovs["world_pos"][idx].cpu().numpy(),
        )

    def get_material(self, material_id: int) -> dict:
        """Every field of one material record, as numpy."""
        return {k: np.asarray(v[material_id])
                for k, v in self.compiled.materials.items()}

    def set_material(self, material_id: int, **fields):
        """Live material editing (the reference's single material-buffer
        update, TracerBoy.cpp:2592-2604 + 3931-3939): writes the one
        material row of each edited field on the host and on the device,
        never re-packing the BVH, and restarts accumulation. Editing
        `flags` can change which triangles occlude shadow rays, so it also
        refreshes tri_shadow_opaque (the packed shadow BVH keeps its
        light exclusion, as in the JAX package)."""
        mats = self.scene["materials"]
        for k, v in fields.items():
            arr = np.asarray(self.compiled.materials[k]).copy()
            arr[material_id] = v
            self.compiled.materials[k] = arr
            mats[k][material_id] = torch.from_numpy(
                np.array(_canonical(arr[material_id]))).to(self.device)
        if "flags" in fields:
            c = self.compiled
            self.scene["tri_shadow_opaque"] = torch.from_numpy(
                (c.materials["flags"][c.tri_material] & LIGHT_FLAG) == 0
            ).to(self.device)
        self._scene_version += 1
        self.invalidate_history()

    def visualize_selected_ray_path(self, x: int, y: int,
                                    spp: int = 1) -> np.ndarray:
        """Trace one wave that records pixel (x, y)'s bounce path,
        accumulate it, and return the display image with the path drawn
        on it (the reference's VisualizeRays view). spp is not read: one
        wave is traced, as in the JAX package."""
        from tracerboy_tpu_torch.post.visualize import overlay_ray_path

        params = self.frame_params()
        params["selected_pixel"] = y * self.width + x
        out = render_wave(self.scene, params, self.pixel_ids, self.state.spp,
                          self.wave_config())
        self._accumulate(out)
        cam = {k: v.cpu().numpy() for k, v in self.scene["camera"].items()}
        return overlay_ray_path(self.current_image(),
                                out["viz_rays"].cpu().numpy(), cam,
                                self.width, self.height)

    def denoise(self, model: str = "rt_ldr", transfer: str = "reinhard",
                archive: str | None = None) -> np.ndarray:
        """OIDN-denoised linear radiance (H, W, 3), on the host.

        model: "rt_ldr" or "rt_ldr_alb_nrm" (aux-guided: the last wave's
        albedo and normal AOVs, or one AOV sample rendered on demand when
        none is kept). transfer: "reinhard" runs the network on the
        invertible x / (1 + x) curve and maps back; "clip" denoises
        clip(x, 0, 1), as the reference does its tonemapped output.
        archive: the path of the model's OIDN weights (the reference's
        {model}.tza), a deployment setting; the repository ships none."""
        from tracerboy_tpu_torch.ml.finetune import reinhard_fwd, reinhard_inv
        from tracerboy_tpu_torch.ml.oidn import denoise_image, load_oidn

        if archive is None:
            raise ValueError(f"Renderer.denoise needs archive=, the path of "
                             f"{model}.tza")
        lin = torch.clamp_min(self.resolve_radiance(), 0.0)
        if transfer == "reinhard":
            enc = reinhard_fwd(lin)
        else:
            enc = torch.clamp(lin, 0.0, 1.0) ** (1 / 2.2)
        kw = {}
        if model == "rt_ldr_alb_nrm":
            aovs = self._last_aovs
            if aovs is None or "albedo" not in aovs:
                aovs = render_wave(self.scene, self.frame_params(),
                                   self.pixel_ids, self.state.spp,
                                   self.wave_config())
            h, w = self.height, self.width
            kw = dict(albedo=torch.clamp(aovs["albedo"].reshape(h, w, 3),
                                         0.0, 1.0),
                      normal=aovs["normal"].reshape(h, w, 3))
        net = load_oidn(archive).to(self.device)
        den = denoise_image(net, enc, **kw)
        if transfer == "reinhard":
            return reinhard_inv(den).cpu().numpy()
        return (torch.clamp(den, 0.0, 1.0) ** 2.2).cpu().numpy()

    def trace_decoupled(self, spp: int = 8,
                        clamp: float | None = None) -> dict:
        """Trace spp demodulated samples (the two radiance planes and the
        summed albedo, normal and emissive AOVs) without touching the
        state; returns the accumulator dict render_denoised reads, so one
        trace can feed several denoiser variants. clamp: a firefly clamp
        for this trace only. Merged waves on every backend."""
        N = self.width * self.height
        saved = self.settings
        try:
            if clamp:
                self.settings = self.settings.replace(fireflies_clamp=clamp)
            cfg = replace(self.wave_config(), decouple_albedo=True)
            params = self.frame_params()
        finally:
            self.settings = saved
        k_max = max(1, min(MERGED_WAVE_MAX_K, MERGED_WAVE_LANES // N))
        acc: dict = {}
        done = 0
        while done < spp:
            kk = min(k_max, spp - done)
            out = render_wave_merged(self.scene, params, self.pixel_ids,
                                     done, kk, cfg, fold_aovs=True)
            for key in ("radiance", "radiance_d", "albedo", "normal",
                        "emissive"):
                acc[key] = acc.get(key, 0.0) + out[key]
            acc["fw"] = acc.get("fw", 0.0) + out["filter_weight"]
            acc["wpos"] = out["world_pos"]      # guide: the first sample's
            acc["nd"] = out["neighbor_dist"]
            self.rays_traced += int(out["rays_traced"])
            done += kk
        acc["spp"] = spp
        return acc

    def render_denoised(self, spp: int = 8, model: str = "rt_ldr",
                        transfer: str = "reinhard", demod: bool = True,
                        dc_filter_iters: int = 2,
                        filter_albedo: bool = False,
                        clamp: float | None = None, _acc: dict | None = None,
                        archive: str | None = None) -> np.ndarray:
        """Demodulated low-spp denoise, RealTime's design as one batch
        call: trace spp demodulated samples, run the OIDN UNet on the
        lighting (texture detail never reaches the network), then
        composite the albedo again. The noisy per-pixel ratio D / I would
        multiply the denoised signal by noise, so it is filtered first
        (dc_filter_iters a-trous steps guided by normal and position).
        demod=False composites first and denoises the final image. _acc: a
        trace_decoupled() result to denoise instead of tracing. archive:
        the path of {model}.tza (the repository ships none). Returns
        linear radiance (H, W, 3) on the host; does not touch the state."""
        from tracerboy_tpu_torch.ml.finetune import reinhard_fwd, reinhard_inv
        from tracerboy_tpu_torch.ml.oidn import denoise_image, load_oidn
        from tracerboy_tpu_torch.post.denoise import denoise as atrous
        from tracerboy_tpu_torch.post.realtime import composite_albedo

        if archive is None:
            raise ValueError(f"Renderer.render_denoised needs archive=, the "
                             f"path of {model}.tza")
        h, w = self.height, self.width
        acc = _acc if _acc is not None else self.trace_decoupled(
            spp, clamp=clamp)
        spp = acc.get("spp", spp)
        fw = torch.clamp_min(acc["fw"], 1e-8)[:, None]
        illum = (acc["radiance"] / fw).reshape(h, w, 3)
        dc = _demod_ratio(acc["radiance_d"] / fw,
                          acc["radiance"] / fw).reshape(h, w, 3)
        alb = torch.clamp(acc["albedo"] / spp, 0.0, 1.0).reshape(h, w, 3)
        nrm = (acc["normal"] / spp).reshape(h, w, 3)
        emi = (acc["emissive"] / spp).reshape(h, w, 3)
        target = illum if demod else composite_albedo(alb, dc, illum, emi)
        if transfer == "reinhard":
            enc = reinhard_fwd(torch.clamp_min(target, 0.0))
        else:
            enc = torch.clamp(target, 0.0, 1.0) ** (1 / 2.2)
        kw = {}
        if model == "rt_ldr_alb_nrm":
            kw = dict(albedo=torch.ones_like(alb) if demod else alb,
                      normal=nrm)
        net = load_oidn(archive).to(self.device)
        den = denoise_image(net, enc, **kw)
        if transfer == "reinhard":
            den_lin = reinhard_inv(den)
        else:
            den_lin = torch.clamp(den, 0.0, 1.0) ** 2.2
        if not demod:
            return den_lin.cpu().numpy()
        if dc_filter_iters > 0:
            wpos4 = torch.cat([acc["wpos"].reshape(h, w, 3),
                               acc["nd"].reshape(h, w, 1)], dim=-1)

            def smooth(p, iters):
                x = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
                return atrous(x, p, nrm, wpos4, iterations=iters)[..., :3]

            dc = torch.clamp(smooth(dc, dc_filter_iters), 0.0, 1.0)
            if filter_albedo:
                alb = torch.clamp(smooth(alb, 1), 0.0, 1.0)
        return composite_albedo(alb, dc, den_lin, emi).cpu().numpy()

    def render(self, spp: int | None = None) -> np.ndarray:
        """Trace to the sample target (or the time limit) and return the
        display image."""
        target = spp or self.settings.performance_settings.sample_target
        limit = self.settings.debug_settings.time_limit_seconds
        while self.state.spp < target:
            self.render_sample()
            if limit > 0 and (time.time() - self._start_time) > limit:
                break
        return self.current_image()
