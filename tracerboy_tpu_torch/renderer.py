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

Sharding, adaptive sampling in Unbiased mode and the splat fold are not
ported yet.
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
    from_jax_pytree,
    load_scene,
)
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


def _check_settings(settings: OutputSettings):
    if settings.performance_settings.enable_adaptive_sampling:
        raise NotImplementedError(
            "adaptive sampling is not ported yet (ROADMAP.md, Queue 1)")


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
                 device="cuda"):
        """scene: a CompiledScene or a name for load_scene ("shadertoy",
        "shadertoy:cornell")."""
        if isinstance(scene, str):
            scene = load_scene(scene, film_size=film_size)
        if not isinstance(scene, CompiledScene):
            raise TypeError(f"scene must be a CompiledScene or a name, got "
                            f"{type(scene).__name__}")
        self.compiled = scene
        self.device = torch.device(device)
        self.seed = int(seed)
        self.settings = settings or default_output_settings()
        _check_settings(self.settings)
        self.width = scene.film_width
        self.height = scene.film_height
        if film_size is not None:
            self.width, self.height = film_size
        self.traversal = self._pick_traversal(scene)
        self.scene = scene.as_tensors(self.device)
        self.pixel_ids = torch.arange(self.width * self.height,
                                      dtype=torch.int64, device=self.device)
        self._bn_cache = None
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
        triangle there), the traversal kernels otherwise; TB_TRAVERSAL =
        brute | pallas | jnp overrides it."""
        forced = os.environ.get("TB_TRAVERSAL")
        if forced in TRAVERSAL_NAMES:
            return TRAVERSAL_NAMES[forced]
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
        _check_settings(new_settings)
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
        self.invalidate_history()

    def wave_config(self) -> WaveConfig:
        s = self.settings
        perf = s.performance_settings
        mats = self.compiled.materials
        ttype = self.compiled.tex_records["ttype"]
        realtime = s.render_mode == RenderMode.REAL_TIME
        if s.camera_settings.filter_splat and not realtime:
            raise NotImplementedError(
                "filter_splat is not ported yet (ROADMAP.md, Queue 1)")
        return WaveConfig(
            width=self.width,
            height=self.height,
            max_bounces=min(perf.max_bounces, 32),
            num_lights=self.compiled.num_lights,
            enable_nee=perf.enable_next_event_estimation,
            enable_ris=perf.enable_sampling_importance_resampling,
            filter_type=int(s.camera_settings.filter_type),
            filter_width=s.camera_settings.filter_width,
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

    # -- stepping --------------------------------------------------------
    def render_sample(self, n: int = 1):
        """Trace n progressive samples, accumulating into state. On the
        packed backends n > 1 merges up to k samples into one wave of k*N
        lanes; brute force and the wide backend batch single-sample waves
        (so the AOVs are the last sample's, as in the JAX package)."""
        cfg = self.wave_config()
        params = self.frame_params()
        ids = self.pixel_ids
        if (n > 1 and cfg.traversal in PACKED_BACKENDS
                and params.get("selected_pixel") is None):
            k_max = max(1, min(MERGED_WAVE_MAX_K,
                               MERGED_WAVE_LANES // max(ids.shape[0], 1)))
            done = 0
            while done < n:
                kk = min(n - done, k_max)
                if kk == 1:
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
            def z(c=3):
                return torch.zeros((h, w, c), dtype=torch.float32,
                                   device=self.device)
            self._rt_hist_fused = dict(
                indirect=z(), moments=z(), final=z(), prev_world_pos=z(4),
                raw=z(),
                aovs=dict(albedo=z(), normal=z(), world_pos=z(4),
                          emissive=z(), diffuse_contrib=z()))
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

    def current_image(self) -> np.ndarray:
        """The display image (H, W, 3) float32 in [0, 1], on the host: the
        lit image, or the debug view settings.output_type selects."""
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
