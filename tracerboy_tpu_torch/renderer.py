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

Unbiased mode only; sharding, realtime and adaptive sampling are not
ported yet.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from tracerboy_tpu_torch.core import rng as tbrng
from tracerboy_tpu_torch.core.tonemap import _luma
from tracerboy_tpu_torch.post.pipeline import post_process, resolve_accumulator
from tracerboy_tpu_torch.scene.compile import CompiledScene, load_scene
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
)

BRUTE_FORCE_MAX_TRIS = 2048
MERGED_WAVE_LANES = 8_388_608   # lane cap of one merged wave
MERGED_WAVE_MAX_K = 48          # samples per merged wave


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
        if self.settings.render_mode != RenderMode.UNBIASED:
            raise NotImplementedError(
                "realtime mode is not ported yet (ROADMAP.md, Queue 1)")
        if self.settings.performance_settings.enable_adaptive_sampling:
            raise NotImplementedError(
                "adaptive sampling is not ported yet (ROADMAP.md, Queue 1)")
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
        self.state = self.make_state()
        self._start_time = time.time()

    @staticmethod
    def _pick_traversal(scene: CompiledScene) -> str:
        """Brute force for tiny scenes (no traversal beats testing every
        triangle there), the traversal kernels otherwise."""
        if scene.tri_v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
            return "brute"
        return "kernel"

    def make_state(self) -> RenderState:
        def zeros():
            return torch.zeros((self.height, self.width, 4),
                               dtype=torch.float32, device=self.device)

        return RenderState(accum=zeros(), accum_jittered=zeros(),
                           world_pos=[zeros(), zeros()], spp=0)

    def wave_config(self) -> WaveConfig:
        s = self.settings
        perf = s.performance_settings
        mats = self.compiled.materials
        ttype = self.compiled.tex_records["ttype"]
        if s.camera_settings.filter_splat:
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

    def frame_params(self) -> dict:
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
        return p

    # -- stepping --------------------------------------------------------
    def render_sample(self, n: int = 1):
        """Trace n progressive samples, accumulating into state. On the
        packed backends n > 1 merges up to k samples into one wave of k*N
        lanes; brute force loops over single-sample waves."""
        cfg = self.wave_config()
        params = self.frame_params()
        ids = self.pixel_ids
        if (n > 1 and cfg.traversal != "brute"
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
        st.accum = st.accum + sample
        # Jittered accumulator: first sample/batch always, then a
        # per-pixel coin flip (RayGenCommon.h:719-727).
        coin = tbrng.uniform(self.pixel_ids, st.spp, 0,
                             tbrng.STREAM_ACCUM_JITTER).reshape(h, w)
        take = coin < 0.5 if st.spp != 0 else torch.ones_like(coin,
                                                              dtype=bool)
        st.accum_jittered = torch.where(take[..., None],
                                        st.accum_jittered + sample,
                                        st.accum_jittered)
        st.world_pos[st.spp % 2] = torch.cat(
            [out["world_pos"].reshape(h, w, 3),
             out["neighbor_dist"].reshape(h, w, 1)], dim=-1)
        st.spp += samples
        self.rays_traced += int(out["rays_traced"])
        self._last_aovs = out

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
