"""Settings model: the dataclass mirror of the reference's OutputSettings tree.

The reference keeps a single `OutputSettings` struct tree as the source of
truth for every runtime knob (TracerBoy/TracerBoy.h:212-360, defaults in
GetDefaultOutputSettings at TracerBoy.h:290-360), diffs it per frame to decide
history invalidation (TracerBoy.cpp:2163-2186), and ships it to shaders as
root constants. Here the same tree is a frozen (hashable) dataclass. A copy of
tracerboy_tpu/utils/config.py, so both packages read the same settings.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field


class RenderMode(enum.IntEnum):
    # TracerBoy/TracerBoy.h:185-190
    UNBIASED = 0
    REAL_TIME = 1


class OutputType(enum.IntEnum):
    # TracerBoy/TracerBoy.h:171-183 (10 AOVs)
    LIT = 0
    ALBEDO = 1
    NORMAL = 2
    DEPTH = 3
    MOTION_VECTORS = 4
    LUMINANCE = 5
    VARIANCE = 6
    LIVE_PIXELS = 7
    LIVE_WAVES = 8
    HEATMAP = 9


class FilterType(enum.IntEnum):
    # SharedShaderStructs.h FILTER_TYPE_*
    BOX = 0
    TRIANGLE = 1
    GAUSSIAN = 2


class TonemapType(enum.IntEnum):
    # Tonemap.h TONEMAP_TYPE_*
    REINHARD = 0
    ACES = 1
    CLAMP = 2
    UNCHARTED = 3
    KHRONOS_PBR_NEUTRAL = 4
    AGX = 5
    AGX_PUNCHY = 6
    GT = 7


class UpscalerType(enum.IntEnum):
    """Vendor-neutral upscaler/denoiser selection.

    The reference switches between XeSS/DLSS/DML-SuperRes/OIDN/FSR
    (TracerBoy.cpp:3247-3337); we keep the capability set with open
    implementations: an OIDN-style UNet and an EASU/RCAS-style
    upscaler.
    """

    NONE = 0
    OIDN = 1
    FSR = 2
    SUPER_RES = 3


@dataclass(frozen=True)
class DebugSettings:
    # TracerBoy/TracerBoy.h DebugSettings
    visualize_rays: bool = False
    selected_pixel: tuple = (-1, -1)
    time_limit_seconds: float = -1.0
    sample_limit: int = 0  # 0 = unlimited
    debug_value: float = 0.0
    debug_value2: float = 0.0


@dataclass(frozen=True)
class CameraSettings:
    # TracerBoy/TracerBoy.h CameraOutputSettings
    movement_speed: float = 1.0
    dof_focus_distance: float = 0.0  # 0 disables depth of field
    dof_aperture_width: float = 0.01
    filter_width: float = 1.0
    filter_type: FilterType = FilterType.BOX
    # Cross-pixel reconstruction splat (pbrt-style): each sample lands
    # in its 2x2 pixel-center neighborhood with partition-of-unity tent
    # weights instead of weighting within its own pixel only (the
    # reference's in-pixel scheme, kernel.glsl:1843-1868). ~2.25x
    # effective samples per pixel for smooth content at a tent's worth
    # of reconstruction blur; converged goldens must be rendered with
    # the same filter. Merged full-film waves only.
    filter_splat: bool = False


@dataclass(frozen=True)
class PostProcessSettings:
    # TracerBoy/TracerBoy.h PostProcessSettings
    exposure_multiplier: float = 1.0
    enable_auto_exposure: bool = True
    enable_gamma_correction: bool = True
    tonemap_type: TonemapType = TonemapType.GT


@dataclass(frozen=True)
class DenoiserSettings:
    # TracerBoy/TracerBoy.h DenoiserSettings
    enabled: bool = True
    wavelet_iterations: int = 4
    normal_weight_exponent: float = 128.0
    intersection_position_weight_exponent: float = 1.0
    luminance_weight: float = 4.0
    max_z: float = 10000.0
    # Optional Catmull-Rom TAA history resampling
    # (TemporalAccumulationCS.hlsl:24-72); sharper history under motion
    # at the cost of 9 gathers per TAA pass.
    taa_catmull_rom: bool = False


@dataclass(frozen=True)
class PerformanceSettings:
    # TracerBoy/TracerBoy.h PerformanceSettings
    sample_target: int = 256
    max_bounces: int = 6
    min_convergence: float = 0.001
    target_frame_rate: float = 30.0
    use_blue_noise: bool = True
    enable_next_event_estimation: bool = True
    enable_sampling_importance_resampling: bool = False
    enable_adaptive_sampling: bool = False
    enable_normal_maps: bool = True  # perFrameConstants.EnableNormalMaps
    convergence_percent_pad: float = 0.05
    # Environment NEE with MIS (no reference analog — kernel.glsl
    # reaches the env only through escaped BSDF rays). "auto" enables
    # it when the environment is the scene's ONLY light (num_lights ==
    # 0), where escape-only sampling is the dominant variance; "on" /
    # "off" force it. Unbiased either way (balance-heuristic MIS).
    environment_nee: str = "auto"
    # Env-NEE samples per diffuse-capable vertex (1..8). Interiors under
    # env light (vw-van) are dominated by binary-visibility variance in
    # the direct term; M occlusion feelers per vertex cut it ~1/M for
    # the cheapest ray class traced (any-hit). Multi-sample balance
    # heuristic keeps the estimator unbiased for any M
    # (trace/wavefront.py env-NEE block).
    environment_nee_samples: int = 1
    # Phase<->light MIS at volume scatter vertices (balance-weighted
    # NEE + phase-sampled light hits; trace/wavefront.py). False = the
    # NEE-only volume estimator (rounds 1-4); both are unbiased.
    volume_light_mis: bool = True
    # Sample-stream generator: "pcg" (independent hash randoms +
    # blue-noise/Halton CP on the primary streams — the reference's
    # scheme, RayGenCommon.h:49-122) or "sobol" (padded Owen-scrambled
    # Sobol (0,2) pairs on every stream — the sampler the bundled
    # scenes declare and the low-spp variance winner).
    sampler: str = "pcg"
    # Transmissive shadow rays: glass attenuates NEE shadow feelers with
    # a per-interface Fresnel factor instead of hard-occluding — the
    # reference's parked SHADOW_BOUNCES design (kernel.glsl:1447-1512,
    # disabled at 1479) made to work. Straight-line approximation; off
    # by default for reference-parity transport.
    transparent_shadows: bool = False
    # Wavefront-specific (no reference analog): rays processed per wave and
    # whether pools are compacted between bounces.
    enable_ray_compaction: bool = True
    fixed_wave_size: int = 0  # 0 = whole image per wave


@dataclass(frozen=True)
class OutputSettings:
    render_mode: RenderMode = RenderMode.UNBIASED
    output_type: OutputType = OutputType.LIT
    camera_settings: CameraSettings = field(default_factory=CameraSettings)
    post_settings: PostProcessSettings = field(default_factory=PostProcessSettings)
    denoiser_settings: DenoiserSettings = field(default_factory=DenoiserSettings)
    performance_settings: PerformanceSettings = field(
        default_factory=PerformanceSettings
    )
    debug_settings: DebugSettings = field(default_factory=DebugSettings)
    fireflies_clamp: float = 0.0  # 0 disables firefly clamping
    upscaler: UpscalerType = UpscalerType.NONE

    def replace(self, **kwargs) -> "OutputSettings":
        return dataclasses.replace(self, **kwargs)


def default_output_settings() -> OutputSettings:
    """Defaults matching TracerBoy::GetDefaultOutputSettings."""
    return OutputSettings()


def invalidates_history(old: OutputSettings, new: OutputSettings) -> bool:
    """Whether a settings change discards accumulated samples.

    Mirrors TracerBoy::UpdateOutputSettings (TracerBoy.cpp:2163-2186): camera
    optics, bounce counts, filters and render-mode changes restart
    accumulation; pure post-processing changes do not.
    """
    if old.render_mode != new.render_mode:
        return True
    if old.camera_settings != new.camera_settings:
        return True
    p_old, p_new = old.performance_settings, new.performance_settings
    if (
        p_old.max_bounces != p_new.max_bounces
        or p_old.use_blue_noise != p_new.use_blue_noise
        or p_old.enable_next_event_estimation != p_new.enable_next_event_estimation
        or p_old.enable_sampling_importance_resampling
        != p_new.enable_sampling_importance_resampling
    ):
        return True
    if old.fireflies_clamp != new.fireflies_clamp:
        return True
    return False
