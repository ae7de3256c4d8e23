"""Wavefront path-tracing integrator (tracerboy_tpu/trace/wavefront.py).

The reference's megakernel bounce loop (TracerBoy/kernel.glsl:1277-1776)
and its PathTrace epilogue (kernel.glsl:1805-1925) as a flat ray pool
that advances through uniform stages per bounce: russian roulette ->
closest hit -> miss/env record -> material fetch -> NEE with a shadow
any-hit wave -> BSDF sample -> environment NEE (WaveConfig.env_nee: M
directions toward the dome in one shadow wave of M x lanes rays) ->
throughput update, with lane masks in place of branches. Subsurface media (the wax sphere) are a per-ray state
machine inside the same bounce loop.

Alpha cutouts (WaveConfig.has_alpha) follow the JAX package: no callback
into traversal, but a re-fire of the whole wave from just past each hit
whose alpha is under ALPHA_CUTOFF, up to WaveConfig.alpha_rounds times;
with cutouts, every shadow wave becomes a closest-hit march over the
shadow BVH (alpha_rounds + 1 rounds) in which only opaque hits occlude.
WaveConfig.transparent_shadows runs the same march and lets glass pass
light with a Fresnel factor (_shadow_transmittance). Normal maps
(has_normal_maps) tilt the detail normal (shade/surface.apply_normal_map).

Heterogeneous volumes (WaveConfig.has_volume; shade/volumetric.py): each
bounce delta-tracks the segment up to the closest hit (kernel 1 gives its
end) through the scene's density grid; a real collision preempts the hit
and the miss, draws a light sample weighted by the Henyey-Greenstein
phase (balance-weighted against the phase-sampled continuation with
volume_light_mis), and continues along an HG direction. Every NEE and
env-NEE shadow segment is attenuated by ratio-marched transmittance.

The estimators of the JAX package ride on the same wave: the tent splat
(filter_splat: filter weight 1, the jitter planes out, and
render_wave_merged folds them through splat_fold_tent), split planes
(split_early: radiance_early holds the contributions recorded at bounce
i <= split_early) and the per-pixel tonemapped-luma moments of the
adaptive burst (render_wave_merged(fold_var=True)).

TLAS-instanced scenes (WaveConfig.has_instances, packed backends only)
merge trace/instanced.py's closest hit into every closest-hit wave (the
alpha re-fires included), carry the hit instance to shading, which
rotates the object-space normal into world space, and OR the instanced
occluders into every shadow wave, as the JAX wave does.

Every stage mirrors its JAX counterpart line for line, so a wave can be
held against the JAX package's wave on the same inputs. Bounce 0 and the
later bounces run in one Python loop; intermediates of a bounce are
freed when it ends, so a 7.4M-lane merged wave stays a few GB.

Traversal backends (WaveConfig.traversal):
  "brute"  - every triangle, scene-order ids (trace/intersect.py);
  "kernel" - the CUDA traversal kernels (their plain twins for CPU
             tensors), packed ids (trace/traverse.py);
  "twin"   - the plain twins on any device (kernel parity runs);
  "wide"   - the lock-step walk of the scene's own 8-wide BVH in plain
             torch (traverse.traverse_wide), scene-order ids: the
             portable oracle, the JAX package's "jnp" backend.
On the packed backends two opt-in paths replace the whole-tree kernels,
as in the JAX package: WaveConfig.cut sends every closest-hit and shadow
wave through the binned-subtree pipeline (trace/cut.py), and
WaveConfig.binned_bounces sends the closest-hit waves after the primary
one through the binned-cluster backend (trace/binned.py); with both,
binned takes the bounces and cut the primary and shadow waves. The
HEATMAP view's primary wave (WaveConfig.want_heatmap) takes the stats
kernel, traverse.closest_hit_stats, on either path.

First-hit AOVs (always built, as the JAX default want_aovs does): albedo,
detail normal, world position, depth, material id, emissive (the environment's
contribution for primary misses), diffuse contribution, neighbour
distance and the traversal-cost heatmap, plus the selected pixel's
(max_bounces, 8) path record viz_rays. They are kept for the first
aov_lanes lanes only, so a k-sample merged wave carries them for one
sample, not for k.

WaveConfig.decouple_albedo (RealTime mode, the demodulated denoise) traces
two radiance planes: "radiance" with the first hit's albedo taken as
white and without the first hit's emission and the primary misses'
environment (those ride the emissive AOV), and "radiance_d", the share of
it that the first hit's albedo modulates, so that
albedo * D + (I - D) + E is the plain radiance of the sample.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tracerboy_tpu_torch.core import rng as tbrng
from tracerboy_tpu_torch.core import vec3 as v3
from tracerboy_tpu_torch.core.vec3 import V3
from tracerboy_tpu_torch.scene.materials import (
    HAIR_FLAG,
    LIGHT_FLAG,
    METALLIC_FLAG,
    NO_SPECULAR_FLAG,
    SINGLE_SIDED_FLAG,
    SUBSURFACE_SCATTER_FLAG,
)
from tracerboy_tpu_torch.shade import bsdf
from tracerboy_tpu_torch.shade.env import sample_environment_quad_soa
from tracerboy_tpu_torch.shade.nee import sample_one_light_soa
from tracerboy_tpu_torch.shade.surface import (
    apply_normal_map,
    eval_texture,
    fetch_material_soa,
)
from tracerboy_tpu_torch.shade.volumetric import (
    delta_track,
    hg_pdf,
    sample_hg,
    transmittance,
)
from tracerboy_tpu_torch.trace import binned, cut, traverse
from tracerboy_tpu_torch.trace.camera import generate_primary_rays_soa
from tracerboy_tpu_torch.trace.instanced import instanced_closest
from tracerboy_tpu_torch.trace.intersect import (
    BIG,
    brute_force_anyhit_soa,
    brute_force_closest_soa,
)

EPSILON = 1e-4
MIN_BOUNCES_BEFORE_RR = 2  # kernel.glsl:1276-1277
PACKED_BACKENDS = ("kernel", "twin")


@dataclass(frozen=True)
class WaveConfig:
    """Static integrator configuration (the JAX package's WaveConfig).

    Energy-based lobe selection is always on, as the JAX renderer runs
    it; russian roulette can be switched off (the demodulation identity
    is exact per sample only without it)."""

    width: int
    height: int
    max_bounces: int = 6
    num_lights: int = 0
    enable_nee: bool = True
    enable_ris: bool = False
    filter_type: int = 0
    filter_width: float = 1.0
    use_blue_noise: bool = True
    sampler: str = "pcg"
    has_env: bool = True
    traversal: str = "kernel"
    has_mix: bool = True
    has_textures: bool = True
    has_emissive_tex: bool = True
    has_specular_tex: bool = True
    has_image_tex: bool = True
    has_scale_tex: bool = True
    cut: bool = False
    cut_k: int = 8
    binned_bounces: bool = False
    want_heatmap: bool = False
    decouple_albedo: bool = False
    leaf_size: int = 4          # of the scene's own BVH ("wide" backend)
    use_russian_roulette: bool = True
    # Environment NEE with balance-heuristic MIS: env_nee_samples (M, at
    # most 8) cosine directions toward the dome per diffuse-capable
    # vertex, traced as ONE concatenated shadow wave of M x lanes rays.
    env_nee: bool = False
    env_nee_samples: int = 1
    # Alpha-tested transparency (_closest_dispatch, _occluded_dispatch):
    # re-fires of a closest-hit wave past cut hits.
    has_alpha: bool = False
    alpha_rounds: int = 3
    # Transmissive shadow rays (_shadow_transmittance): the extra
    # closest-hit rounds of a transmittance march.
    transparent_shadows: bool = False
    shadow_glass_rounds: int = 3
    has_normal_maps: bool = False
    # TLAS/BLAS instancing (trace/instanced.py).
    has_instances: bool = False
    # Cross-pixel tent splat: the in-pixel filter weight is 1 and the wave
    # returns the jitter planes, which render_wave_merged's fold splats
    # into the 2x2 neighbourhood (splat_fold_tent).
    filter_splat: bool = False
    # Contribution-depth split: >= 0 adds radiance_early, the
    # contributions recorded at bounce iterations i <= split_early; the
    # late plane is radiance - radiance_early of the same samples.
    split_early: int = -1
    # Heterogeneous volume (shade/volumetric.py): the walk's step cap
    # (at most 128: the RNG packs the step as (bounce << 7) + step), the
    # ratio-marching samples of a shadow segment, and phase/light MIS at
    # volume vertices (False: the NEE-only estimator).
    has_volume: bool = False
    volume_steps: int = 64
    volume_shadow_steps: int = 8
    volume_light_mis: bool = True


def _check_supported(cfg: WaveConfig, params: dict):
    if cfg.has_volume and cfg.volume_steps > 128:
        raise ValueError(
            f"volume_steps={cfg.volume_steps} > 128 would alias per-bounce "
            "volume RNG streams")
    if cfg.env_nee and not 1 <= cfg.env_nee_samples <= 8:
        raise ValueError("env_nee_samples must be 1..8 (the streams "
                         "STREAM_ENV_NEE_X bound it)")
    if cfg.traversal not in ("brute", "wide") + PACKED_BACKENDS:
        raise ValueError(f"unknown traversal backend {cfg.traversal!r}")
    if cfg.has_instances and cfg.traversal not in PACKED_BACKENDS:
        raise ValueError("TLAS instancing needs a packed backend (the "
                         "objects' BVHs are packed tables)")


def _closest(scene, o, d, t_max, cfg, primary=False, cost_lanes=0,
             shadow=False):
    """One closest-hit wave: (t, tri id, u, v, cost). cost is the
    heatmap AOV of the first cost_lanes lanes as the JAX package defines
    it: the triangle count on brute force, pops + clusters of the stats
    kernel on the HEATMAP view's primary wave; None for 0 lanes and on
    the other paths (whose heatmap is 0). With shadow the packed
    backends walk the shadow BVH (ids into pk_sh_attr_rows), under
    cfg.cut its cut tables, and never the binned backend; brute force
    and "wide" always intersect the whole scene."""
    if cfg.traversal == "brute":
        hits = brute_force_closest_soa(o, d, scene["tri9"], t_max)
        cost = None
        if cost_lanes:
            cost = torch.full((cost_lanes,), float(scene["tri9"].shape[0]),
                              dtype=torch.float32, device=t_max.device)
        return (*hits, cost)
    if cfg.traversal == "wide":
        t, tri, u, v, cost = traverse.traverse_wide(
            v3.to_rows(o), v3.to_rows(d), t_max, scene["bvh_lo"],
            scene["bvh_hi"], scene["bvh_children"], scene["tri_v0"],
            scene["tri_v1"], scene["tri_v2"], leaf_size=cfg.leaf_size)
        return t, tri, u, v, cost[:cost_lanes] if cost_lanes else None
    plain = cfg.traversal == "twin"
    rays = (v3.to_rows(o), v3.to_rows(d), t_max.contiguous())
    if shadow:
        if cfg.cut:
            hits = cut.traverse_binned2(
                *rays, scene["pk_sh_nodes"], scene["pk_sh_tris_bw"],
                scene["pk_sh_cut_top"], scene["pk_sh_cut_roots"],
                K=cfg.cut_k, plain=plain)
        else:
            fn = traverse.closest_hit_plain if plain else traverse.closest_hit
            hits = fn(*rays, scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
        return (*hits, None)
    tables = (scene["pk_nodes"], scene["pk_tris_bw"])
    if cfg.want_heatmap and primary:
        # Whole-tree stats kernel even with cfg.cut: the JAX package
        # leaves the cut path for the stats call too.
        fn = (traverse.closest_hit_stats_plain if plain
              else traverse.closest_hit_stats)
        t, tri, u, v, pops, clusters = fn(*rays, *tables)
        cost = None
        if cost_lanes:
            cost = (pops[:cost_lanes] + clusters[:cost_lanes]).to(
                torch.float32)
        return t, tri, u, v, cost
    if cfg.binned_bounces and not primary:
        hits = binned.binned_closest(scene, *rays, plain=plain)
    elif cfg.cut:
        hits = cut.traverse_binned2(*rays, *tables, scene["pk_cut_top"],
                                    scene["pk_cut_roots"], K=cfg.cut_k,
                                    plain=plain)
    else:
        fn = traverse.closest_hit_plain if plain else traverse.closest_hit
        hits = fn(*rays, *tables)
    return (*hits, None)


ALPHA_CUTOFF = 0.9  # SharedHitGroup.h:163


def _alpha_at_hit(scene, tri, u, v, attr_key="tri_attr_rows"):
    """Cutout alpha at a hit; 1.0 where opaque / no alpha texture / miss
    (the reference's IsValidHit, SharedHitGroup.h:157-179): the
    material's alpha texture (or the albedo image's alpha channel, bound
    as a companion record at scene load) sampled at the hit's UV, with
    the JAX package's expressions in its order. attr_key names the
    attribute rows of tri's id space (scene order for brute force and
    "wide", pk_attr_rows / pk_sh_attr_rows for the packed BVHs)."""
    tbl = scene[attr_key]
    T = tbl.shape[0]
    tric = torch.clamp(tri.to(torch.int64), 0, T - 1)
    r = tbl[:, 9:16][tric]          # the uv and material columns only
    rows = [r[:, j] for j in range(7)]
    del r
    w_b = 1.0 - u - v
    uv_u = rows[0] * w_b + rows[2] * u + rows[4] * v
    uv_v = rows[1] * w_b + rows[3] * u + rows[5] * v
    mid = torch.round(rows[6]).to(torch.int64)
    del rows, w_b
    mats = scene["materials"]
    M = mats["alpha_tex"].shape[0]
    atex = mats["alpha_tex"][torch.clamp(mid, 0, M - 1)]
    a = eval_texture(
        scene["tex_records"], scene["tex_images"], scene["tex_sizes"],
        torch.clamp_min(atex, 0), torch.stack([uv_u, uv_v], dim=-1),
    )[..., 0]
    return torch.where((tri >= 0) & (atex >= 0), a, 1.0)


def _instanced(scene, o, d, t_max, cfg):
    """trace/instanced.py's closest hit of the rays (V3) against the
    instanced geometry: (t, tri, u, v, inst)."""
    return instanced_closest(scene, v3.to_rows(o), v3.to_rows(d),
                             t_max.contiguous(),
                             plain=cfg.traversal == "twin")


def _closest_once(scene, o, d, t_max, cfg, primary=False, cost_lanes=0):
    """_closest, and on a TLAS scene the instanced closest hit merged in
    (the JAX _closest_once): (t, tri, u, v, cost, inst), inst the hit
    instance (-1 for a flat hit or a miss)."""
    t, tri, u, v, cost = _closest(scene, o, d, t_max, cfg, primary=primary,
                                  cost_lanes=cost_lanes)
    inst = torch.full_like(tri, -1)
    if cfg.has_instances:
        t2, tri2, u2, v2, in2 = _instanced(scene, o, d,
                                           torch.minimum(t_max, t), cfg)
        take = (tri2 >= 0) & (t2 < t)
        t = torch.where(take, t2, t)
        tri = torch.where(take, tri2, tri)
        u = torch.where(take, u2, u)
        v = torch.where(take, v2, v)
        inst = torch.where(take, in2, inst)
        del t2, tri2, u2, v2, in2, take
    return t, tri, u, v, cost, inst


def _closest_dispatch(scene, o, d, t_max, cfg, primary=False,
                      cost_lanes=0):
    """Closest hit with alpha-tested transparency (the JAX
    _closest_dispatch): hits whose alpha is under ALPHA_CUTOFF re-fire
    the whole wave from just past the hit, up to cfg.alpha_rounds times;
    a re-fire is never a primary wave (on the binned path it takes the
    binned backend). Returns _closest_once's tuple with t measured from
    o."""
    t, tri, u, v, cost, inst = _closest_once(
        scene, o, d, t_max, cfg, primary=primary, cost_lanes=cost_lanes)
    if not cfg.has_alpha:
        return t, tri, u, v, cost, inst
    attr_key = ("pk_attr_rows" if cfg.traversal in PACKED_BACKENDS
                else "tri_attr_rows")
    o_cur = o
    t_base = torch.zeros_like(t_max)
    for _ in range(cfg.alpha_rounds):
        a = _alpha_at_hit(scene, tri, u, v, attr_key)
        reject = (tri >= 0) & (a < ALPHA_CUTOFF)
        del a
        step = t + 1e-4 + 1e-4 * torch.abs(t)
        o_cur = v3.where(reject, o_cur + d * step, o_cur)
        t_base = torch.where(reject, t_base + step, t_base)
        tm2 = torch.where(reject, torch.clamp_min(t_max - t_base, 0.0), 0.0)
        del step
        t2, tri2, u2, v2, c2, in2 = _closest_once(
            scene, o_cur, d, tm2, cfg,
            cost_lanes=0 if cost is None else cost.shape[0])
        del tm2
        t = torch.where(reject, t2, t)
        tri = torch.where(reject, tri2, tri)
        u = torch.where(reject, u2, u)
        v = torch.where(reject, v2, v)
        inst = torch.where(reject, in2, inst)
        if cost is not None and c2 is not None:
            cost = cost + torch.where(reject[:cost.shape[0]], c2, 0.0)
        del t2, tri2, u2, v2, c2, in2, reject
    return t + t_base, tri, u, v, cost, inst


def _instanced_occluders(scene, o, d, t_max, cfg):
    """Lanes whose shadow ray hits instanced geometry (the JAX wave's
    instanced occluders: conservative, instanced emissive shapes block
    too; they are not part of the shadow BVH); None on a flat scene."""
    if not cfg.has_instances:
        return None
    return _instanced(scene, o, d, t_max, cfg)[1] >= 0


def _occluded_dispatch(scene, o, d, t_max, cfg):
    """Shadow-ray occlusion with alpha-tested transparency (the JAX
    _occluded_dispatch). Without cutouts a pure any-hit wave; with them
    occlusion needs hit points to sample alpha, so it marches closest
    hits (over the shadow BVH on the packed backends) for
    cfg.alpha_rounds + 1 rounds and only opaque hits occlude; brute force
    and "wide" treat light triangles as pass-through. On a TLAS scene the
    instanced occluders are OR-ed in."""
    occ_inst = _instanced_occluders(scene, o, d, t_max, cfg)
    if not cfg.has_alpha:
        occ = _occluded(scene, o, d, t_max, cfg)
        return occ if occ_inst is None else occ | occ_inst
    packed = cfg.traversal in PACKED_BACKENDS
    attr_key = "pk_sh_attr_rows" if packed else "tri_attr_rows"
    shadow_opaque = scene["tri_shadow_opaque"]
    occluded = t_max < 0  # all False
    o_cur = o
    t_base = torch.zeros_like(t_max)
    budget = t_max
    for _ in range(cfg.alpha_rounds + 1):
        t, tri, u, v, _ = _closest(scene, o_cur, d, budget, cfg,
                                   shadow=packed)
        hit = tri >= 0
        solid = _alpha_at_hit(scene, tri, u, v, attr_key) >= ALPHA_CUTOFF
        if not packed:
            T = shadow_opaque.shape[0]
            solid = solid & shadow_opaque[
                torch.clamp(tri.to(torch.int64), 0, T - 1)]
        occluded = occluded | (hit & solid)
        reject = hit & ~solid & ~occluded
        step = t + 1e-4 + 1e-4 * torch.abs(t)
        o_cur = v3.where(reject, o_cur + d * step, o_cur)
        t_base = torch.where(reject, t_base + step, t_base)
        budget = torch.where(reject, torch.clamp_min(t_max - t_base, 0.0),
                             0.0)
        del t, tri, u, v, hit, solid, reject, step
    return occluded if occ_inst is None else occluded | occ_inst


def _shadow_transmittance(scene, o, d, t_max, cfg):
    """Shadow-ray transmittance (the JAX _shadow_transmittance, the
    reference's parked SHADOW_BOUNCES march, kernel.glsl:1447-1512, made
    to work): a straight-line closest-hit march in which zero-scatter
    subsurface surfaces (glass) multiply (1 - Schlick(cos)) per interface
    and the ray goes on, light geometry and alpha cutouts pass, and
    anything else stops it at zero; a pass still open after
    cfg.shadow_glass_rounds + 1 rounds counts as occluded. Returns the
    transmittance in [0, 1] per lane."""
    packed = cfg.traversal in PACKED_BACKENDS
    attr_key = "pk_sh_attr_rows" if packed else "tri_attr_rows"
    shadow_opaque = scene["tri_shadow_opaque"]
    mats = scene["materials"]
    n_mat = mats["flags"].shape[0]
    tbl = scene[attr_key]
    T = torch.ones_like(t_max)
    o_cur = o
    t_base = torch.zeros_like(t_max)
    budget = t_max
    for _ in range(cfg.shadow_glass_rounds + 1):
        t, tri, u, v, _ = _closest(scene, o_cur, d, budget, cfg,
                                   shadow=packed)
        hit = tri >= 0
        tric = torch.clamp(tri.to(torch.int64), 0, tbl.shape[0] - 1)
        rows = tbl[:, [0, 1, 2, 15]][tric]   # flat normal, material id
        mid = torch.clamp(rows[:, 3].to(torch.int64), 0, n_mat - 1)
        flags = mats["flags"][mid]
        scat = mats["scattering"][mid].amax(-1)
        is_glass = ((flags & SUBSURFACE_SCATTER_FLAG) != 0) & (scat < 1e-6)
        is_light = (flags & LIGHT_FLAG) != 0
        if not packed:
            # Brute force and "wide" intersect the full table; lights are
            # pass-through there too (the IsLight skip).
            is_light = is_light | ~shadow_opaque[
                torch.clamp(tri.to(torch.int64), 0,
                            shadow_opaque.shape[0] - 1)]
        if cfg.has_alpha:
            cutout = _alpha_at_hit(scene, tri, u, v, attr_key) < ALPHA_CUTOFF
        else:
            cutout = hit & False
        # Fresnel transmission at the interface (Schlick from the
        # material IOR; cos against the flat shading normal row).
        ior = mats["ior"][mid]
        nrm = V3(rows[:, 0], rows[:, 1], rows[:, 2])
        cos_i = torch.abs(v3.dot(d, nrm))
        r0 = torch.square((ior - 1.0) / torch.clamp_min(ior + 1.0, 1e-6))
        fres = r0 + (1.0 - r0) * torch.pow(1.0 - cos_i, 5.0)
        passes = hit & (is_glass | is_light | cutout)
        T = torch.where(hit & is_glass & ~is_light, T * (1.0 - fres), T)
        T = torch.where(hit & ~passes, 0.0, T)
        step = t + 1e-4 + 1e-4 * torch.abs(t)
        cont = passes & (T > 1e-4)
        o_cur = v3.where(cont, o_cur + d * step, o_cur)
        t_base = torch.where(cont, t_base + step, t_base)
        budget = torch.where(cont, torch.clamp_min(t_max - t_base, 0.0), 0.0)
        del t, tri, u, v, rows, tric, mid, flags, scat, fres, cos_i, step
    # A surviving pass at the round limit is treated as occluded
    # (conservative, like the alpha loop's bounded re-fires).
    T = torch.where(budget > 0.0, 0.0, T)
    occ_inst = _instanced_occluders(scene, o, d, t_max, cfg)
    return T if occ_inst is None else torch.where(occ_inst, 0.0, T)


def _shadow(scene, o, d, t_max, cfg):
    """A shadow wave as the NEE stages use it: (occluded, transmittance),
    transmittance None unless cfg.transparent_shadows."""
    if cfg.transparent_shadows:
        trans = _shadow_transmittance(scene, o, d, t_max, cfg)
        return trans <= 1e-4, trans
    return _occluded_dispatch(scene, o, d, t_max, cfg), None


def _occluded(scene, o, d, t_max, cfg):
    """One shadow wave. The packed backends traverse the shadow BVH,
    which holds no light triangles; brute force masks them out."""
    if cfg.traversal == "brute":
        return brute_force_anyhit_soa(o, d, scene["tri9"], t_max,
                                      tri_opaque=scene["tri_shadow_opaque"])
    if cfg.traversal == "wide":
        return traverse.traverse_wide(
            v3.to_rows(o), v3.to_rows(d), t_max, scene["bvh_lo"],
            scene["bvh_hi"], scene["bvh_children"], scene["tri_v0"],
            scene["tri_v1"], scene["tri_v2"], leaf_size=cfg.leaf_size,
            any_hit=True, tri_mask=scene["tri_shadow_opaque"])
    plain = cfg.traversal == "twin"
    rays = (v3.to_rows(o), v3.to_rows(d), t_max.contiguous())
    tables = (scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
    if cfg.cut:
        return cut.anyhit_binned2(*rays, *tables, scene["pk_sh_cut_top"],
                                  scene["pk_sh_cut_roots"], K=cfg.cut_k,
                                  plain=plain)
    fn = traverse.anyhit_plain if plain else traverse.any_hit
    return fn(*rays, *tables)


def _env_nee(scene, cfg, s, i, hash1, hash2, env_h, env_w, *, base,
             shading, hit_point, normal, detail_normal, prev_dir, albedo,
             roughness, refl_coef, allows_spec, is_metal, p_spec):
    """Environment NEE at one vertex (tracerboy_tpu/trace/wavefront.py
    env_nee): M = cfg.env_nee_samples cosine directions about the detail
    normal, occlusion of all M in ONE concatenated shadow wave, and the
    full BSDF times the environment, each sample weighted by the
    multi-sample balance heuristic M p / (M p + p_bsdf) and averaged; in
    a volume scene each sample's segment is attenuated by the
    ratio-marched transmittance. Adds to s["radiance"] (and s["rad_d"],
    s["rad_early"]) and s["rays_traced"]; returns the lanes that traced
    at least one env sample (do_env)."""
    M = cfg.env_nee_samples
    dirs, pdfs = [], []
    for j in range(M):
        stream = (tbrng.STREAM_ENV_NEE if j == 0
                  else tbrng.STREAM_ENV_NEE_X + 2 * (j - 1))
        r0, r1 = hash2(i, stream)
        d_j, p_j = bsdf.sample_cosine_hemisphere_soa(detail_normal, r0, r1)
        dirs.append(d_j)
        pdfs.append(p_j)
    do_envs = [base & (p_j > EPSILON) for p_j in pdfs]
    do_env = do_envs[0]
    for d_j in do_envs[1:]:
        do_env = do_env | d_j
    s["rays_traced"] = s["rays_traced"] + sum(d_j.sum() for d_j in do_envs)
    N = hit_point.x.shape[0]
    org = hit_point + normal * EPSILON
    occ, trans = _shadow(
        scene,
        V3(*(c.repeat(M) for c in org)),
        V3(*(torch.cat([d_j[k] for d_j in dirs]) for k in range(3))),
        torch.cat([torch.where(d_j, BIG, 0.0) for d_j in do_envs]), cfg)

    zero = torch.zeros_like(hit_point.x)
    contrib_sum = _zero3(zero)
    contrib_d_sum = _zero3(zero)
    add_any = torch.zeros_like(do_env)
    one_minus_in = 1.0 - torch.pow(1.0 - 0.5 * v3.dot(-prev_dir, normal), 5.0)
    for j in range(M):
        env_dir, env_pdf = dirs[j], pdfs[j]
        # BSDF pdf of the env direction under the throughput update's
        # mixed-lobe model (the balance denominator mirrors the escape
        # estimator's pdf).
        e_half = bsdf.half_vector_safe_soa(-prev_dir, env_dir, detail_normal)
        e_dpdf = torch.clamp_min(v3.dot(env_dir, detail_normal), 0.0) / bsdf.PI
        e_spdf = bsdf.ggx_reflection_pdf_soa(detail_normal, env_dir, e_half,
                                             roughness)
        e_bsdf_pdf = torch.where(
            allows_spec,
            torch.where(is_metal, e_spdf,
                        p_spec * e_spdf + (1.0 - p_spec) * e_dpdf),
            e_dpdf)
        w_env = (M * env_pdf) / torch.clamp_min(M * env_pdf + e_bsdf_pdf,
                                                1e-12)
        # The full BSDF at env_dir: metal / plastic / lambert.
        e_spec_w = bsdf.specular_weight_soa(prev_dir, env_dir, normal,
                                            detail_normal, roughness)
        e_cos = torch.clamp(v3.dot(env_dir, normal), 0.0, 1.0)
        e_fres = refl_coef + (1.0 - refl_coef) * torch.pow(
            torch.abs(1.0 - v3.dot(-prev_dir, e_half)), 5.0)
        e_dm = ((28.0 / (23.0 * bsdf.PI)) * (1.0 - refl_coef) * one_minus_in
                * (1.0 - torch.pow(1.0 - 0.5 * v3.dot(env_dir, normal), 5.0)))
        fs = e_fres * e_spec_w
        e_mult = v3.where(
            is_metal, albedo * (e_spec_w * e_cos),
            v3.where(allows_spec,
                     V3((albedo.x * e_dm + fs) * e_cos,
                        (albedo.y * e_dm + fs) * e_cos,
                        (albedo.z * e_dm + fs) * e_cos),
                     albedo * e_dpdf))
        e_add = do_envs[j] & ~occ[j * N:(j + 1) * N]
        add_any = add_any | e_add
        e_env = sample_environment_quad_soa(
            env_dir, scene["env_quad"], env_h, env_w, scene["env_transform"],
            scene["env_color_scale"], gather_mask=e_add)
        e_gain = (w_env * (1.0 / M)) / torch.clamp_min(env_pdf, 1e-12)
        if trans is not None:
            e_gain = e_gain * trans[j * N:(j + 1) * N]
        e_contrib = s["throughput"] * e_mult * e_env * e_gain
        if cfg.has_volume:
            # The opaque-BVH occlusion test alone would add the full env
            # radiance through the medium: attenuate the env shadow
            # segment as NEE does.
            e_contrib = e_contrib * transmittance(
                scene, org, env_dir, torch.where(do_envs[j], BIG, 0.0),
                do_envs[j], hash1(i, tbrng.STREAM_ENV_NEE_SHADOW),
                cfg.volume_shadow_steps)
        e_contrib = v3.where(e_add, e_contrib, _zero3(zero))
        contrib_sum = contrib_sum + e_contrib
        if cfg.decouple_albedo:
            # The env direction's own diffuse fraction, distinct from the
            # continuation lobe's.
            e_phi = torch.where(
                is_metal | ~allows_spec, 1.0,
                torch.clamp(e_dm / torch.clamp_min(e_dm + fs, 1e-8),
                            0.0, 1.0))
            w_ed = (torch.where(shading, e_phi, s["dc_w"]) if i == 0
                    else s["dc_w"])
            contrib_d_sum = contrib_d_sum + e_contrib * w_ed
    s["radiance"] = v3.where(add_any, s["radiance"] + contrib_sum,
                             s["radiance"])
    if i <= cfg.split_early:
        s["rad_early"] = v3.where(add_any, s["rad_early"] + contrib_sum,
                                  s["rad_early"])
    if cfg.decouple_albedo:
        s["rad_d"] = v3.where(add_any, s["rad_d"] + contrib_d_sum,
                              s["rad_d"])
    return do_env


def make_blue_noise_params(scene, pixel_ids, width: int):
    """The 6 static per-pixel blue-noise values (only their
    Cranley-Patterson rotation depends on the sample index)."""
    px = pixel_ids % width
    py = torch.div(pixel_ids, width, rounding_mode="floor")
    idx = (py % 256) * 256 + (px % 256)
    b0 = scene["blue0_t"]
    b1 = scene["blue1_t"]
    return (b0[0][idx], b0[1][idx], b0[2][idx], b0[3][idx],
            b1[2][idx], b1[3][idx])


def _zero3(z):
    return V3(z, z, z)


def _head(v: V3, n: int) -> V3:
    return V3(v.x[:n], v.y[:n], v.z[:n])


AOV_KEYS = ("albedo", "normal", "world_pos", "depth", "emissive",
            "material", "diffuse_contrib", "neighbor_dist", "heatmap")
FOLDED_AOVS = ("albedo", "normal", "emissive", "diffuse_contrib")


def render_wave(scene, params, pixel_ids, sample_index, cfg: WaveConfig,
                aov_lanes: int | None = None):
    """Trace one sample for each pixel id.

    Returns radiance (N, 3) times the filter weight (and radiance_d with
    cfg.decouple_albedo, radiance_early with cfg.split_early >= 0, the
    jitter planes jit_u, jit_v (N,) with cfg.filter_splat), filter_weight
    (N,), rays_traced, and the first
    hit's world_pos (A, 3) and neighbor_dist (A,), the distance to the hit
    of the next pixel's centre ray, which the renderer keeps as its
    world-position buffer, the other first-hit AOVs of AOV_KEYS, each
    (A, ...), and viz_rays (max_bounces, 8): per bounce the selected
    pixel's ray origin, hit point, t and a count of 1 (zeros without
    params["selected_pixel"] or where that lane is no longer alive).
    A = aov_lanes (default N): the AOVs of the first A lanes.

    scene: scene tensors (CompiledScene.as_tensors()).
    params: dict(dof_focus, dof_aperture, firefly_clamp, seed) as python
      numbers, and optionally "bn" (make_blue_noise_params),
      "selected_pixel" (a flat pixel index), "fixed_pixel_offset" (two
      numbers in [0, 1): every lane's sub-pixel jitter, RealTime mode's
      per-frame Halton offset) and "active_mask" ((N,) bool: a lane
      outside it traces nothing and returns filter weight 0).
    pixel_ids: (N,) int64 flat pixel indices.
    sample_index: python int, or (N,) int64 per-lane sample indices.
    """
    _check_supported(cfg, params)
    dev = pixel_ids.device
    N = pixel_ids.shape[0]
    na = N if aov_lanes is None else int(aov_lanes)
    lane = pixel_ids
    seed = int(params.get("seed", 0))
    if not isinstance(sample_index, torch.Tensor):
        sample_index = int(sample_index)
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros(N, **f32)
    one = torch.ones(N, **f32)
    vzero3 = _zero3(zero)
    no = torch.zeros(N, dtype=torch.bool, device=dev)

    def hash2(bounce, stream):
        return tbrng.uniform2_soa(lane, sample_index, bounce, stream, seed,
                                  cfg.sampler)

    def hash1(bounce, stream):
        return tbrng.uniform(lane, sample_index, bounce, stream, seed,
                             cfg.sampler)

    if cfg.use_blue_noise and cfg.sampler != "sobol":
        bn = params.get("bn")
        if bn is None:
            bn = make_blue_noise_params(scene, pixel_ids, cfg.width)
        shift = tbrng.halton23(torch.as_tensor(sample_index, device=dev))

        def rot(u, k):
            return torch.remainder(u + shift[..., k], 1.0)

        jit_u, jit_v = rot(bn[0], 0), rot(bn[1], 1)
        blue_dir = (rot(bn[2], 0), rot(bn[3], 1))
        dof_u, dof_v = rot(bn[4], 0), rot(bn[5], 1)
    else:
        jit_u, jit_v = hash2(0, tbrng.STREAM_PRIMARY_JITTER)
        dof_u, dof_v = hash2(0, tbrng.STREAM_DOF)
        blue_dir = hash2(0, tbrng.STREAM_SECONDARY_DIR)

    fixed = params.get("fixed_pixel_offset")
    if fixed is not None:
        fixed = torch.as_tensor(fixed, **f32)
        jit_u = fixed[0].expand(N)
        jit_v = fixed[1].expand(N)

    # Pixel filter weight (kernel.glsl:1843-1868).
    off_u = (jit_u - 0.5) * cfg.filter_width
    off_v = (jit_v - 0.5) * cfg.filter_width
    if cfg.filter_splat:        # weights applied at the splat fold
        fw = one
    elif cfg.filter_type == 1:  # triangle
        fw = torch.clamp_min(torch.maximum(0.5 - torch.abs(off_u),
                                           0.5 - torch.abs(off_v)), 0.0)
    elif cfg.filter_type == 2:  # gaussian
        sigma = 0.8
        edge = torch.exp(torch.tensor(-0.5 / (sigma * sigma), **f32))
        gu = torch.clamp_min(
            torch.exp(-0.5 * (2 * off_u / sigma) ** 2) - edge, 0.0)
        gv = torch.clamp_min(
            torch.exp(-0.5 * (2 * off_v / sigma) ** 2) - edge, 0.0)
        fw = gu * gv
    else:
        fw = one

    cam = scene["camera"]
    origin, direction = generate_primary_rays_soa(
        cam, cfg.width, cfg.height, pixel_ids, jit_u, jit_v,
        dof_focus_distance=params.get("dof_focus", 0.0),
        dof_aperture_width=params.get("dof_aperture", 0.0),
        dof_u=dof_u, dof_v=dof_v, filter_width=cfg.filter_width,
    )
    n_origin, n_direction = generate_primary_rays_soa(
        cam, cfg.width, cfg.height, pixel_ids[:na] + 1, jit_u[:na],
        jit_v[:na], filter_width=cfg.filter_width,
    )

    env_h, env_w = scene["env_map"].shape[0], scene["env_map"].shape[1]
    # Packed backends return PACKED ids: fetch from packed-order rows.
    attr_key = ("pk_attr_rows" if cfg.traversal in PACKED_BACKENDS
                else "tri_attr_rows")   # brute force and wide: scene order
    attr_table = scene[attr_key]
    T_padded = attr_table.shape[0]

    s = dict(
        origin=origin,
        direction=direction,
        throughput=V3(one, one, one),
        radiance=vzero3,
        alive=(torch.ones(N, dtype=torch.bool, device=dev)
               if params.get("active_mask") is None
               else params["active_mask"].clone()),
        prev_perfect_specular=no,
        inside=no,
        med_absorption=vzero3,
        med_scattering=vzero3,
        med_ior=one,
        rays_traced=torch.zeros((), dtype=torch.int64, device=dev),
    )
    if cfg.split_early >= 0:
        s["rad_early"] = vzero3
        if cfg.has_env:
            s["miss_early"] = no
    if cfg.has_volume:
        # Phase pdf of the previous vertex's HG continuation (0: that
        # vertex was no volume scatter), for the phase/light MIS pair.
        s["prev_phase_pdf"] = zero
    if cfg.has_env:
        # Lazy environment: a miss records its throughput; one env fetch
        # runs after the bounce loop.
        s["env_throughput"] = vzero3
        if cfg.env_nee:
            # The escape's balance weight against the env NEE taken at
            # the previous vertex; 1 for primary, specular and medium
            # lanes.
            s["env_mis_w"] = one
    # First-hit AOVs of the first na lanes, set at bounce 0.
    za = zero[:na]
    aov = dict(
        world_pos=_zero3(za), neighbor_dist=za, albedo=_zero3(za),
        normal=_zero3(za), depth=za, emissive=_zero3(za),
        material=torch.full((na,), -1, dtype=torch.int32, device=dev),
        diffuse_contrib=one[:na], heatmap=za,
        viz_rays=torch.zeros((cfg.max_bounces, 8), **f32),
    )
    first_miss = None
    selected = params.get("selected_pixel")
    if cfg.decouple_albedo:
        # rad_d: the share of each radiance contribution that the first
        # hit's albedo modulates; dc_w: the lane's first-vertex diffuse
        # fraction (plastic dm / (dm + fs), metal and lambert 1,
        # subsurface and never shaded 0).
        s["rad_d"] = vzero3
        s["dc_w"] = zero
        first_miss_all = no

    for i in range(cfg.max_bounces):
        alive = s["alive"]

        # --- russian roulette (kernel.glsl:1288-1301) -------------------
        if cfg.use_russian_roulette and i >= MIN_BOUNCES_BEFORE_RR:
            p = torch.clamp(v3.max_c(s["throughput"]), EPSILON, 1.0)
            r = hash1(i, tbrng.STREAM_RUSSIAN_ROULETTE)
            killed = alive & (r >= p)
            survived = alive & ~killed
            alive = survived
            s["throughput"] = s["throughput"] * torch.where(
                survived, 1.0 / p, 1.0)

        alive = alive & v3.any_gt(s["throughput"], EPSILON)
        s["rays_traced"] = s["rays_traced"] + alive.sum()

        # --- traversal ---------------------------------------------------
        t_max = torch.where(alive, BIG, 0.0)
        t, tri, u, v, cost, hit_inst = _closest_dispatch(
            scene, s["origin"], s["direction"], t_max, cfg, primary=i == 0,
            cost_lanes=na if i == 0 else 0)
        del t_max

        # --- heterogeneous volume: delta-tracked medium interaction -----
        # A real collision preempts both the surface hit and the miss.
        if cfg.has_volume:
            def vrng2(k, i=i):
                ub = (i << 7) + k   # at most 128 walk steps a bounce
                return (hash1(ub, tbrng.STREAM_VOLUME),
                        hash1(ub, tbrng.STREAM_VOLUME + 1))

            t_seg = torch.where(tri >= 0, t, BIG)
            vol_scatter, t_vsc, vol_w = delta_track(
                scene, s["origin"], s["direction"], t_seg,
                alive & ~s["inside"], vrng2, cfg.volume_steps)
            del t_seg
            s["throughput"] = s["throughput"] * vol_w
            vol_point = s["origin"] + s["direction"] * t_vsc
            vh_u, vh_v = hash2(i, tbrng.STREAM_VOLUME + 2)
            vol_dir = sample_hg(s["direction"], scene["vol_g"], vh_u, vh_v)
            del vol_w, t_vsc, vh_u, vh_v
            miss = alive & (tri < 0) & ~vol_scatter
        else:
            vol_scatter = None
            miss = alive & (tri < 0)

        # --- miss: environment, recorded lazily ---------------------------
        if cfg.has_env:
            rec = s["throughput"]
            if cfg.env_nee:
                rec = rec * s["env_mis_w"]
            s["env_throughput"] = v3.where(miss, rec, s["env_throughput"])
            del rec
            if i <= cfg.split_early:
                s["miss_early"] = s["miss_early"] | miss
            if i == 0:
                first_miss = miss[:na]
                if cfg.decouple_albedo:
                    first_miss_all = miss
        alive = alive & ~miss

        # --- hit attributes ----------------------------------------------
        tric = torch.clamp(tri.to(torch.int64), 0, T_padded - 1)
        rows = attr_table[tric]                       # (N, 19)
        a = [rows[:, j] for j in range(19 if cfg.has_normal_maps else 16)]
        del rows
        w_b = 1.0 - u - v
        sh_normal = v3.normalize(V3(
            a[0] * w_b + a[3] * u + a[6] * v,
            a[1] * w_b + a[4] * u + a[7] * v,
            a[2] * w_b + a[5] * u + a[8] * v,
        ))
        if cfg.has_instances:
            # Instanced hits carry object-space normals: into world space
            # by (M^-1)^T, the columns of the world->object rows. The
            # normal-map tangent stays unrotated, as in the JAX wave.
            inv = scene["inst_inv"][torch.clamp_min(hit_inst, 0).long()]
            rot = v3.normalize(V3(
                inv[:, 0] * sh_normal.x + inv[:, 4] * sh_normal.y
                + inv[:, 8] * sh_normal.z,
                inv[:, 1] * sh_normal.x + inv[:, 5] * sh_normal.y
                + inv[:, 9] * sh_normal.z,
                inv[:, 2] * sh_normal.x + inv[:, 6] * sh_normal.y
                + inv[:, 10] * sh_normal.z))
            sh_normal = v3.where(hit_inst >= 0, rot, sh_normal)
            del inv, rot
        del hit_inst
        uv_u = a[9] * w_b + a[11] * u + a[13] * v
        uv_v = a[10] * w_b + a[12] * u + a[14] * v
        mat_id = torch.round(a[15]).to(torch.int64)
        tangent = V3(*a[16:19]) if cfg.has_normal_maps else None
        del a, w_b

        hit_point = s["origin"] + s["direction"] * t

        ray_dot_n = v3.dot(sh_normal, s["direction"])
        backside = ray_dot_n > 0.0
        mat = fetch_material_soa(
            scene, mat_id, uv_u, uv_v, backside, lane, sample_index, i,
            seed, has_mix=cfg.has_mix, has_textures=cfg.has_textures,
            has_emissive_tex=cfg.has_emissive_tex,
            has_specular_tex=cfg.has_specular_tex,
            has_image_tex=cfg.has_image_tex,
            has_scale_tex=cfg.has_scale_tex,
        )
        flags = mat["flags"]
        normal = v3.where(backside, -sh_normal, sh_normal)
        if cfg.has_normal_maps:
            detail_normal = apply_normal_map(scene, mat["normal_tex"], normal,
                                             tangent, uv_u, uv_v)
        else:
            detail_normal = normal
        del tangent
        ray_dot_n = torch.where(backside, -ray_dot_n, ray_dot_n)

        cur_ior = torch.where(backside, mat["ior"], bsdf.AIR_IOR)
        new_ior = torch.where(backside, bsdf.AIR_IOR, mat["ior"])

        # ===== medium transport (kernel.glsl:1591-1691) ==================
        in_medium = alive & s["inside"]
        mean_scat = v3.mean_c(s["med_scattering"])
        no_scatter = mean_scat < EPSILON
        dist_per_scatter = 1.0 / torch.clamp_min(mean_scat, 1e-12)
        r_fly = hash1(i, tbrng.STREAM_SSS)
        travel = torch.clamp_min(
            -torch.log(torch.clamp_min(r_fly, 1e-12)), 0.1
        ) * dist_per_scatter
        travel = torch.where(no_scatter, BIG, travel)
        scatter_event = in_medium & (travel < t) & ~no_scatter
        seg = torch.minimum(travel, t)
        beer = v3.exp(-1.0 * s["med_absorption"] * seg)
        s["throughput"] = v3.where(in_medium, s["throughput"] * beer,
                                   s["throughput"])
        med_escaped = s["inside"] & miss
        s["throughput"] = v3.where(med_escaped, vzero3, s["throughput"])

        r_s0, r_s1 = hash2(i, tbrng.STREAM_SSS + 1)
        scat_dir = bsdf.sample_uniform_sphere_soa(r_s0, r_s1)
        exit_dir, tir = bsdf.refract_or_reflect_soa(
            s["direction"], normal,
            cur_ior / torch.clamp_min(new_ior, 1e-6), ray_dot_n,
        )
        # Rough refraction: pow-lobe perturbation of the exit direction.
        r_l0, r_l1 = hash2(i, tbrng.STREAM_ROUGH_REFRACT)
        lobe_dir, lobe_pdf = bsdf.sample_pow_lobe_soa(
            exit_dir, mat["roughness"], r_l0, r_l1)
        rough_boundary = mat["roughness"] >= 0.05
        exit_dir = v3.where(rough_boundary, lobe_dir, exit_dir)
        med_exit = in_medium & ~scatter_event
        s["throughput"] = v3.where(
            med_exit & rough_boundary & (lobe_pdf < EPSILON),
            vzero3, s["throughput"])
        new_inside = torch.where(
            scatter_event, True,
            torch.where(med_exit & ~tir, False, s["inside"]))
        med_dir = v3.where(scatter_event, scat_dir, exit_dir)
        med_org = v3.where(
            scatter_event,
            s["origin"] + s["direction"] * seg,
            hit_point + v3.where(tir, normal * EPSILON, normal * -EPSILON),
        )
        del scat_dir, exit_dir, lobe_dir, lobe_pdf, travel, seg, beer

        # ===== surface shading ===========================================
        shading = alive & ~s["inside"]
        if cfg.has_volume:
            shading = shading & ~vol_scatter
        is_light = (flags & LIGHT_FLAG) != 0
        allows_spec = (flags & NO_SPECULAR_FLAG) == 0
        is_metal = ((flags & METALLIC_FLAG) != 0) | ((flags & HAIR_FLAG) != 0)
        is_sss = (flags & SUBSURFACE_SCATTER_FLAG) != 0
        single_sided = (flags & SINGLE_SIDED_FLAG) != 0

        r_spec = hash1(i, tbrng.STREAM_SPECULAR_SELECT)
        # Lobe probability by each lobe's expected energy at this
        # incidence; dielectric/SSS media keep the reference's 50/50.
        refl0 = mat["specular_coef"]
        f_i = refl0 + (1.0 - refl0) * torch.pow(
            1.0 - torch.abs(ray_dot_n), 5.0)
        alb = mat["albedo"]
        alb_avg = (alb.x + alb.y + alb.z) * (1.0 / 3.0)
        p_spec = torch.clamp(
            f_i / torch.clamp_min(f_i + (1.0 - f_i) * alb_avg, 1e-6),
            0.05, 0.95)
        p_spec = torch.where(is_sss, 0.5, p_spec)
        del refl0, f_i, alb, alb_avg
        spec_ray = allows_spec & (is_metal | (r_spec < p_spec))
        perfect_spec = spec_ray & (mat["roughness"] < 0.05)

        if i == 0 or not cfg.enable_nee:
            add_emissive = shading
        else:
            add_emissive = shading & (s["prev_perfect_specular"] | ~is_light)
        if cfg.decouple_albedo:
            # The first hit's emission rides the emissive AOV only, so
            # the composite does not count it twice.
            if i == 0:
                add_emissive = no
            s["rad_d"] = v3.where(
                add_emissive,
                s["rad_d"] + s["throughput"] * mat["emissive"] * s["dc_w"],
                s["rad_d"])
        s["radiance"] = v3.where(
            add_emissive, s["radiance"] + s["throughput"] * mat["emissive"],
            s["radiance"])
        if i <= cfg.split_early:
            s["rad_early"] = v3.where(
                add_emissive,
                s["rad_early"] + s["throughput"] * mat["emissive"],
                s["rad_early"])
        if (cfg.has_volume and cfg.volume_light_mis and cfg.enable_nee
                and cfg.num_lights > 0 and i > 0):
            # Phase/light MIS, phase side: a lane whose previous vertex
            # was a volume scatter hit a light that the NEE-only
            # convention drops. Add it balance-weighted against the
            # solid-angle pdf NEE had for this light point,
            # t^2 / (num_lights * tri_area * cos) (light records are per
            # triangle). Flat-scene ids only: instanced emitters keep the
            # NEE-only convention (tri_a == tric).
            area = scene["pk_tri_area" if cfg.traversal in PACKED_BACKENDS
                         else "tri_area"]
            tri_a = torch.clamp(tric, 0, area.shape[0] - 1)
            a_hit = area[tri_a]
            p_ph = s["prev_phase_pdf"]
            p_lw_hit = (t * t) / torch.clamp_min(
                cfg.num_lights * a_hit * torch.abs(ray_dot_n), 1e-9)
            w_ph = p_ph / torch.clamp_min(p_ph + p_lw_hit, 1e-12)
            vol_emis = (shading & is_light & ~s["prev_perfect_specular"]
                        & (p_ph > 0.0) & (ray_dot_n < 0.0) & (tri_a == tric))
            vol_add = s["throughput"] * mat["emissive"] * w_ph
            s["radiance"] = v3.where(vol_emis, s["radiance"] + vol_add,
                                     s["radiance"])
            if i <= cfg.split_early:
                s["rad_early"] = v3.where(vol_emis, s["rad_early"] + vol_add,
                                          s["rad_early"])
            if cfg.decouple_albedo:
                s["rad_d"] = v3.where(vol_emis,
                                      s["rad_d"] + vol_add * s["dc_w"],
                                      s["rad_d"])
            del area, tri_a, a_hit, p_ph, p_lw_hit, w_ph, vol_emis, vol_add

        # --- first-hit AOVs (RayGenCommon.h:524-654) ----------------------
        if i == 0:
            first = shading[:na]
            hit_a = _head(hit_point, na)
            aov["world_pos"] = v3.where(first, hit_a, aov["world_pos"])
            n_hit = n_origin + n_direction * t[:na]
            aov["neighbor_dist"] = torch.where(
                first, v3.length(n_hit - hit_a), aov["neighbor_dist"])
            del n_origin, n_direction, n_hit, hit_a
            aov["normal"] = v3.where(first, _head(detail_normal, na),
                                     aov["normal"])
            aov["depth"] = torch.where(first, t[:na], aov["depth"])
            aov["material"] = torch.where(
                first, mat_id[:na].to(torch.int32), aov["material"])
            aov["albedo"] = v3.where(first, _head(mat["albedo"], na),
                                     aov["albedo"])
            aov["emissive"] = v3.where(
                first, _head(mat["emissive"], na), aov["emissive"])
            if cost is not None:
                aov["heatmap"] = cost
            del cost

        # Ray-path record of the selected pixel (wavefront.py:1305-1317).
        if selected is not None:
            is_sel = ((lane == selected) & alive).to(torch.float32)
            aov["viz_rays"][i] = torch.stack([
                (a * is_sel).sum() for a in (
                    *s["origin"], *hit_point, t, torch.ones_like(t))])

        # --- NEE (kernel.glsl:1435-1517) ----------------------------------
        if cfg.enable_nee and cfg.num_lights > 0:
            nee_org = hit_point
            if cfg.has_volume:
                nee_org = v3.where(vol_scatter, vol_point, nee_org)
            ls = sample_one_light_soa(
                scene["lights"], cfg.num_lights, nee_org, lane,
                sample_index, i, use_ris=cfg.enable_ris, seed=seed,
                sampler=cfg.sampler,
            )
            del nee_org
            facing = v3.dot(ls["direction"], ls["normal"]) < 0.0
            do_nee = (shading & ~perfect_spec & ~is_light
                      & (ls["pdf"] > EPSILON) & facing)
            if cfg.has_volume:
                # Volume scatter vertices draw a light sample too,
                # weighted by the HG phase instead of a BRDF.
                do_nee = do_nee | (vol_scatter & (ls["pdf"] > EPSILON)
                                   & facing)
            s["rays_traced"] = s["rays_traced"] + do_nee.sum()
            sh_org = hit_point + normal * EPSILON
            if cfg.has_volume:
                sh_org = v3.where(vol_scatter, vol_point, sh_org)
            sh_tmax = torch.where(do_nee, ls["distance"] * (1.0 - 1e-3),
                                  0.0)
            occluded, sh_trans = _shadow(scene, sh_org, ls["direction"],
                                         sh_tmax, cfg)
            surf_w = bsdf.diffuse_brdf_soa(ls["direction"], detail_normal)
            if cfg.has_volume:
                # The HG phase value at the volume vertex is also the pdf
                # of the phase-sampled competitor, so the balance weight
                # against it is exact; p_L in solid angle (directional
                # lights, distance 1e9, drive the weight to 1).
                phase_val = hg_pdf(v3.dot(s["direction"], ls["direction"]),
                                   scene["vol_g"])
                cos_light = torch.abs(v3.dot(ls["normal"], ls["direction"]))
                p_lw = (ls["pdf"] * ls["distance"] ** 2
                        / torch.clamp_min(cos_light, 1e-6))
                w_vol_nee = (p_lw / torch.clamp_min(p_lw + phase_val, 1e-12)
                             if cfg.volume_light_mis else 1.0)
                surf_w = torch.where(vol_scatter, phase_val * w_vol_nee,
                                     surf_w)
                del phase_val, cos_light, p_lw, w_vol_nee
            light_mult = (
                ls["attenuation"] * surf_w
                * torch.abs(v3.dot(ls["normal"], ls["direction"]))
                / torch.clamp_min(ls["pdf"], 1e-12)
            )
            if sh_trans is not None:
                light_mult = light_mult * sh_trans
            add = do_nee & ~occluded
            nee_albedo = mat["albedo"]
            if cfg.decouple_albedo and i == 0:
                # The first vertex's direct light is diffuse-weighted: its
                # albedo factor is what the composite applies again.
                nee_albedo = v3.where(shading, V3(one, one, one), nee_albedo)
            if cfg.has_volume:
                # A volume vertex has no albedo (it rides in the walk's
                # weight).
                nee_albedo = v3.where(vol_scatter, V3(one, one, one),
                                      nee_albedo)
            contrib = s["throughput"] * nee_albedo * ls["color"]
            if cfg.has_volume:
                # Every shadow segment through the volume is attenuated
                # by the jittered ratio march.
                contrib = contrib * transmittance(
                    scene, sh_org, ls["direction"], sh_tmax, do_nee,
                    hash1(i, tbrng.STREAM_VOLUME_SHADOW),
                    cfg.volume_shadow_steps)
            s["radiance"] = v3.where(
                add, s["radiance"] + contrib * light_mult, s["radiance"])
            if i <= cfg.split_early:
                s["rad_early"] = v3.where(
                    add, s["rad_early"] + contrib * light_mult,
                    s["rad_early"])
            if cfg.decouple_albedo:
                w_nee = torch.where(shading, 1.0, s["dc_w"]) if i == 0 \
                    else s["dc_w"]
                s["rad_d"] = v3.where(
                    add, s["rad_d"] + contrib * light_mult * w_nee,
                    s["rad_d"])
            del ls, sh_org, sh_tmax, occluded, sh_trans, contrib, light_mult

        died_on_light = shading & is_light

        # --- BSDF sampling -------------------------------------------------
        if i == 0:
            r_u, r_v = blue_dir
        else:
            r_u, r_v = hash2(i, tbrng.STREAM_SECONDARY_DIR)

        spec_dir = bsdf.sample_ggx_reflection_soa(
            s["direction"], detail_normal, mat["roughness"], r_u, r_v)
        diff_dir, _ = bsdf.sample_cosine_hemisphere_soa(detail_normal,
                                                        r_u, r_v)
        sss_dir, sss_tir = bsdf.refract_or_reflect_soa(
            s["direction"], normal,
            cur_ior / torch.clamp_min(new_ior, 1e-6), ray_dot_n,
        )
        # Rough refraction on medium entry too (kernel.glsl:1535-1556).
        entry_lobe, entry_pdf = bsdf.sample_pow_lobe_soa(
            sss_dir, mat["roughness"], r_l0, r_l1)
        sss_dir = v3.where(rough_boundary, entry_lobe, sss_dir)

        surf_sss = shading & is_sss & ~spec_ray
        s["throughput"] = v3.where(
            surf_sss & rough_boundary & (entry_pdf < EPSILON),
            vzero3, s["throughput"])
        new_dir = v3.where(spec_ray, spec_dir,
                           v3.where(is_sss, sss_dir, diff_dir))
        del spec_dir, diff_dir, entry_lobe, entry_pdf

        entering = surf_sss & ~single_sided & ~sss_tir
        new_inside2 = torch.where(shading, entering, new_inside)
        s["med_absorption"] = v3.where(entering, mat["absorption"],
                                       s["med_absorption"])
        s["med_scattering"] = v3.where(entering, mat["scattering"],
                                       s["med_scattering"])
        s["med_ior"] = torch.where(entering, mat["ior"], s["med_ior"])

        # --- throughput update (kernel.glsl:1699-1772) --------------------
        prev_dir = s["direction"]
        diffuse_pdf = v3.dot(new_dir, detail_normal) / bsdf.PI
        half = bsdf.half_vector_safe_soa(-prev_dir, new_dir, detail_normal)
        spec_pdf = bsdf.ggx_reflection_pdf_soa(detail_normal, new_dir, half,
                                               mat["roughness"])
        # One-sample MIS over the two lobes (kernel.glsl:1708-1710).
        pdf = torch.where(
            allows_spec,
            torch.where(is_metal, spec_pdf,
                        p_spec * spec_pdf + (1.0 - p_spec) * diffuse_pdf),
            diffuse_pdf,
        )
        inv_pdf = 1.0 / torch.clamp_min(pdf, 1e-8)

        albedo = mat["albedo"]
        if cfg.decouple_albedo and i == 0:
            albedo = V3(one, one, one)
        spec_w = bsdf.specular_weight_soa(prev_dir, new_dir, normal,
                                          detail_normal, mat["roughness"])
        cos_sat = torch.clamp(v3.dot(new_dir, normal), 0.0, 1.0)
        metal_mult = albedo * (spec_w * cos_sat)

        refl_coef = mat["specular_coef"]
        fresnel = refl_coef + (1.0 - refl_coef) * torch.pow(
            torch.abs(1.0 - v3.dot(-prev_dir, half)), 5.0)
        diffuse_multiplier = (
            (28.0 / (23.0 * bsdf.PI))
            * (1.0 - refl_coef)
            * (1.0 - torch.pow(1.0 - 0.5 * v3.dot(-prev_dir, normal), 5.0))
            * (1.0 - torch.pow(1.0 - 0.5 * v3.dot(new_dir, normal), 5.0))
        )
        plastic_mult = V3(
            (albedo.x * diffuse_multiplier + fresnel * spec_w) * cos_sat,
            (albedo.y * diffuse_multiplier + fresnel * spec_w) * cos_sat,
            (albedo.z * diffuse_multiplier + fresnel * spec_w) * cos_sat,
        )
        if i == 0:
            # The first vertex's albedo-modulated share of the plastic
            # lobe pair, dm / (dm + fs) (wavefront.py:1526-1531).
            dc = torch.clamp(
                (albedo.x * diffuse_multiplier) / torch.clamp_min(
                    diffuse_multiplier + fresnel * spec_w, 1e-8), 0.0, 1.0)
            aov["diffuse_contrib"] = torch.where(
                first & allows_spec[:na] & ~is_metal[:na], dc[:na],
                aov["diffuse_contrib"])
            if cfg.decouple_albedo:
                phi = torch.where(
                    surf_sss, 0.0,
                    torch.where(is_metal | ~allows_spec, 1.0, dc))
                s["dc_w"] = torch.where(shading, phi, s["dc_w"])
                del phi
            del dc
        lambert_mult = albedo * bsdf.diffuse_brdf_soa(new_dir, detail_normal)
        surface_mult = v3.where(
            is_metal, metal_mult,
            v3.where(allows_spec, plastic_mult, lambert_mult))
        surface_mult = v3.where(surf_sss, V3(one, one, one), surface_mult)
        surface_scale = torch.where(surf_sss, 1.0, inv_pdf)

        if cfg.has_env and cfg.env_nee:
            do_env = _env_nee(
                scene, cfg, s, i, hash1, hash2, env_h, env_w,
                base=shading & ~perfect_spec & ~is_light & ~surf_sss,
                shading=shading, hit_point=hit_point, normal=normal,
                detail_normal=detail_normal, prev_dir=prev_dir,
                albedo=albedo, roughness=mat["roughness"],
                refl_coef=refl_coef, allows_spec=allows_spec,
                is_metal=is_metal, p_spec=p_spec)
            # The escape side's weight for this vertex's sampled lobe,
            # applied if the continuation ray misses; M env samples make
            # the env technique's density M * q.
            M = cfg.env_nee_samples
            w_escape = pdf / torch.clamp_min(
                pdf + M * torch.clamp_min(diffuse_pdf, 0.0), 1e-12)
            reset = shading | in_medium
            if cfg.has_volume:
                reset = reset | vol_scatter
            s["env_mis_w"] = torch.where(
                do_env, w_escape,
                torch.where(reset, 1.0, s["env_mis_w"]))
            del do_env, w_escape

        apply_surface = shading & ~died_on_light
        s["throughput"] = v3.where(
            apply_surface, s["throughput"] * surface_mult * surface_scale,
            s["throughput"])

        # --- commit new ray state ----------------------------------------
        new_origin = v3.where(
            surf_sss,
            hit_point + v3.where(sss_tir, normal * EPSILON,
                                 normal * -EPSILON),
            hit_point + normal * EPSILON,
        )
        s["origin"] = v3.where(
            in_medium, med_org,
            v3.where(shading, new_origin, s["origin"]))
        s["direction"] = v3.where(
            in_medium, med_dir,
            v3.where(shading, new_dir, s["direction"]))
        s["inside"] = torch.where(
            in_medium, new_inside,
            torch.where(shading, new_inside2, s["inside"]))
        s["prev_perfect_specular"] = torch.where(
            shading, perfect_spec, s["prev_perfect_specular"])
        if cfg.has_volume:
            # Volume scatter: continue from the collision point along the
            # HG direction (pdf == phase, weight 1: the albedo is in the
            # walk's weight). Record the continuation's phase pdf
            # (s["direction"] still holds the incoming direction of a
            # volume lane) for the MIS pair at the next emissive hit.
            s["prev_phase_pdf"] = torch.where(
                vol_scatter,
                hg_pdf(v3.dot(s["direction"], vol_dir), scene["vol_g"]),
                0.0)
            s["origin"] = v3.where(vol_scatter, vol_point, s["origin"])
            s["direction"] = v3.where(vol_scatter, vol_dir, s["direction"])
            s["prev_perfect_specular"] = torch.where(
                vol_scatter, False, s["prev_perfect_specular"])
            del vol_point, vol_dir
        del vol_scatter
        s["alive"] = alive & ~died_on_light & ~med_escaped
        del mat, hit_point, normal, new_dir, new_origin, med_org, med_dir

    radiance = s["radiance"]
    if cfg.has_env:
        # Deferred environment fetch; env_throughput is zero for lanes
        # that never missed.
        missed = v3.any_gt(s["env_throughput"], 0.0)
        env = sample_environment_quad_soa(
            s["direction"], scene["env_quad"], env_h, env_w,
            scene["env_transform"], scene["env_color_scale"],
            gather_mask=missed,
        )
        env_contrib = s["env_throughput"] * env
        if cfg.decouple_albedo:
            # A primary miss's environment rides the emissive AOV only;
            # later escapes carry the lane's diffuse fraction into D.
            live_env = v3.where(first_miss_all, vzero3, env_contrib)
            radiance = radiance + live_env
            s["rad_d"] = s["rad_d"] + live_env * s["dc_w"]
        else:
            radiance = radiance + env_contrib
        if first_miss is not None:
            aov["emissive"] = v3.where(first_miss, _head(env_contrib, na),
                                       aov["emissive"])
        if cfg.split_early >= 0:
            s["rad_early"] = s["rad_early"] + v3.where(
                s["miss_early"], env_contrib, vzero3)
    clamp = float(params.get("firefly_clamp", 0.0))

    def clamp_nan(rad):
        if clamp >= EPSILON:
            rad = V3(torch.clamp_max(rad.x, clamp),
                     torch.clamp_max(rad.y, clamp),
                     torch.clamp_max(rad.z, clamp))
        return v3.where(v3.isnan_any(rad), vzero3, rad)

    radiance = clamp_nan(radiance)
    if params.get("active_mask") is not None:
        fw = torch.where(params["active_mask"], fw, 0.0)

    out = dict(
        radiance=v3.to_rows(radiance * fw),
        filter_weight=fw,
        rays_traced=s["rays_traced"],
    )
    if cfg.filter_splat:
        out["jit_u"] = jit_u
        out["jit_v"] = jit_v
    if cfg.split_early >= 0:
        # The total's clamp and NaN policy, so that early + late stays
        # an exact partition with the firefly clamp off.
        out["radiance_early"] = v3.to_rows(clamp_nan(s["rad_early"]) * fw)
    if cfg.decouple_albedo:
        rad_d = v3.where(v3.isnan_any(s["rad_d"]), vzero3, s["rad_d"])
        out["radiance_d"] = v3.to_rows(rad_d * fw)
    for key, val in aov.items():
        out[key] = v3.to_rows(val) if isinstance(val, V3) else val
    return out


def splat_fold_tent(rad_r, rad_g, rad_b, jit_u, jit_v, W: int, H: int,
                    k: int):
    """Fold a k-merged full-film wave into per-pixel sums through a
    partition-of-unity TENT reconstruction splat (pbrt's triangle filter
    at radius 1): the sample at film position (x + ju, y + jv) contributes
    weight (1-|dx+0.5-ju|)+ * (1-|dy+0.5-jv|)+ to pixel (x+dx, y+dy),
    exactly the 2x2 nearest pixel centres, weights summing to 1 (border
    losses normalise out through the accumulated filter weight). Nine
    shifted adds of (k, H, W) planes in the JAX package's order: dy outer,
    dx inner, the sum over k before the shift. Returns (r, g, b, fw),
    each (H*W,)."""
    def img(a):
        return a.reshape(k, H, W)

    ju, jv = img(jit_u), img(jit_v)
    planes = [img(rad_r), img(rad_g), img(rad_b)]
    acc = [torch.zeros((H, W), dtype=torch.float32, device=ju.device)
           for _ in range(4)]
    for dy in (-1, 0, 1):
        wy = torch.clamp_min(1.0 - torch.abs(dy + 0.5 - jv), 0.0)
        for dx in (-1, 0, 1):
            w = wy * torch.clamp_min(1.0 - torch.abs(dx + 0.5 - ju), 0.0)
            srcs = [(w * p).sum(0) for p in planes] + [w.sum(0)]
            for i, src in enumerate(srcs):
                pad = torch.nn.functional.pad(src, (1, 1, 1, 1))
                acc[i] = acc[i] + pad[1 - dy:1 - dy + H, 1 - dx:1 - dx + W]
    return tuple(a.reshape(-1) for a in acc)


def render_wave_merged(scene, params, pixel_ids, base_sample: int, k: int,
                       cfg: WaveConfig, fold_aovs: bool = False,
                       fold_var: bool = False, aovs: bool = True):
    """Trace k samples per pixel in ONE wave of k*N lanes (per-lane sample
    indices base_sample + j); returns per-pixel summed radiance (and
    radiance_d, radiance_early) and filter weight, total rays_traced, and
    the first sample's AOVs (AOV_KEYS and viz_rays). With fold_aovs the
    albedo, normal, emissive and diffuse_contrib planes are summed over
    the k samples instead (the caller divides by the sample count for the
    anti-aliased mean). A merged wave cannot record the selected pixel's
    path (its lane would be recorded k times).

    cfg.filter_splat (a full-film wave, no decouple_albedo) folds the
    radiance through splat_fold_tent into radiance_splat (N, 3) and the
    filter weight; radiance stays the box fold of the samples, the plane
    the JAX package's renderer accumulates under the tent weight.
    fold_var adds lum and lum_sq, the per-pixel sums of each sample's
    tonemapped luma and its square (the adaptive burst's pilot
    statistic). aovs=False builds no AOV lanes (the AOV outputs are
    empty), as the sample-sharded step wants."""
    if params.get("selected_pixel") is not None:
        raise ValueError(
            "merged waves cannot record the selected pixel's ray path")
    N = pixel_ids.shape[0]
    if cfg.filter_splat:
        if N != cfg.width * cfg.height:
            raise ValueError("filter_splat needs a full-film wave "
                             "(pixel_ids = arange)")
        if cfg.decouple_albedo:
            raise ValueError("filter_splat + demodulated planes unsupported")
    dev = pixel_ids.device
    tiled = pixel_ids.repeat(k)
    sidx = int(base_sample) + torch.arange(
        k, dtype=torch.int64, device=dev).repeat_interleave(N)
    p2 = dict(params)
    if p2.get("bn") is not None:
        p2["bn"] = tuple(b.repeat(k) for b in p2["bn"])
    if p2.get("active_mask") is not None:
        p2["active_mask"] = p2["active_mask"].repeat(k)
    out = render_wave(scene, p2, tiled, sidx, cfg,
                      aov_lanes=0 if not aovs else k * N if fold_aovs else N)

    def fold(a):
        return a.reshape((k, N) + tuple(a.shape[1:])).sum(0)

    result = dict(
        radiance=fold(out["radiance"]),
        filter_weight=fold(out["filter_weight"]),
        rays_traced=out["rays_traced"],
    )
    if cfg.filter_splat:
        rad = out["radiance"]
        rr, gg, bb, fw = splat_fold_tent(
            rad[:, 0], rad[:, 1], rad[:, 2], out["jit_u"], out["jit_v"],
            cfg.width, cfg.height, k)
        result["radiance_splat"] = torch.stack([rr, gg, bb], dim=-1)
        result["filter_weight"] = fw
    if cfg.split_early >= 0:
        result["radiance_early"] = fold(out["radiance_early"])
    if fold_var:
        # Per-pixel moments of the per-sample tonemapped luma (the
        # fidelity gates score in that domain).
        rad = out["radiance"]
        fw1 = torch.clamp_min(out["filter_weight"], 1e-8)
        lin = (0.2126 * rad[:, 0] + 0.7152 * rad[:, 1]
               + 0.0722 * rad[:, 2]) / fw1
        tl = torch.pow(torch.clamp(lin, 0.0, 1.0), 1.0 / 2.2)
        result["lum"] = fold(tl)
        result["lum_sq"] = fold(tl * tl)
    if cfg.decouple_albedo:
        result["radiance_d"] = fold(out["radiance_d"])
    for key in AOV_KEYS:
        if fold_aovs and key in FOLDED_AOVS:
            result[key] = fold(out[key])
        else:
            result[key] = out[key][:N]
    result["viz_rays"] = out["viz_rays"]
    return result


def render_wave_batch(scene, params, pixel_ids, base_sample: int, k: int,
                      cfg: WaveConfig):
    """Trace k samples per pixel as k waves of N lanes; returns summed
    radiance, filter weight and rays_traced (and radiance_d,
    radiance_early), and the LAST sample's AOVs (no viz_rays, as in the
    JAX package)."""
    acc = None
    summed = ("radiance", "filter_weight", "rays_traced") + (
        ("radiance_d",) if cfg.decouple_albedo else ()) + (
        ("radiance_early",) if cfg.split_early >= 0 else ())
    for j in range(k):
        out = render_wave(scene, params, pixel_ids, int(base_sample) + j,
                          cfg)
        out.pop("viz_rays", None)
        if acc is not None:
            for key in summed:
                out[key] = acc[key] + out[key]
        acc = out
    return acc
