"""Surface attribute fetch: textures and materials for a wave of hits
(tracerboy_tpu/shade/surface.py: eval_texture, fetch_material_soa).

The reference's GetMaterialInternal (RayGenCommon.h:298-341: stochastic
mix resolution, map overrides) and GetTextureData (SharedRaytracing.h:
67-137: image/checker/scale with one nesting level and gamma decode),
with the SSS artist-albedo conversion of kernel.glsl:1236-1247. The JAX
package looks the small tables up with one-hot matrix products; here
they are plain row gathers, which give the same values.
"""

from __future__ import annotations

import torch

from tracerboy_tpu_torch.core import rng as tbrng
from tracerboy_tpu_torch.core import vec3 as v3
from tracerboy_tpu_torch.core.tonemap import gamma_to_linear
from tracerboy_tpu_torch.scene.materials import (
    METALLIC_FLAG,
    MIX_FLAG,
    SUBSURFACE_SCATTER_FLAG,
)
from tracerboy_tpu_torch.scene.textures import (
    GAMMA_FLAG,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_SCALE,
)
from tracerboy_tpu_torch.shade.bsdf import artist_albedo_to_absorption_soa


def _sample_image(tex_images, tex_sizes, image_idx, u, v):
    """Bilinear wrap sample from the padded image array; (N, 3)."""
    img_i = torch.clamp(image_idx, 0, tex_images.shape[0] - 1)
    hi = tex_sizes[img_i, 0].to(torch.int64)
    wi = tex_sizes[img_i, 1].to(torch.int64)
    uu = torch.remainder(u, 1.0)
    vv = torch.remainder(v, 1.0)
    fx = uu * wi.to(torch.float32) - 0.5
    fy = vv * hi.to(torch.float32) - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = torch.remainder(x0, wi)
    x1w = torch.remainder(x0 + 1, wi)
    y0w = torch.remainder(y0, hi)
    y1w = torch.remainder(y0 + 1, hi)
    c00 = tex_images[img_i, y0w, x0w]
    c01 = tex_images[img_i, y0w, x1w]
    c10 = tex_images[img_i, y1w, x0w]
    c11 = tex_images[img_i, y1w, x1w]
    return (c00 * (1 - tx) * (1 - ty) + c01 * tx * (1 - ty)
            + c10 * (1 - tx) * ty + c11 * tx * ty)


def _eval_texture_one(recs, tex_images, tex_sizes, rid, uv,
                      has_image=True):
    """Single-level texture evaluation of records `rid`; (N, 3)."""
    ttype = recs["ttype"][rid]
    u = uv[..., 0] * recs["uscale"][rid]
    v = uv[..., 1] * recs["vscale"][rid]
    color1 = recs["color1"][rid]
    color2 = recs["color2"][rid]
    # Checker: integer parity of floor(u*uscale) + floor(v*vscale).
    parity = torch.remainder(
        torch.floor(u).to(torch.int32) + torch.floor(v).to(torch.int32), 2)
    out = color1
    if has_image:
        img = _sample_image(tex_images, tex_sizes,
                            recs["image_idx"][rid].to(torch.int64), u, v)
        gamma = (recs["flags"][rid] & GAMMA_FLAG) != 0
        img = torch.where(gamma[..., None], gamma_to_linear(img), img)
        out = torch.where((ttype == TEX_IMAGE)[..., None], img, out)
    checker = torch.where((parity == 0)[..., None], color1, color2)
    return torch.where((ttype == TEX_CHECKER)[..., None], checker, out)


def eval_texture(recs, tex_images, tex_sizes, tex_id, uv,
                 has_image=True, has_scale=True):
    """Texture evaluation with one level of scale-texture nesting.
    tex_id: (N,) int; uv: (N, 2). Returns (N, 3)."""
    n = recs["ttype"].shape[0]
    rid = torch.clamp(tex_id.to(torch.int64), 0, n - 1)
    base = _eval_texture_one(recs, tex_images, tex_sizes, rid, uv,
                             has_image=has_image)
    if not has_scale:
        return base
    sub1 = recs["sub1"][rid].to(torch.int64)
    sub2 = recs["sub2"][rid].to(torch.int64)
    t1 = torch.where(
        (sub1 >= 0)[..., None],
        _eval_texture_one(recs, tex_images, tex_sizes,
                          torch.clamp(sub1, 0, n - 1), uv, has_image),
        recs["color1"][rid],
    )
    t2 = torch.where(
        (sub2 >= 0)[..., None],
        _eval_texture_one(recs, tex_images, tex_sizes,
                          torch.clamp(sub2, 0, n - 1), uv, has_image),
        recs["color2"][rid],
    )
    return torch.where((recs["ttype"][rid] == TEX_SCALE)[..., None],
                       t1 * t2, base)


def apply_normal_map(scene, normal_tex, normal, tangent, uv_u, uv_v):
    """Tangent-space normal-map perturbation (GetDetailNormal,
    RayGenCommon.h:273-295): tbn = ((0.5-x)*2, (0.5-y)*2, sqrt(1-x2-y2)),
    z clamped to 0.02 so reflections never go parallel to the surface;
    the normal itself where the material has no normal map.

    normal/tangent: V3 SoA. Returns the detail normal (V3)."""
    # Gram-Schmidt: flat per-triangle tangents aren't exactly
    # perpendicular to the interpolated shading normal.
    t = v3.normalize(tangent - normal * v3.dot(tangent, normal))
    b = v3.cross(t, normal)
    data = eval_texture(
        scene["tex_records"], scene["tex_images"], scene["tex_sizes"],
        torch.clamp_min(normal_tex, 0), torch.stack([uv_u, uv_v], dim=-1),
    )
    tx = (0.5 - data[..., 0]) * 2.0
    ty = (0.5 - data[..., 1]) * 2.0
    tz = torch.sqrt(torch.clamp_min(1.0 - tx * tx - ty * ty, 0.0))
    detail = v3.normalize(
        t * tx + b * ty + normal * torch.clamp_min(tz, 0.02)
    )
    return v3.where(normal_tex >= 0, detail, normal)


def _resolve_mix(mats, mat_id, lane_id, sample_index, bounce, seed,
                 has_mix):
    """The material row of each hit: mat_id clamped to the table, a mix
    material resolved one level by its coin (RayGenCommon.h:308-319)."""
    M = mats["flags"].shape[0]
    mid = torch.clamp(mat_id.to(torch.int64), 0, M - 1)
    if has_mix:
        is_mix = (mats["flags"][mid] & MIX_FLAG) != 0
        packed = mats["albedo"][mid]     # (mat0, mat1, amount)
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_MIX, seed)
        mix_id = torch.where(r < packed[:, 2], packed[:, 0],
                             packed[:, 1]).to(torch.int64)
        mid = torch.where(is_mix, torch.clamp(mix_id, 0, M - 1), mid)
    return mid


def fetch_material_soa(
    scene,
    mat_id,
    uv_u,
    uv_v,
    backside,
    lane_id,
    sample_index,
    bounce,
    seed=0,
    has_mix: bool = True,
    has_textures: bool = True,
    has_emissive_tex: bool = True,
    has_specular_tex: bool = True,
    has_image_tex: bool = True,
    has_scale_tex: bool = True,
):
    """Per-hit material record: V3 fields + (N,) scalars.

    Mix resolution (one level), texture overrides of albedo, emissive and
    specular, one-sided emission and the SSS conversion; the has_* flags
    are scene facts that skip paths no material can reach."""
    mats = scene["materials"]
    mid = _resolve_mix(mats, mat_id, lane_id, sample_index, bounce, seed,
                       has_mix)

    def col3(name):
        a = mats[name][mid]
        return v3.V3(a[:, 0], a[:, 1], a[:, 2])

    albedo = col3("albedo")
    emissive = col3("emissive")
    ior = mats["ior"][mid]
    roughness = mats["roughness"][mid]
    absorption = col3("absorption")
    scattering = col3("scattering")
    specular_coef = mats["specular_coef"][mid]
    flags = mats["flags"][mid]
    albedo_tex = mats["albedo_tex"][mid]
    emissive_tex = mats["emissive_tex"][mid]
    spec_tex = mats["specular_tex"][mid]
    normal_tex = mats["normal_tex"][mid]

    zero = torch.zeros_like(ior)
    emissive = v3.where(backside, v3.V3(zero, zero, zero), emissive)

    if has_textures:
        recs = scene["tex_records"]
        imgs = scene["tex_images"]
        sizes = scene["tex_sizes"]
        uv = torch.stack([uv_u, uv_v], dim=-1)
        kw = dict(has_image=has_image_tex, has_scale=has_scale_tex)
        alb_t = eval_texture(recs, imgs, sizes, albedo_tex, uv, **kw)
        albedo = v3.where(albedo_tex >= 0,
                          v3.V3(alb_t[:, 0], alb_t[:, 1], alb_t[:, 2]),
                          albedo)
        if has_emissive_tex:
            emi_t = eval_texture(recs, imgs, sizes, emissive_tex, uv, **kw)
            emissive = v3.where(
                (emissive_tex >= 0) & ~backside,
                v3.V3(emi_t[:, 0], emi_t[:, 1], emi_t[:, 2]), emissive)
        if has_specular_tex:
            spec = eval_texture(recs, imgs, sizes, spec_tex, uv, **kw)
            has_spec = spec_tex >= 0
            roughness = torch.where(has_spec, spec[:, 1], roughness)
            flags = torch.where(has_spec & (spec[:, 2] > 0.5),
                                flags | METALLIC_FLAG, flags)

    is_sss = (flags & SUBSURFACE_SCATTER_FLAG) != 0
    has_albedo = (albedo.x > 0) | (albedo.y > 0) | (albedo.z > 0)
    conv = is_sss & has_albedo
    mfp = v3.V3(
        1.0 / torch.clamp_min(scattering.x, 1e-8),
        1.0 / torch.clamp_min(scattering.y, 1e-8),
        1.0 / torch.clamp_min(scattering.z, 1e-8),
    )
    conv_abs, conv_scat = artist_albedo_to_absorption_soa(albedo, mfp)
    absorption = v3.where(conv, conv_abs, absorption)
    scattering = v3.where(conv, conv_scat, scattering)
    albedo = v3.where(conv, v3.V3(zero, zero, zero), albedo)

    return dict(
        albedo=albedo, emissive=emissive, ior=ior, roughness=roughness,
        absorption=absorption, scattering=scattering,
        specular_coef=specular_coef, flags=flags, normal_tex=normal_tex,
    )


def fetch_material(scene, mat_id, uv, backside, lane_id, sample_index,
                   bounce, seed=0, has_mix: bool = True,
                   has_textures: bool = True):
    """The material record in the row layout (the JAX package's
    cross-check form of fetch_material_soa): uv (N, 2); returns (N, 3)
    albedo, emissive, absorption, scattering and (N,) ior, roughness,
    specular_coef, flags, normal_tex, alpha_tex."""
    out = fetch_material_soa(scene, mat_id, uv[:, 0], uv[:, 1], backside,
                             lane_id, sample_index, bounce, seed,
                             has_mix=has_mix, has_textures=has_textures)
    out = {k: v3.to_rows(v) if isinstance(v, v3.V3) else v
           for k, v in out.items()}
    mats = scene["materials"]
    out["alpha_tex"] = mats["alpha_tex"][_resolve_mix(
        mats, mat_id, lane_id, sample_index, bounce, seed, has_mix)]
    return out
