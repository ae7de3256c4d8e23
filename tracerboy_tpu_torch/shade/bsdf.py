"""BSDF sampling routines and reflectance weights on SoA planes
(the *_soa functions of tracerboy_tpu/shade/bsdf.py), and their row-layout
forms on (..., 3) tensors (the functions without the suffix, which no
path of the renderer calls: host-side and test code).

The reference's shading math (TracerBoy/kernel.glsl): GGX NDF (466-478),
cosine-weighted diffuse sampling (1025-1046), GGX importance sampling by
a reoriented spherical sample + reflect (1066-1099), the pow lobe of
rough refraction (1048-1064) and the specular weight of the bounce
epilogue (1734-1755).
"""

from __future__ import annotations

import math

import torch

from tracerboy_tpu_torch.core import vec3 as v3
from tracerboy_tpu_torch.core.mathutil import (
    dot,
    normalize,
    reflect,
    reorient_around_normal,
    spherical_to_dir,
)

PI = math.pi
MIN_ROUGHNESS = 0.04
MIN_ROUGHNESS_SQUARED = MIN_ROUGHNESS * MIN_ROUGHNESS
AIR_IOR = 1.0
EPSILON = 1e-4
LARGE_NUMBER = 1e10


def sample_cosine_hemisphere_soa(normal, r0, r1):
    """Cosine-weighted direction about V3 `normal`; returns (V3, pdf)."""
    r = torch.sqrt(r0)
    theta = 2.0 * PI * r1
    lx = r * torch.cos(theta)
    ly = torch.sqrt(torch.clamp_min(1.0 - r0, EPSILON))
    lz = r * torch.sin(theta)
    pdf = ly / PI
    return v3.reorient(v3.V3(lx, ly, lz), normal), pdf


def sample_pow_lobe_soa(axis, roughness, r0, r1):
    """Phong-style pow lobe about V3 `axis` for rough refraction.
    Returns (V3, pdf)."""
    lobe = torch.pow(1.0 - roughness, 5.0) * 1000.0
    theta = 2.0 * PI * r1
    cos_phi = torch.pow(torch.clamp_min(r0, 1e-12), 1.0 / (lobe + 1.0))
    sin_phi = torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    local = v3.V3(sin_phi * torch.cos(theta), cos_phi,
                  sin_phi * torch.sin(theta))
    pdf = (lobe + 1.0) * torch.pow(cos_phi, lobe) / (2.0 * PI)
    return v3.reorient(local, axis), pdf


def sample_ggx_reflection_soa(incoming, normal, roughness, r0, r1):
    """GGX microfacet sample + reflect of `incoming` (toward the surface)."""
    rough = torch.clamp_min(roughness, MIN_ROUGHNESS)
    a2 = (rough * rough) ** 2
    theta = 2.0 * PI * r1
    cos_phi = torch.sqrt(
        torch.clamp((1.0 - r0) / ((a2 - 1.0) * r0 + 1.0), 0.0, 1.0))
    sin_phi = torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    local = v3.V3(sin_phi * torch.cos(theta), cos_phi,
                  sin_phi * torch.sin(theta))
    return v3.reflect(incoming, v3.reorient(local, normal))


def ggx_reflection_pdf_soa(normal, outgoing, half, roughness):
    """pdf of sample_ggx_reflection_soa in outgoing solid angle."""
    rough = torch.clamp_min(roughness, MIN_ROUGHNESS)
    a2 = (rough * rough) ** 2
    cos_t = torch.abs(v3.dot(normal, half))
    e = (a2 - 1.0) * cos_t * cos_t + 1.0
    d = a2 / (PI * e * e)
    pdf = d * cos_t / (
        4.0 * torch.clamp_min(torch.abs(v3.dot(outgoing, half)), 1e-8))
    return torch.where(e > 0.0, pdf, LARGE_NUMBER)


def half_vector_safe_soa(a, b, normal):
    """normalize(a + b), or the normal for opposite vectors."""
    opposite = v3.dot(a, b) <= (-1.0 + EPSILON)
    return v3.where(opposite, normal, v3.normalize(a + b))


def diffuse_brdf_soa(light_dir, normal):
    """Lambert with the cosine folded in."""
    return torch.clamp_min(v3.dot(light_dir, normal), 0.0) / PI


def ggx_ndf_soa(normal, half, roughness_squared):
    a2sq = torch.clamp_min(roughness_squared, MIN_ROUGHNESS_SQUARED)
    a2 = a2sq * a2sq
    ndoth = v3.dot(normal, half)
    denom = PI * torch.square(ndoth * ndoth * (a2 - 1.0) + 1.0)
    return a2 / torch.clamp_min(denom, 1e-12)


def specular_weight_soa(prev_dir, new_dir, normal, detail_normal, roughness):
    """D / (4 |v.h| max(|v.n|, |l.n|)) after a specular bounce."""
    half = half_vector_safe_soa(-prev_dir, new_dir, normal)
    rough_sq = torch.clamp_min(roughness * roughness, MIN_ROUGHNESS_SQUARED)
    d = ggx_ndf_soa(detail_normal, half, rough_sq)
    denom = (
        4.0 * torch.clamp_min(torch.abs(v3.dot(-prev_dir, half)), 1e-8)
        * torch.clamp_min(
            torch.maximum(torch.abs(v3.dot(-prev_dir, normal)),
                          torch.abs(v3.dot(new_dir, normal))), 1e-8)
    )
    return d / denom


def sample_uniform_sphere_soa(r0, r1):
    """Uniform sphere direction (the isotropic phase function)."""
    z = 1.0 - 2.0 * r0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    theta = 2.0 * PI * r1
    return v3.V3(r * torch.cos(theta), z, r * torch.sin(theta))


def refract_or_reflect_soa(direction, normal, nr, ray_dot_n):
    """Snell refraction with a total-internal-reflection fallback
    (kernel.glsl:1530-1563). Returns (V3, tir mask)."""
    disc = 1.0 - nr * nr * (1.0 - ray_dot_n * ray_dot_n)
    tir = disc <= EPSILON
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    refr = v3.normalize(
        v3.V3(
            nr * (direction.x - normal.x * ray_dot_n) - normal.x * root,
            nr * (direction.y - normal.y * ray_dot_n) - normal.y * root,
            nr * (direction.z - normal.z * ray_dot_n) - normal.z * root,
        )
    )
    return v3.where(tir, v3.reflect(direction, normal), refr), tir


def artist_albedo_to_absorption_soa(color, mfp):
    """Burley's SSS parameterization (kernel.glsl:1224-1234) on V3s;
    returns (absorption, scattering)."""

    def one(c, m):
        alpha = 1.0 - torch.exp(-5.09406 * c + 2.61188 * c * c
                                - 4.31805 * c ** 3)
        s = 1.9 - c + 3.5 * (c - 0.8) * (c - 0.8)
        trans = 1.0 / torch.clamp_min(s * m, 1e-8)
        return trans - trans * alpha, trans * alpha

    ax, sx = one(color.x, mfp.x)
    ay, sy = one(color.y, mfp.y)
    az, sz = one(color.z, mfp.z)
    return v3.V3(ax, ay, az), v3.V3(sx, sy, sz)


# ----------------------------------------------------------------------------
# Row layout: (..., 3) tensors, scalars and (...,) tensors broadcast.


def fresnel_factor(current_ior, new_ior, normal, ray_direction):
    """Dielectric Schlick Fresnel from an IOR pair (kernel.glsl:441-451)."""
    r0 = ((current_ior - new_ior) / (current_ior + new_ior)) ** 2
    return r0 + (1.0 - r0) * torch.pow(
        torch.clamp(1.0 - dot(normal, -ray_direction), 0.0, 1.0), 5.0)


def ggx_ndf(normal, half_vector, roughness_squared):
    """GGX/Trowbridge-Reitz D (kernel.glsl:466-478)."""
    a2sq = torch.clamp_min(roughness_squared, MIN_ROUGHNESS_SQUARED)
    a2 = a2sq * a2sq
    ndoth = dot(normal, half_vector)
    denom = PI * torch.square(ndoth * ndoth * (a2 - 1.0) + 1.0)
    return a2 / torch.clamp_min(denom, 1e-12)


def diffuse_brdf(light_dir, normal):
    """Lambert with the cosine folded in (kernel.glsl:541-546)."""
    return torch.clamp_min(dot(light_dir, normal), 0.0) / PI


def half_vector_safe(a, b, normal):
    """normalize(a + b), or the normal for opposite vectors
    (kernel.glsl:1258-1268)."""
    opposite = dot(a, b) <= (-1.0 + EPSILON)
    return torch.where(opposite[..., None], normal, normalize(a + b))


def sample_cosine_hemisphere(normal, r0, r1):
    """Cosine-weighted direction about `normal`; returns (dir, pdf)
    (kernel.glsl:1025-1046)."""
    r = torch.sqrt(r0)
    theta = 2.0 * PI * r1
    y = torch.sqrt(torch.clamp_min(1.0 - r0, EPSILON))
    local = torch.stack([r * torch.cos(theta), y, r * torch.sin(theta)], -1)
    return reorient_around_normal(local, normal), y / PI


def sample_ggx_reflection(incoming, normal, roughness, r0, r1):
    """A GGX microfacet normal, and `incoming` (toward the surface)
    reflected about it (kernel.glsl:1066-1083)."""
    rough = torch.clamp_min(roughness, MIN_ROUGHNESS)
    a = rough * rough
    a2 = a * a
    theta = 2.0 * PI * r1
    phi = torch.arccos(torch.sqrt(
        torch.clamp((1.0 - r0) / ((a2 - 1.0) * r0 + 1.0), 0.0, 1.0)))
    m = reorient_around_normal(spherical_to_dir(phi, theta), normal)
    return reflect(incoming, m)


def ggx_reflection_pdf(normal, outgoing, half_vector, roughness):
    """pdf of sample_ggx_reflection in outgoing solid angle
    (kernel.glsl:1085-1097)."""
    rough = torch.clamp_min(roughness, MIN_ROUGHNESS)
    a = rough * rough
    a2 = a * a
    cos_t = torch.abs(dot(normal, half_vector))
    e = (a2 - 1.0) * cos_t * cos_t + 1.0
    d = a2 / (PI * e * e)
    pdf = d * cos_t / (
        4.0 * torch.clamp_min(torch.abs(dot(outgoing, half_vector)), 1e-8))
    return torch.where(e > 0.0, pdf, LARGE_NUMBER)


def sample_pow_lobe(axis, roughness, r0, r1):
    """The pow lobe about `axis` of rough refraction; returns (dir, pdf)
    (kernel.glsl:1048-1064)."""
    lobe = torch.pow(1.0 - roughness, 5.0) * 1000.0
    theta = 2.0 * PI * r1
    phi = torch.arccos(torch.pow(torch.clamp_min(r0, 1e-12),
                                 1.0 / (lobe + 1.0)))
    pdf = (lobe + 1.0) * torch.pow(torch.cos(phi), lobe) / (2.0 * PI)
    return reorient_around_normal(spherical_to_dir(phi, theta), axis), pdf


def sample_uniform_sphere(r0, r1):
    """Uniform sphere direction; returns (dir, pdf) (the isotropic phase
    function)."""
    z = 1.0 - 2.0 * r0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    theta = 2.0 * PI * r1
    d = torch.stack([r * torch.cos(theta), z, r * torch.sin(theta)], -1)
    return d, torch.full_like(r0, 1.0 / (4.0 * PI))


def specular_weight(prev_dir, new_dir, normal, detail_normal, roughness):
    """D / (4 |v.h| max(|v.n|, |l.n|)) after a specular bounce
    (kernel.glsl:1734-1738, 1750-1755)."""
    half = half_vector_safe(-prev_dir, new_dir, normal)
    rough_sq = torch.clamp_min(roughness * roughness, MIN_ROUGHNESS_SQUARED)
    d = ggx_ndf(detail_normal, half, rough_sq)
    denom = 4.0 * torch.clamp_min(torch.abs(dot(-prev_dir, half)), 1e-8) \
        * torch.clamp_min(torch.maximum(torch.abs(dot(-prev_dir, normal)),
                                        torch.abs(dot(new_dir, normal))),
                          1e-8)
    return d / denom


def artist_albedo_to_absorption(color, mfp):
    """Burley's practical subsurface parameterization
    (kernel.glsl:1224-1234); returns (absorption, scattering)."""
    alpha = 1.0 - torch.exp(-5.09406 * color + 2.61188 * color * color
                            - 4.31805 * color ** 3)
    s = 1.9 - color + 3.5 * (color - 0.8) * (color - 0.8)
    transmission = 1.0 / torch.clamp_min(s * mfp, 1e-8)
    scattering = transmission * alpha
    return transmission - scattering, scattering
