"""Heterogeneous participating medium: delta tracking + ratio marching
(tracerboy_tpu/shade/volumetric.py).

The reference loads a density grid + bounds (TracerBoy.cpp:1096-1184,
compile-disabled) but never shades it; its kernel cites the Pixar
production-volume-rendering course for the intended anisotropic phase
(kernel.glsl:1200). The JAX package supplies that shading in plain jnp
and this module is its plain torch copy, expression for expression:
trilinear density taps through one row gather from the (D*H*W, 8)
corner-stencil table vol_oct (nearest-neighbour kept as fallback),
spectral null-collision weights so coloured sigma_a / sigma_s stay
unbiased (Kutz et al. 2017 spectral tracking, one scalar majorant), and
jittered ratio-marched transmittance for shadow segments.

The walk (delta_track) is the JAX package's while_loop: it stops once no
lane is mid-volume, each check a device-to-host sync, or after `steps`
steps. Checking every step was fastest on the H100: the first bounce of
chip_smoke's volume run (3,686,400 lanes, 42 steps) took 261.5 / 272.1 /
297.0 / 395.6 ms checking every 1 / 4 / 16 / 64 steps (NVIDIA H100 80GB
HBM3, 700.00 W; PERF.md §5). The grid's (D, H, W) comes from
the scene's vol_shape (python ints, scene/compile.py from_jax_pytree).

Used by trace/wavefront.py when the scene carries a volume
(WaveConfig.has_volume).
"""

from __future__ import annotations

import math

import torch

from tracerboy_tpu_torch.core import vec3 as v3
from tracerboy_tpu_torch.core.vec3 import V3


def ray_box_overlap(o, d, lo, hi):
    """Slab overlap of SoA rays with the volume AABB.

    Returns (t0, t1); empty overlap has t1 <= t0.
    """
    eps = 1e-12

    def axis(oc, dc, lo_c, hi_c):
        dc = torch.where(torch.abs(dc) < eps,
                         torch.where(dc < 0, -eps, eps), dc)
        a = (lo_c - oc) / dc
        b = (hi_c - oc) / dc
        return torch.minimum(a, b), torch.maximum(a, b)

    n0, f0 = axis(o.x, d.x, lo[0], hi[0])
    n1, f1 = axis(o.y, d.y, lo[1], hi[1])
    n2, f2 = axis(o.z, d.z, lo[2], hi[2])
    t0 = torch.maximum(torch.maximum(n0, n1), torch.clamp_min(n2, 0.0))
    t1 = torch.minimum(torch.minimum(f0, f1), f2)
    return t0, t1


def _unit(scene, px, py, pz):
    lo = scene["vol_lo"]
    hi = scene["vol_hi"]
    ext = torch.clamp_min(hi - lo, 1e-12)
    fz = (pz - lo[2]) / ext[2]
    fy = (py - lo[1]) / ext[1]
    fx = (px - lo[0]) / ext[0]
    inside = ((fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1) & (fz >= 0)
              & (fz < 1))
    return fx, fy, fz, inside


def sample_density(scene, px, py, pz):
    """Nearest-neighbour density at SoA world positions (one gather)."""
    D, H, W = scene["vol_shape"]
    fx, fy, fz, inside = _unit(scene, px, py, pz)
    iz = torch.clamp((fz * float(D)).to(torch.int32), 0, D - 1)
    iy = torch.clamp((fy * float(H)).to(torch.int32), 0, H - 1)
    ix = torch.clamp((fx * float(W)).to(torch.int32), 0, W - 1)
    flat = (iz * H + iy) * W + ix
    return torch.where(inside, scene["vol_density"][flat.long()], 0.0)


def sample_density_trilinear(scene, px, py, pz):
    """Trilinearly interpolated density at SoA world positions: one row
    gather from the (D*H*W, 8) corner-stencil table vol_oct (built in
    scene/compile.py), then an 8-tap lerp. Voxel CENTRES are the sample
    points (continuous coords f*dim - 0.5, edge-clamped), so
    interpolated values never exceed max(density), which keeps the
    delta-tracking majorant a true bound."""
    D, H, W = scene["vol_shape"]
    fx, fy, fz, inside = _unit(scene, px, py, pz)

    def axis(f, n):
        c = f * float(n) - 0.5
        b = torch.clamp(torch.floor(c), 0.0, float(n) - 1.0)
        return b.to(torch.int32), torch.clamp(c - b, 0.0, 1.0)

    bz, wz = axis(fz, D)
    by, wy = axis(fy, H)
    bx, wx = axis(fx, W)
    # A NaN position (a dead lane's) casts to INT_MIN in torch: clamp the
    # index; `inside` masks its value.
    flat = torch.clamp((bz * H + by) * W + bx, 0, D * H * W - 1)
    row = scene["vol_oct"][flat.long()]  # (N, 8)
    # Corner order (compile.py): [z y x], [z y x+], [z y+ x], [z y+ x+],
    # [z+ y x], [z+ y x+], [z+ y+ x], [z+ y+ x+].
    lx0 = row[:, 0] * (1 - wx) + row[:, 1] * wx
    lx1 = row[:, 2] * (1 - wx) + row[:, 3] * wx
    lx2 = row[:, 4] * (1 - wx) + row[:, 5] * wx
    lx3 = row[:, 6] * (1 - wx) + row[:, 7] * wx
    ly0 = lx0 * (1 - wy) + lx1 * wy
    ly1 = lx2 * (1 - wy) + lx3 * wy
    return torch.where(inside, ly0 * (1 - wz) + ly1 * wz, 0.0)


def density_at(scene, px, py, pz):
    """Trilinear when the stencil table is present, else nearest."""
    if "vol_oct" in scene:
        return sample_density_trilinear(scene, px, py, pz)
    return sample_density(scene, px, py, pz)


def hg_pdf(cos_t, g):
    """Henyey-Greenstein phase density over solid angle (= the phase
    value itself: sample_hg draws proportional to it, so it doubles as
    the MIS pdf). |g| ~ 0 falls back to the isotropic 1/4pi."""
    g = torch.as_tensor(g, dtype=torch.float32, device=cos_t.device)
    iso = torch.abs(g) < 1e-3
    den = torch.pow(
        torch.clamp_min(1.0 + g * g - 2.0 * g * cos_t, 1e-6), 1.5)
    return torch.where(
        iso, torch.full_like(cos_t, 1.0 / (4.0 * math.pi)),
        (1.0 - g * g) / (4.0 * math.pi * den))


def delta_track(scene, o, d, t_lim, active, rng2, steps: int):
    """Delta-tracked medium interaction along [0, t_lim].

    rng2(k) -> (u_dist, u_accept) per fixed iteration k. Returns
    (scattered, t_scatter, weight V3): weight carries the spectral
    null-collision corrections plus single-scatter albedo at the real
    collision; rays that escape the segment keep weight = their
    accumulated null corrections (expected value = transmittance)."""
    t0, t1 = ray_box_overlap(o, d, scene["vol_lo"], scene["vol_hi"])
    t1 = torch.minimum(t1, t_lim)
    walk = active & (t1 > t0)

    maj = scene["vol_majorant"]
    sig_a = scene["vol_sigma_a"]
    sig_s = scene["vol_sigma_s"]
    sig_t = sig_a + sig_s
    sig_t_max = torch.clamp_min(sig_t.max(), 1e-8)
    scat_w = sig_s / sig_t_max

    tcur = t0
    scattered = walk & False
    t_sc = torch.zeros_like(t0)
    w = [torch.ones_like(t0) for _ in range(3)]
    k = 0
    while k < steps and bool((walk & ~scattered & (tcur < t1)).any()):
        u1, u2 = rng2(k)
        step = -torch.log(torch.clamp_min(1.0 - u1, 1e-12)) / maj
        tcur = torch.where(walk & ~scattered, tcur + step, tcur)
        live = walk & ~scattered & (tcur < t1)
        px = o.x + d.x * tcur
        py = o.y + d.y * tcur
        pz = o.z + d.z * tcur
        dens = density_at(scene, px, py, pz)
        p_real = torch.clamp(dens * sig_t_max / maj, 0.0, 1.0)
        real = live & (u2 < p_real)
        # Null collision: per-channel correction
        # (maj - dens*sigma_t_c) / (maj - dens*sigma_t_max).
        denom = torch.maximum(maj - dens * sig_t_max, 1e-8 * maj)
        nullc = live & ~real
        for c in range(3):
            w[c] = torch.where(
                real, w[c] * scat_w[c],
                torch.where(nullc, w[c] * (maj - dens * sig_t[c]) / denom,
                            w[c]))
        scattered = scattered | real
        t_sc = torch.where(real, tcur, t_sc)
        del u1, u2, step, live, px, py, pz, dens, p_real, real, denom, nullc
        k += 1
    return scattered, t_sc, V3(*w)


def transmittance(scene, o, d, t_max, active, jitter, steps: int):
    """Ratio-marched transmittance along shadow segments: `steps`
    jittered samples of sigma_t over the box overlap,
    T_c = exp(-sum sigma_t_c(x_j) * dt). Attenuates NEE through the
    volume."""
    t0, t1 = ray_box_overlap(o, d, scene["vol_lo"], scene["vol_hi"])
    t1 = torch.minimum(t1, t_max)
    seg = torch.clamp_min(t1 - t0, 0.0)
    march = active & (seg > 0.0)

    sig_t = scene["vol_sigma_a"] + scene["vol_sigma_s"]
    dt = seg / steps
    acc = torch.zeros_like(t0)
    for j in range(steps):
        tj = t0 + (j + jitter) * dt
        px = o.x + d.x * tj
        py = o.y + d.y * tj
        pz = o.z + d.z * tj
        acc = acc + density_at(scene, px, py, pz)
    tau = torch.where(march, acc * dt, 0.0)
    return V3(torch.exp(-tau * sig_t[0]), torch.exp(-tau * sig_t[1]),
              torch.exp(-tau * sig_t[2]))


def sample_hg(d, g, u1, u2):
    """Henyey-Greenstein direction sample around SoA directions d.

    g ~ 0 falls back to the isotropic sphere (the reference's medium
    scatter, kernel.glsl:1616-1621); otherwise the standard HG inversion
    (Pixar PVR course eq. 8, cited at kernel.glsl:1200)."""
    g = torch.as_tensor(g, dtype=torch.float32,
                        device=u1.device).expand(u1.shape)
    iso = torch.abs(g) < 1e-3
    den1 = 1.0 + g - 2.0 * g * u1
    den1 = torch.where(torch.abs(den1) < 1e-6,
                       torch.where(den1 < 0, -1e-6, 1e-6), den1)
    sq = (1.0 - g * g) / den1
    den2 = torch.where(torch.abs(g) < 1e-6, 1e-6, 2.0 * g)
    cos_hg = (1.0 + g * g - sq * sq) / den2
    cos_t = torch.where(iso, 1.0 - 2.0 * u1, torch.clamp(cos_hg, -1.0, 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2

    # Orthonormal frame around d.
    up_x = torch.where(torch.abs(d.z) < 0.999, 0.0, 1.0)
    up = V3(up_x, torch.zeros_like(up_x), 1.0 - up_x)
    t1v = v3.normalize(v3.cross(up, d))
    t2v = v3.cross(d, t1v)
    return v3.normalize(
        t1v * (sin_t * torch.cos(phi))
        + t2v * (sin_t * torch.sin(phi))
        + d * cos_t)
