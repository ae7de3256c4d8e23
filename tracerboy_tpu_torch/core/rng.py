"""Counter-based randoms and low-discrepancy sequences, bit-exact with
tracerboy_tpu/core/rng.py.

Every random decision is a stateless hash of (lane, sample, bounce,
stream, seed), so the render needs no torch.Generator and every lane can
be compared with the JAX package draw for draw. Torch has no full uint32
arithmetic: values are held in int64 and masked to 32 bits after every
operation that can carry past bit 31 (products of two 32-bit values may
wrap the int64; the low 32 bits are still exact in two's complement).
"""

from __future__ import annotations

import numpy as np
import torch

STREAM_PRIMARY_JITTER = 0      # 2 dims: pixel AA jitter
STREAM_SECONDARY_DIR = 2       # 2 dims: BSDF direction sample
STREAM_AREA_LIGHT = 4          # 2 dims: light surface sample
STREAM_DOF = 6                 # 2 dims: aperture sample
STREAM_RUSSIAN_ROULETTE = 8
STREAM_SPECULAR_SELECT = 9
STREAM_LIGHT_SELECT = 10
STREAM_RIS = 11                # 2*16 dims reserved for reservoir sampling
STREAM_SSS = 48                # scattering walk (uses 48-49)
STREAM_MIX = 50                # mix-material resolution coin
STREAM_ROUGH_REFRACT = 51      # pow-lobe rough refraction sample
STREAM_VOLUME = 52             # delta-tracking walk (52..55)
STREAM_VOLUME_SHADOW = 56      # ratio-marching jitter for NEE
STREAM_ENV_NEE = 58            # 2 dims: environment NEE direction
STREAM_ENV_NEE_SHADOW = 60     # ratio-marching jitter for env NEE
STREAM_ACCUM_JITTER = 64       # jittered-accumulator coin flip
STREAM_ENV_NEE_X = 65          # extra env-NEE directions (65..79)
NUM_STREAMS = 80

M32 = 0xFFFFFFFF


def _u32(x):
    """int or tensor -> its uint32 value (python int or int64 tensor)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & M32
    return torch.as_tensor(x).to(torch.int64) & M32


def pcg3d(x, y, z):
    """PCG3D hash on separate uint32-valued int64 planes."""
    x = (x * 1664525 + 1013904223) & M32
    y = (y * 1664525 + 1013904223) & M32
    z = (z * 1664525 + 1013904223) & M32
    x = (x + y * z) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    return x, y, z


def pcg4d(x, y, z, w):
    """PCG4D hash on separate uint32-valued int64 planes."""
    x = (x * 1664525 + 1013904223) & M32
    y = (y * 1664525 + 1013904223) & M32
    z = (z * 1664525 + 1013904223) & M32
    w = (w * 1664525 + 1013904223) & M32
    x = (x + y * w) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    w = (w + y * z) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    w = (w + y * z) & M32
    return x, y, z, w


def u32_to_unit_float(u):
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (u >> 8).to(torch.float32) * float(np.float32(1.0 / 16777216.0))


def _broadcast(v, like):
    if isinstance(v, int):
        return torch.full_like(like, v)
    return torch.broadcast_to(v, like.shape)


def uniform2_soa(lane_id, sample_index, bounce, stream, seed=0,
                 sampler="pcg"):
    """Two decorrelated uniforms per lane as separate (N,) tensors."""
    if sampler == "sobol":
        return sobol2_soa(lane_id, sample_index, bounce, stream, seed)
    lane = _u32(lane_id)
    mixed = (_u32(sample_index) * 9781 + _u32(seed) * 6271) & M32
    sb = (_u32(bounce) * NUM_STREAMS + _u32(stream)) & M32
    hx, hy, _ = pcg3d(lane, _broadcast(mixed, lane), _broadcast(sb, lane))
    return u32_to_unit_float(hx), u32_to_unit_float(hy)


def uniform(lane_id, sample_index, bounce, stream, seed=0, sampler="pcg"):
    """One uniform float in [0, 1) per lane."""
    return uniform2_soa(lane_id, sample_index, bounce, stream, seed,
                        sampler)[0]


def uniform2(lane_id, sample_index, bounce, stream, seed=0, sampler="pcg"):
    """Two decorrelated uniforms per lane in the row layout, (N, 2): the
    JAX package's cross-check form of uniform2_soa."""
    u, v = uniform2_soa(lane_id, sample_index, bounce, stream, seed,
                        sampler)
    return torch.stack([u, v], dim=-1)


# ----------------------------------------------------------------------------
# Owen-scrambled Sobol (0,2)-sequences, padded across streams (Burley,
# "Practical Hash-based Owen Scrambling", JCGT 2020).


def _reverse_bits_u32(b):
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    return ((b << 16) & M32) | (b >> 16)


def _laine_karras(x, lk_seed):
    x = (x + lk_seed) & M32
    x = x ^ ((x * 0x6C50B47C) & M32)
    x = x ^ ((x * 0xB82F1E52) & M32)
    x = x ^ ((x * 0xC7AFE638) & M32)
    x = x ^ ((x * 0x8D22F6E6) & M32)
    return x


def _owen_scramble(x, owen_seed):
    return _reverse_bits_u32(_laine_karras(_reverse_bits_u32(x), owen_seed))


def _sobol_dim1_columns():
    """Direction numbers for Sobol dimension 1 (x^2 + x + 1, m=[1,3])."""
    m = [1, 3]
    for k in range(2, 32):
        m.append((2 * m[-1]) ^ (4 * m[-2]) ^ m[-2])
    return [(mk << (31 - k)) & M32 for k, mk in enumerate(m)]


_SOBOL_DIM1 = _sobol_dim1_columns()


def _sobol2_point(index):
    x = _reverse_bits_u32(index)
    y = torch.zeros_like(index)
    for k in range(32):
        bit = (index >> k) & 1
        y = y ^ (bit * _SOBOL_DIM1[k])
    return x, y


def sobol2_soa(lane_id, sample_index, bounce, stream, seed=0):
    """Owen-scrambled Sobol (0,2) pair per lane as separate (N,) tensors."""
    lane = _u32(lane_id)
    sb = _broadcast((_u32(bounce) * NUM_STREAMS + _u32(stream)) & M32, lane)
    sd = _broadcast(_u32(seed), lane)
    s_shuf, s_x, s_y = pcg3d(lane, sb, sd)
    idx = _broadcast(_u32(sample_index), lane)
    x, y = _sobol2_point(_owen_scramble(idx, s_shuf))
    x = _owen_scramble(x, s_x)
    y = _owen_scramble(y, s_y)
    return u32_to_unit_float(x), u32_to_unit_float(y)


# ----------------------------------------------------------------------------
# Halton low-discrepancy sequences (RayGenCommon.h:49-69 semantics).


def radical_inverse_base2(i):
    b = _reverse_bits_u32(_u32(torch.as_tensor(i)))
    return b.to(torch.float32) * float(np.float32(2.3283064365386963e-10))


def halton(base: int, i, iters: int = 20):
    """Halton radical inverse in integer `base`, fixed iterations."""
    if base == 2:
        return radical_inverse_base2(i)
    i = torch.as_tensor(i).to(torch.int32).to(torch.int64)
    r = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = torch.ones(i.shape, dtype=torch.float32, device=i.device)
    for _ in range(iters):
        f = f / base
        r = r + f * torch.remainder(i, base).to(torch.float32)
        i = torch.div(i, base, rounding_mode="floor")
    return r


def halton23(i):
    """(Halton base 2, Halton base 3) pair, shape (..., 2)."""
    return torch.stack([halton(2, i), halton(3, i)], dim=-1)


def apply_lds_rotation(noise, frame_index):
    """Cranley-Patterson rotation, frac(noise + Halton23(frame)): how the
    reference turns static blue-noise textures into a progressive
    sequence (RayGenCommon.h:77-80). noise: (..., 2)."""
    shift = halton23(torch.as_tensor(frame_index, device=noise.device))
    return torch.remainder(noise + shift, 1.0)


def blue_noise_streams(blue0, blue1, px, py, frame_index):
    """The 4 blue-noise 2D streams of pixels (px, py) at frame_index
    (RayGenCommon.h:102-122): blue0/blue1 are (256, 256, 4) float32
    textures in [0, 1) (the reference's LDR_RGBA_0/1). Returns a dict of
    (N, 2) tensors. The wave takes the same values from
    wavefront.make_blue_noise_params and rotates them itself."""
    ix = torch.remainder(px, 256).to(torch.int64)
    iy = torch.remainder(py, 256).to(torch.int64)
    t0 = blue0[iy, ix]
    t1 = blue1[iy, ix]
    return {
        "primary_jitter": apply_lds_rotation(t0[..., 0:2], frame_index),
        "secondary_dir": apply_lds_rotation(t0[..., 2:4], frame_index),
        "area_light": apply_lds_rotation(t1[..., 0:2], frame_index),
        "dof": apply_lds_rotation(t1[..., 2:4], frame_index),
    }
