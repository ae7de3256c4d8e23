"""Next-event estimation: one light sample per shading point, uniform or
RIS (tracerboy_tpu/shade/nee.py: sample_one_light_soa; the reference's
GetOneLightSample, RayGenCommon.h:170-261).

Uniform: pick a light uniformly, sample a barycentric point, pdf =
1 / (light_count * area) for area lights (1 / light_count directional),
attenuation = 1/d^2. RIS: 16 candidates with target area * luma(L) / d^2
and a streaming reservoir pick.
"""

from __future__ import annotations

import torch

from tracerboy_tpu_torch.core import rng as tbrng
from tracerboy_tpu_torch.core import vec3 as v3

RIS_CANDIDATES = 16


def sample_one_light_soa(lights, num_lights: int, position, lane_id,
                         sample_index, bounce, use_ris: bool = False,
                         seed=0, sampler="pcg"):
    """Returns dict(direction V3, color V3, pdf, normal V3, attenuation,
    distance); pdf is in the reference's area measure, so the caller's
    weight is atten * brdf * |dot(light_n, dir)| / pdf."""
    N = position.x.shape[0]
    dev = position.x.device
    zero = torch.zeros((N,), dtype=torch.float32, device=dev)
    if num_lights == 0:
        z3 = v3.V3(zero, zero, zero)
        return dict(direction=z3, color=z3, pdf=zero, normal=z3,
                    attenuation=zero, distance=zero)

    def rows_of(idx):
        return {k: lights[k][idx] for k in lights}

    def point_of(row, bu, bv, bw):
        p0, p1, p2 = row["p0"], row["p1"], row["p2"]
        n0, n1, n2 = row["n0"], row["n1"], row["n2"]
        p = v3.V3(*(p0[:, k] * bu + p1[:, k] * bv + p2[:, k] * bw
                    for k in range(3)))
        n = v3.V3(*(n0[:, k] * bu + n1[:, k] * bv + n2[:, k] * bw
                    for k in range(3)))
        return p, n

    def finalize(row, bu, bv, bw, pdf):
        lp, ln = point_of(row, bu, bv, bw)
        to_light = lp - position
        dist = torch.sqrt(torch.clamp_min(v3.dot(to_light, to_light),
                                          1e-12))
        direction = to_light * (1.0 / dist)
        atten = 1.0 / torch.clamp_min(dist * dist, 1e-12)
        ld = row["direction"]
        ldir = v3.V3(ld[:, 0], ld[:, 1], ld[:, 2])
        is_dir = row["ltype"] == 1
        direction = v3.where(is_dir, -ldir, direction)
        ln = v3.where(is_dir, ldir, ln)
        atten = torch.where(is_dir, 1.0, atten)
        dist = torch.where(is_dir, 1e9, dist)
        col = row["color"]
        return dict(direction=direction,
                    color=v3.V3(col[:, 0], col[:, 1], col[:, 2]),
                    pdf=pdf, normal=ln, attenuation=atten, distance=dist)

    def bary(r0, r1):
        flip = (r0 + r1) > 1.0
        u = torch.where(flip, 1.0 - r0, r0)
        v = torch.where(flip, 1.0 - r1, r1)
        return u, v, 1.0 - u - v

    def pick(stream):
        r = tbrng.uniform(lane_id, sample_index, bounce, stream, seed,
                          sampler)
        return torch.clamp_max((r * num_lights).to(torch.int64),
                               num_lights - 1)

    if not use_ris:
        idx = pick(tbrng.STREAM_LIGHT_SELECT)
        b0, b1 = tbrng.uniform2_soa(lane_id, sample_index, bounce,
                                    tbrng.STREAM_AREA_LIGHT, seed, sampler)
        bu, bv, bw = bary(b0, b1)
        row = rows_of(idx)
        pdf = 1.0 / num_lights
        pdf = torch.where(row["ltype"] == 0,
                          pdf / torch.clamp_min(row["area"], 1e-12), pdf)
        return finalize(row, bu, bv, bw, pdf)

    cand = []
    wsum = zero
    for c in range(RIS_CANDIDATES):
        idx = pick(tbrng.STREAM_RIS + 2 * c)
        b0, b1 = tbrng.uniform2_soa(lane_id, sample_index, bounce,
                                    tbrng.STREAM_RIS + 2 * c + 1, seed,
                                    sampler)
        bu, bv, bw = bary(b0, b1)
        row = rows_of(idx)
        lp, _ = point_of(row, bu, bv, bw)
        dd = lp - position
        d2 = torch.clamp_min(v3.dot(dd, dd), 1e-6)
        col = row["color"]
        luma = 0.2126 * col[:, 0] + 0.7152 * col[:, 1] + 0.0722 * col[:, 2]
        target = row["area"] * luma / d2
        w = target * num_lights / RIS_CANDIDATES
        cand.append((idx, bu, bv, bw, w, target))
        wsum = wsum + w

    u = tbrng.uniform(lane_id, sample_index, bounce,
                      tbrng.STREAM_RIS + 2 * RIS_CANDIDATES, seed, sampler)
    thresh = u * wsum
    run = zero
    sel_idx = torch.zeros((N,), dtype=torch.int64, device=dev)
    sel = [zero, zero, zero, zero]  # bu, bv, bw, target
    chosen = torch.zeros((N,), dtype=torch.bool, device=dev)
    for idx, bu, bv, bw, w, target in cand:
        run = run + w
        take = (~chosen) & (run >= thresh)
        sel_idx = torch.where(take, idx, sel_idx)
        sel = [torch.where(take, a, b)
               for a, b in zip((bu, bv, bw, target), sel)]
        chosen = chosen | take

    row = rows_of(sel_idx)
    area = torch.clamp_min(row["area"], 1e-12)
    ris_pdf = sel[3] / torch.clamp_min(wsum, 1e-12) / area
    out = finalize(row, sel[0], sel[1], sel[2], ris_pdf)
    out["pdf"] = torch.where(wsum <= 0.0, 0.0, out["pdf"])
    return out


def sample_one_light(lights, num_lights: int, position, lane_id,
                     sample_index, bounce, use_ris: bool = False, seed=0,
                     sampler="pcg"):
    """The light sample in the row layout (the JAX package's cross-check
    form of sample_one_light_soa): position (N, 3); returns (N, 3)
    direction, color, normal and (N,) pdf, attenuation, distance."""
    pos = v3.V3(position[:, 0], position[:, 1], position[:, 2])
    out = sample_one_light_soa(lights, num_lights, pos, lane_id,
                               sample_index, bounce, use_ris, seed, sampler)
    return {k: v3.to_rows(v) if isinstance(v, v3.V3) else v
            for k, v in out.items()}
