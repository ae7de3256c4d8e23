"""Multi-device scaling: pixel-tile and sample sharding over a mesh of
devices (tracerboy_tpu/parallel/sharding.py).

The JAX package shards over a jax.sharding.Mesh from one controller; this
port keeps that single-process API (Renderer(shard=) drives every device
from one host thread) and needs no torch.distributed:

- **Tile sharding**: the flat pixel-id pool (padded to a multiple of the
  mesh size) is split into contiguous chunks, one a mesh entry; each entry
  renders its chunk with render_wave on its own replica of the scene, and
  the per-ray outputs are concatenated on the first entry's device in mesh
  order, the "host readout" of the JAX docstring.
- **Sample (spp) sharding**: every entry traces the full pixel pool at its
  own sample indices (base + entry * samples_per_device + k); the
  accumulators (radiance, filter weight, rays_traced) are summed on the
  first entry's device in mesh order, where the JAX package psums, so
  the result is deterministic.

A mesh may name a device more than once (["cuda:0", "cuda:0"], ["cpu"] *
8, the counterpart of the JAX tests' 8 virtual CPU devices): each entry
still gets its own replica, so one card exercises the split, the padding
and the merge. Waves are issued entry by entry from the one host thread;
overlapping the entries of a machine with several cards is left to do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tracerboy_tpu_torch.trace.wavefront import (
    WaveConfig,
    render_wave,
    render_wave_merged,
)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its entries' torch devices, in order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None,
              device_type: str = "cuda") -> Mesh:
    """The mesh of `devices` (torch devices or names, repeats allowed), or
    of the first n_devices cards (default: all); with device_type "cpu",
    n_devices (default 1) entries of the CPU. Asking for more cards than
    torch.cuda.device_count() raises ValueError (the JAX package's
    devices[:n] would quietly give fewer)."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        count = torch.cuda.device_count()
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= count:
                raise ValueError(f"mesh device {d}: only {count} CUDA "
                                 "devices are visible")
        return Mesh(devs)
    if device_type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh needs at least one device, got {n}")
        return Mesh((torch.device("cpu"),) * n)
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise ValueError(f"asked for a mesh of {n} CUDA devices; "
                         f"{count} are visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def replicate(tree, device: torch.device):
    """A copy of a scene tree (nested dicts, lists, tuples of tensors and
    python values) with every tensor copied onto `device`, a clone where
    it already lives there."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, device) for v in tree)
    return tree


def shard_pixels(mesh: Mesh, width: int, height: int):
    """The flat pixel ids padded to a multiple of the mesh size, on the
    first entry's device, and the pad: entry i owns the i-th contiguous
    chunk (whole rows where the mesh divides the film)."""
    n = width * height
    pad = (-n) % mesh.size
    ids = torch.arange(n + pad, dtype=torch.int64, device=mesh.devices[0])
    return ids, pad


def _entry_params(params: dict, n_lanes: int, lanes: slice, device):
    """One entry's params: the per-lane ones (the blue-noise pre-gather
    "bn", "active_mask": a leading dimension of n_lanes, as the JAX
    package finds them) sliced to its chunk, every tensor on its device."""
    def one(x):
        if isinstance(x, torch.Tensor):
            if x.ndim >= 1 and x.shape[0] == n_lanes and lanes is not None:
                x = x[lanes]
            return x.to(device)
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        return x

    return {k: one(v) for k, v in params.items()}


def _sum_in_order(values, device):
    total = values[0]
    for v in values[1:]:
        total = total + v.to(device)
    return total


def render_wave_tiled(mesh: Mesh, replicas, params: dict, pixel_ids,
                      sample_index, cfg: WaveConfig) -> dict:
    """One sample of every pixel id with the pool split over the mesh:
    entry i renders the i-th chunk of pixel_ids on replicas[i] (the scene
    on mesh.devices[i]). Returns render_wave's outputs with the per-ray
    ones (AOVs included) concatenated on mesh.devices[0] in mesh order and
    the others (rays_traced, viz_rays) summed there in mesh order.
    pixel_ids: a multiple of mesh.size lanes (shard_pixels)."""
    D = mesh.size
    n_lanes = pixel_ids.shape[0]
    if n_lanes % D:
        raise ValueError(f"{n_lanes} lanes do not split over a mesh of {D} "
                         "(shard_pixels pads the pool)")
    chunk = n_lanes // D
    dev0 = mesh.devices[0]
    outs = []
    for i, (dev, scene) in enumerate(zip(mesh.devices, replicas)):
        lanes = slice(i * chunk, (i + 1) * chunk)
        sidx = sample_index
        if isinstance(sidx, torch.Tensor):
            sidx = (sidx[lanes] if sidx.ndim else sidx).to(dev)
        outs.append(render_wave(scene, _entry_params(params, n_lanes, lanes,
                                                     dev),
                                pixel_ids[lanes].to(dev), sidx, cfg))
    merged = {}
    for key, v in outs[0].items():
        vals = [o[key] for o in outs]
        if key != "viz_rays" and v.ndim >= 1 and v.shape[0] == chunk:
            merged[key] = torch.cat([x.to(dev0) for x in vals])
        else:
            merged[key] = _sum_in_order(vals, dev0)
    return merged


def render_spp_sharded(mesh: Mesh, replicas, params: dict, pixel_ids,
                       base_sample: int, cfg: WaveConfig,
                       samples_per_device: int = 1,
                       use_merged: bool = False):
    """Sample-sharded render step: entry i traces the full pixel pool at
    sample indices base_sample + i * samples_per_device + k on
    replicas[i], as ONE merged wave of samples_per_device samples
    (render_wave_merged) when use_merged and samples_per_device > 1, else
    as a loop of render_wave. The AOVs are not kept (per-pixel snapshots,
    not sums). Returns (radiance (N, 3), filter_weight (N,), rays_traced),
    each summed on mesh.devices[0] in mesh order."""
    spd = int(samples_per_device)
    dev0 = mesh.devices[0]
    rads, fws, rays = [], [], []
    for i, (dev, scene) in enumerate(zip(mesh.devices, replicas)):
        p = _entry_params(params, pixel_ids.shape[0], None, dev)
        ids = pixel_ids.to(dev)
        base = int(base_sample) + i * spd
        if use_merged and spd > 1:
            out = render_wave_merged(scene, p, ids, base, spd, cfg,
                                     aovs=False)
            rad, fw, nr = out["radiance"], out["filter_weight"], \
                out["rays_traced"]
        else:
            rad = fw = nr = None
            for k in range(spd):
                out = render_wave(scene, p, ids, base + k, cfg, aov_lanes=0)
                if rad is None:
                    rad, fw, nr = (out["radiance"], out["filter_weight"],
                                   out["rays_traced"])
                else:
                    rad = rad + out["radiance"]
                    fw = fw + out["filter_weight"]
                    nr = nr + out["rays_traced"]
        rads.append(rad)
        fws.append(fw)
        rays.append(nr)
    return (_sum_in_order(rads, dev0), _sum_in_order(fws, dev0),
            _sum_in_order(rays, dev0))
