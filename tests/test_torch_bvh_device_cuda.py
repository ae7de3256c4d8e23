"""The on-device LBVH build (accel/bvh_device.py) on the card, and kernels 1
and 2 on the tables it builds.

- The card's build of a seeded soup equals the port's CPU build of the
  same soup bit for bit in every integer table (codes' order, children,
  tri_order, num_wide, packed nodes, tri_map) and every bound; the
  Baldwin-Weber rows within 2e-5 of max(|value|, 1) (the reductions of
  the dot products may round otherwise on the card).
- closest_hit and any_hit (kernels 1 and 2, csrc/bvh_traverse.cu) on the
  rebuilt tables against their plain versions on the same rays: hits
  equal, t to 1e-6 relative, ids equal outside 1e-4 of the hits,
  occlusion equal, no stack overflow.
- Renderer.update_geometry on the card: the new tables are CUDA tensors,
  no host builder runs, and a render after it launches both kernels.

Every test is under the `cuda` marker (skipped without a card). This
module imports no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_bvh_device_cuda.py`.
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.accel import bvh_device
from tracerboy_tpu_torch.trace import kernels, traverse

BW_REL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def soup(n, seed):
    rng = np.random.default_rng(seed)
    base = (rng.random((n, 3), np.float32) - 0.5) * 10.0
    e1 = rng.standard_normal((n, 3)).astype(np.float32) * 0.4
    e2 = rng.standard_normal((n, 3)).astype(np.float32) * 0.4
    return base, base + e1, base + e2


def rays(v, n, seed):
    """Half random, half aimed into random triangles; a tenth dead."""
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3), np.float32) - 0.5) * 18.0
    d = rng.standard_normal((n, 3)).astype(np.float32)
    k = rng.integers(0, v[0].shape[0], n // 2)
    b = rng.dirichlet((1.0, 1.0, 1.0), n // 2).astype(np.float32)
    d[: n // 2] = (b[:, :1] * v[0][k] + b[:, 1:2] * v[1][k]
                   + b[:, 2:] * v[2][k]) - o[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(rng.random(n) < 0.1, 0.0,
                  np.where(rng.random(n) < 0.5, 1e30, rng.random(n) * 12.0))
    return o, d, tm.astype(np.float32)


def build(v, device):
    t = [torch.from_numpy(x).to(device) for x in v]
    built = bvh_device.build_bvh_device(*t)
    return built, bvh_device.pack_for_pallas_device(built, *t)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 300, 5000, 133_970])
def test_card_build_equals_cpu_build(cuda_device, n):
    v = soup(n, n)
    cpu, cpu_pk = build(v, "cpu")
    gpu, gpu_pk = build(v, cuda_device)
    assert gpu["children"].device.type == "cuda"
    for key in ("bounds_lo", "bounds_hi", "children", "tri_order",
                "num_wide", "world_lo", "world_hi"):
        assert torch.equal(gpu[key].cpu(), cpu[key]), key
    for key in ("nodes", "tri_map"):
        assert torch.equal(gpu_pk[key].cpu(), cpu_pk[key]), key
    a, b = cpu_pk["tris_bw"], gpu_pk["tris_bw"].cpu()
    assert ((a - b).abs() <= BW_REL * a.abs().clamp_min(1.0)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 50_000])
def test_kernels_on_rebuilt_tables_equal_their_plain_versions(cuda_device,
                                                              n):
    v = soup(n, 7)
    _, pk = build(v, cuda_device)
    o, d, tm = (torch.from_numpy(x).to(cuda_device)
                for x in rays(v, 65_536, 3))
    kernels.reset_counters()
    t_k, tri_k, _, _ = traverse.closest_hit(o, d, tm, pk["nodes"],
                                            pk["tris_bw"])
    occ_k = traverse.any_hit(o, d, tm, pk["nodes"], pk["tris_bw"])
    assert kernels.LAUNCHES["closest"] == 1 == kernels.LAUNCHES["anyhit"]
    assert kernels.stack_overflows() == 0
    t_p, tri_p, _, _ = traverse.closest_hit_plain(o, d, tm, pk["nodes"],
                                                  pk["tris_bw"])
    occ_p = traverse.anyhit_plain(o, d, tm, pk["nodes"], pk["tris_bw"])
    hit = tri_p >= 0
    assert hit.float().mean().item() > 0.2
    assert torch.equal(tri_k >= 0, hit)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[hit]
    assert rel.max().item() <= 1e-6
    assert (tri_k != tri_p)[hit].float().mean().item() <= 1e-4
    assert torch.equal(occ_k.bool(), occ_p.bool())


@pytest.mark.cuda
def test_update_geometry_rebuilds_on_the_card(cuda_device, monkeypatch):
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.accel import native, pack

    r = Renderer("shadertoy", film_size=(64, 48), device="cuda")
    assert r.traversal == "kernel"

    def no_host_build(*args, **kwargs):
        raise AssertionError("a host BVH builder ran")

    monkeypatch.setattr(native, "build_bvh_native", no_host_build)
    monkeypatch.setattr(pack, "pack_scene", no_host_build)
    sc = r.scene
    r.update_geometry(sc["tri_v0"] * 1.001, sc["tri_v1"] * 1.001,
                      sc["tri_v2"] * 1.001)
    for key in ("pk_nodes", "pk_tris_bw", "pk_tri_map", "pk_attr_rows",
                "pk_sh_nodes", "pk_sh_tris_bw", "pk_sh_tri_map",
                "pk_sh_attr_rows", "tri9", "tri_attr_rows"):
        assert r.scene[key].device.type == "cuda", key
    kernels.reset_counters()
    r.render_sample(1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["closest"] > 0 and kernels.LAUNCHES["anyhit"] > 0
    assert kernels.stack_overflows() == 0
    assert torch.isfinite(r.state.accum).all()
