"""The fallback of the port's binned backend (trace/binned.py): rays that
enter more clusters than the K = 16 the selection keeps, against the JAX
package and the whole-tree traversal.

- tests/test_binned.py's 40-slab overflow scene: binned_closest against
  the JAX binned_closest (Pallas interpret mode) and against the port's
  closest_hit, to test_torch_binned.py's tolerances; the fallback runs.
- A scene of 64 slabs of 128 triangles, one slab per cluster, each slab a
  ring around the x axis except slab 20, which covers it. Rays along +x
  near the axis enter all 64 clusters; the 16 nearest hold no hit, and
  the hit is at x = 200. The port's selection folds the clusters it
  prunes into `dropped`, so the fallback finds the hit. The JAX
  package's selection folds only evicted slots and leaves rejected
  within one node: it prunes slab 16's node whole and reports nothing
  dropped, and its binned_closest returns a miss on every ray. That is
  a fault of the reference (ROADMAP.md Queue 3), pinned here: the test
  fails once the reference finds these hits.
- Under the `cuda` marker: the same scene through the kernels.
"""

import numpy as np
import pytest
import torch

from test_torch_binned import (
    _t,
    assert_matches_jax,
    jax_scene,
    make_scene,
    port_tables,
)
from tracerboy_tpu_torch.trace import binned, kernels, traverse

torch.set_num_threads(2)

N_RAYS = 2048


def slab_scene(rng):
    """tests/test_binned.py's overflow scene: 40 thin slabs of 128 random
    triangles along +x, and rays marching down +x through all of them."""
    tris = []
    for s in range(40):
        base = np.float32(s * 10.0)
        v0, v1, v2 = make_scene(rng, 128)
        for v in (v0, v1, v2):
            v[:, 0] = v[:, 0] * 0.02 + base
        tris.append((v0, v1, v2))
    tris = tuple(np.concatenate([t[k] for t in tris]) for k in range(3))
    o = np.stack([np.full(N_RAYS, -5.0), rng.random(N_RAYS) * 8 - 4,
                  rng.random(N_RAYS) * 8 - 4], 1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.001, 0.001]], np.float32), (N_RAYS, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, (o, d, np.full(N_RAYS, 1e30, np.float32))


def ring_scene(n_slabs=64, hit_slab=20):
    """Slabs of 128 triangles in the planes x = 10 s, each a fan of
    triangles between radii 1 and 4 around the x axis, but slab
    `hit_slab` fans out from the axis itself. Returns the triangles and
    their packed 9-float rows, one slab per 128-triangle cluster."""
    ang = np.linspace(0, 2 * np.pi, 129)[:-1]
    v0s, v1s, v2s = [], [], []
    for s in range(n_slabs):
        x = np.full(128, 10.0 * s)
        r0 = 0.0 if s == hit_slab else 1.0
        a1 = ang + 2 * np.pi / 128
        v0s.append(np.stack([x, r0 * np.cos(ang), r0 * np.sin(ang)], 1))
        v1s.append(np.stack([x, 4 * np.cos(ang), 4 * np.sin(ang)], 1))
        v2s.append(np.stack([x, 4 * np.cos(a1), 4 * np.sin(a1)], 1))
    tris = tuple(np.concatenate(v).astype(np.float32)
                 for v in (v0s, v1s, v2s))
    rows = np.zeros((n_slabs * 16, 128), np.float32)
    rows[:, :72] = np.concatenate(tris, axis=1).reshape(-1, 72)
    return tris, rows


def ring_rays(rng):
    o = np.stack([np.full(N_RAYS, -5.0), rng.random(N_RAYS) * 0.6 - 0.3,
                  rng.random(N_RAYS) * 0.6 - 0.3], 1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (N_RAYS, 1))
    return o, d, np.full(N_RAYS, 1e30, np.float32)


def test_overflow_scene_falls_back_like_jax():
    import jax.numpy as jnp

    from tracerboy_tpu.trace.binned import binned_closest as jbinned

    tris, rays = slab_scene(np.random.default_rng(1234))
    _, scene = port_tables(*tris)
    _, jscene = jax_scene(*tris)
    o, d, tm = (_t(x) for x in rays)
    binned.reset_stats()
    got = binned.binned_closest(scene, o, d, tm)
    assert int(binned.STATS["fallback_rays"]) > 0
    ref = jbinned(jscene, *(jnp.asarray(x) for x in rays), interpret=True)
    assert_matches_jax(ref, got)
    assert_matches_jax(traverse.closest_hit(o, d, tm, scene["pk_nodes"],
                                            scene["pk_tris_bw"]), got)


def _ring_tables():
    """Binned tables from the ring scene's rows (one slab per cluster);
    the fallback's packed BVH over the same triangles numbers them
    otherwise, so only t and the hit mask are compared."""
    tris, rows = ring_scene()
    _, scene = port_tables(*tris)
    scene.update({k: _t(v) for k, v in
                  binned.pack_scene_binned(rows).items()})
    return tris, rows, scene


def test_reference_misses_hits_beyond_its_k_nearest():
    import jax.numpy as jnp

    from tracerboy_tpu.trace.binned import binned_closest as jbinned
    from tracerboy_tpu.trace.binned import pack_scene_binned as jpack

    tris, rows, scene = _ring_tables()
    rays = ring_rays(np.random.default_rng(0))
    o, d, tm = (_t(x) for x in rays)
    # The port: dropped = 165 (slab 16's entry t) sends every ray to the
    # fallback, which finds slab 20 at t = 205.
    _, slot_c, dropped = binned.select_clusters(o, d, tm, scene["bn_nodes"])
    assert (dropped == 165.0).all()
    binned.reset_stats()
    t, tri, _, _ = binned.binned_closest(scene, o, d, tm)
    assert int(binned.STATS["fallback_rays"]) == N_RAYS
    assert (tri >= 0).all() and ((t - 205.0).abs() <= 1e-4).all()
    want = traverse.closest_hit(o, d, tm, scene["pk_nodes"],
                                scene["pk_tris_bw"])
    assert torch.equal(t, want[0])
    # The reference: no hit on any ray.
    _, jscene = jax_scene(*tris)
    jscene.update(jpack(rows))
    jt, jtri, _, _ = jbinned(jscene, *(jnp.asarray(x) for x in rays),
                             interpret=True)
    assert (np.asarray(jtri) == -1).all(), (
        "the JAX binned_closest now finds these hits: update ROADMAP.md "
        "Queue 3 and this test")
    assert (np.asarray(jt) == np.float32(1e30)).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fallback_scenes_on_the_card(cuda_device):
    dev = cuda_device
    _, _, scene = _ring_tables()
    scene = {k: v.to(dev) for k, v in scene.items()}
    o, d, tm = (_t(x).to(dev) for x in ring_rays(np.random.default_rng(0)))
    kernels.reset_counters()
    _, _, dropped = binned.select_clusters(o, d, tm, scene["bn_nodes"])
    assert (dropped == 165.0).all()
    t, tri, _, _ = binned.binned_closest(scene, o, d, tm)
    assert (tri >= 0).all() and ((t - 205.0).abs() <= 1e-4).all()
    tris, rays = slab_scene(np.random.default_rng(1234))
    _, scene = port_tables(*tris)
    scene = {k: v.to(dev) for k, v in scene.items()}
    o, d, tm = (_t(x).to(dev) for x in rays)
    got = binned.binned_closest(scene, o, d, tm)
    want = traverse.closest_hit(o, d, tm, scene["pk_nodes"],
                                scene["pk_tris_bw"])
    torch.cuda.synchronize()
    assert torch.equal(got[1] >= 0, want[1] >= 0)
    assert kernels.LAUNCHES["select"] == 3 and kernels.stack_overflows() == 0
