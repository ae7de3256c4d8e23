"""The port's on-device LBVH build (tracerboy_tpu_torch/accel/bvh_device.py)
against the JAX package's (tracerboy_tpu/accel/bvh_device.py) on the same
seeded triangle soups, on the CPU.

- Morton codes, tri_order, children, num_wide and the bounds: bit-equal.
- pack_for_pallas_device: nodes and tri_map bit-equal. tris_bw is not:
  XLA's CPU code contracts the cross products of the Baldwin-Weber rows
  into fused multiply-adds (jnp.cross's a1*b2 - a2*b1 is computed as
  fma(a1, b2, -(a2*b1)): test_xla_contracts_the_cross_product pins it),
  and torch rounds both products. The rows differ in the last bits of
  about half the values, by at most 2e-5 of max(|value|, 1) on these
  soups; both are within the JAX test's bound (2e-4) of the float64 host
  pack.
- validate_bvh finds nothing, and the closest hits through the packed
  tables equal the port's brute force (the JAX test's bar).
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.accel import bvh_device as port
from tracerboy_tpu_torch.accel.pack import bw_rows, pack_bvh
from tracerboy_tpu_torch.accel.validate import validate_bvh
from tracerboy_tpu_torch.core import vec3 as v3
from tracerboy_tpu_torch.trace import traverse
from tracerboy_tpu_torch.trace.intersect import BIG, brute_force_closest_soa


def random_soup(rng, n, spread=10.0, size=0.4):
    base = (rng.random((n, 3), np.float32) - 0.5) * spread
    e1 = rng.standard_normal((n, 3)).astype(np.float32) * size
    e2 = rng.standard_normal((n, 3)).astype(np.float32) * size
    return base, base + e1, base + e2


def common_centroid(rng, n=64):
    """Every triangle's centroid at the origin: all morton codes equal, so
    the index tie-break builds the whole tree."""
    e1 = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    e2 = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    return e1, e2, -(e1 + e2)      # v0 + v1 + v2 == 0 exactly


def single_cluster(rng):
    return random_soup(rng, 3)


SOUPS = {
    "soup5": lambda rng: random_soup(rng, 5),
    "soup300": lambda rng: random_soup(rng, 300),
    "soup5000": lambda rng: random_soup(rng, 5000),
    "common_centroid": common_centroid,
    "single_cluster": single_cluster,
}
BW_REL = 2e-5     # port vs JAX tris_bw, of max(|value|, 1)


def make_rays(rng, n, v, spread=18.0):
    """n rays from random origins: half in random directions, half toward
    a point inside a random triangle."""
    o = (rng.random((n, 3), np.float32) - 0.5) * spread
    d = rng.standard_normal((n, 3)).astype(np.float32)
    k = rng.integers(0, v[0].shape[0], n // 2)
    b = rng.dirichlet((1.0, 1.0, 1.0), n // 2).astype(np.float32)
    target = b[:, :1] * v[0][k] + b[:, 1:2] * v[1][k] + b[:, 2:] * v[2][k]
    d[: n // 2] = target - o[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def jax_build(v):
    import jax
    import jax.numpy as jnp

    from tracerboy_tpu.accel import bvh_device as ref

    @jax.jit
    def codes(v0, v1, v2):
        """The build's morton codes, from its own expressions."""
        c = (v0 + v1 + v2) * (1.0 / 3.0)
        lo = jnp.minimum(jnp.minimum(v0, v1), v2).min(axis=0)
        hi = jnp.maximum(jnp.maximum(v0, v1), v2).max(axis=0)
        q = jnp.clip((c - lo) / jnp.maximum(hi - lo, 1e-12) * 1023.0, 0.0,
                     1023.0).astype(jnp.uint32)
        return ref.morton30(q[:, 0], q[:, 1], q[:, 2])

    jv = [jnp.asarray(x) for x in v]
    built = ref.build_bvh_device(*jv)
    pk = ref.pack_for_pallas_device(built, *jv)
    codes = codes(*jv)
    return jax.tree_util.tree_map(np.asarray, (built, pk, codes))


def port_build(v):
    t = [torch.from_numpy(x) for x in v]
    built = port.build_bvh_device(*t)
    return built, port.pack_for_pallas_device(built, *t)


@pytest.fixture(scope="module", params=sorted(SOUPS))
def case(request):
    rng = np.random.default_rng(sorted(SOUPS).index(request.param) + 11)
    v = SOUPS[request.param](rng)
    return request.param, v, jax_build(v), port_build(v)


def test_build_is_bit_equal_to_jax(case):
    _, v, (ref, _, _), (built, _) = case
    assert set(built) == set(ref)
    for key, val in ref.items():
        got = built[key].numpy()
        assert got.dtype == val.dtype and got.shape == val.shape, key
        assert np.array_equal(got, val), key
    assert built["num_wide"].dim() == 0


def test_morton_codes_are_bit_equal(case):
    _, v, (_, _, codes), _ = case
    t = [torch.from_numpy(x) for x in v]
    c = (t[0] + t[1] + t[2]) * (1.0 / 3.0)
    lo = torch.minimum(torch.minimum(t[0], t[1]), t[2]).amin(0)
    hi = torch.maximum(torch.maximum(t[0], t[1]), t[2]).amax(0)
    q = torch.clamp((c - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
    got = port.morton30(q[:, 0], q[:, 1], q[:, 2])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), codes)


def test_pack_matches_jax(case):
    _, v, (_, ref_pk, _), (_, pk) = case
    assert np.array_equal(pk["nodes"].numpy(), ref_pk["nodes"])
    assert np.array_equal(pk["tri_map"].numpy(), ref_pk["tri_map"])
    a, b = ref_pk["tris_bw"], pk["tris_bw"].numpy()
    scale = np.maximum(np.abs(a), 1.0)
    assert (np.abs(a - b) <= BW_REL * scale).all()
    # Both against the float64 host rows of the same order, within the
    # JAX test's bound.
    order = pk["tri_map"].numpy()
    C = order.shape[0] // 8
    f64 = np.zeros((C, 128), np.float32)
    f64[:, :96] = bw_rows(*(x.astype(np.float64)[order] for x in v)
                          ).reshape(C, 96)
    np.testing.assert_allclose(b, f64, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(a, f64, rtol=2e-4, atol=2e-4)


def test_device_pack_equals_host_pack_of_the_same_tree(case):
    name, v, _, (built, pk) = case
    host = pack_bvh(port.to_host_widebvh(built, v[0].shape[0]), *v)
    W = int(built["num_wide"])
    assert np.array_equal(pk["nodes"].numpy()[:W], host["nodes"])
    assert np.array_equal(pk["tri_map"].numpy(), host["tri_map"])
    np.testing.assert_allclose(pk["tris_bw"].numpy(), host["tris_bw"],
                               rtol=2e-4, atol=2e-4)
    # Rows past num_wide are never reached: empty nodes.
    assert (pk["nodes"][W:, 48:56] == int(port.INVALID)).all()


def test_valid_and_hits_equal_brute_force(case):
    name, v, _, (built, pk) = case
    n = v[0].shape[0]
    assert validate_bvh(port.to_host_widebvh(built, n), *v) == []
    rng = np.random.default_rng(5)
    o, d = make_rays(rng, 512, v, spread=4.0 if name == "common_centroid"
                     else 18.0)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tm = torch.full((o.shape[0],), BIG, dtype=torch.float32)
    t, tri, _, _ = traverse.closest_hit(ot, dt, tm, pk["nodes"],
                                        pk["tris_bw"])
    tris = torch.from_numpy(np.concatenate(v, axis=1))
    t_ref, tri_ref, _, _ = brute_force_closest_soa(
        v3.from_rows(ot), v3.from_rows(dt), tris)
    hit, hit_ref = tri.numpy() >= 0, tri_ref.numpy() >= 0
    assert not np.any(hit_ref & ~hit), "the device-built BVH missed a hit"
    assert (hit == hit_ref).mean() > 0.999
    both = hit & hit_ref
    np.testing.assert_allclose(t.numpy()[both], t_ref.numpy()[both],
                               rtol=1e-3, atol=1e-4)
    # The packed id maps back to the brute-force triangle.
    mapped = pk["tri_map"].numpy()[tri.numpy()[both]]
    assert both.sum() > 64
    assert (mapped == tri_ref.numpy()[both]).mean() > 0.99


def test_xla_contracts_the_cross_product():
    """Why tris_bw is not bit-equal: XLA's CPU jnp.cross is
    fma(a1, b2, -(a2 * b1)) (the product rounded once), torch's the
    difference of two rounded products."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((4096, 3)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(jnp.cross(jnp.asarray(a), jnp.asarray(b)))[:, 0]
    fma = (a[:, 1].astype(np.float64) * b[:, 2]
           - (a[:, 2] * b[:, 1]).astype(np.float64)).astype(np.float32)
    two = port._cross(torch.from_numpy(a), torch.from_numpy(b))[:, 0]
    assert np.array_equal(ref, fma)
    assert not np.array_equal(ref, two.numpy())
    assert np.array_equal(two.numpy(), a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1])


def test_build_keeps_fixed_trip_counts():
    """The build makes the same torch calls whatever the triangles: no
    loop asks the device whether it is done (a host sync a step)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    # Sizes with the same padding of tri_order (4 rows).
    for n, seed in ((300, 1), (300, 2), (5004, 3)):
        v = [torch.from_numpy(x) for x in
             random_soup(np.random.default_rng(seed), n)]
        with Count() as c:
            built = port.build_bvh_device(*v)
            port.pack_for_pallas_device(built, *v)
        counts.append(c.n)
    assert counts[0] == counts[1] == counts[2], counts


def test_to_host_widebvh_reads_num_wide():
    v = random_soup(np.random.default_rng(9), 700)
    built, _ = port_build(v)
    bvh = port.to_host_widebvh(built, 700)
    assert bvh.num_nodes == int(built["num_wide"]) < built["children"].shape[0]
    assert bvh.num_clusters == 88 and bvh.num_tris == 700
    assert bvh.tri_order.dtype == np.int64


def _slots(bvh, leaf):
    """(node, slot) of every leaf (or inner) child, in order."""
    ch = bvh.children
    kind = (ch < 0) & (ch != int(port.INVALID)) if leaf else ch >= 0
    return [tuple(int(i) for i in ws) for ws in np.argwhere(kind)]


def _shrink(bvh, leaf):
    w, s = _slots(bvh, leaf)[0]
    bvh.bounds_hi[w, s] = (bvh.bounds_lo[w, s] + bvh.bounds_hi[w, s]) / 2


def _set_child(bvh, leaf, value):
    w, s = _slots(bvh, leaf)[1]
    bvh.children[w, s] = value(bvh)


def _share_child(bvh):
    """A second slot points at the first inner slot's child."""
    (w0, s0), (w1, s1) = _slots(bvh, False)[:2]
    bvh.children[w1, s1] = bvh.children[w0, s0]


def _repeat_cluster(bvh):
    (w0, s0), (w1, s1) = _slots(bvh, True)[:2]
    bvh.children[w1, s1] = bvh.children[w0, s0]


# Each fault, and a violation message that names it.
CORRUPTIONS = {
    "shrink_leaf_box": (lambda b: _shrink(b, True), "leaf cluster"),
    "shrink_inner_box": (lambda b: _shrink(b, False), "inner child"),
    "drop_leaf": (lambda b: _set_child(b, True, lambda b: port.INVALID),
                  "unreachable leaf clusters"),
    "drop_inner": (lambda b: _set_child(b, False, lambda b: port.INVALID),
                   "orphan wide nodes"),
    "shared_child": (_share_child, "nodes with multiple parents"),
    "repeated_cluster": (_repeat_cluster,
                         "clusters referenced more than once"),
    "child_out_of_range": (
        lambda b: _set_child(b, False, lambda b: b.num_nodes),
        "out of range"),
    "cluster_out_of_range": (
        lambda b: _set_child(b, True, lambda b: -b.num_clusters - 1),
        "out of range"),
}


@pytest.mark.parametrize("fault", sorted(CORRUPTIONS))
def test_validate_finds_what_jax_finds(fault):
    """validate_bvh, a copy of the JAX module, held against it on a tree
    that the device build made and a fault then broke: both report the
    same violations, and they name the fault."""
    import dataclasses

    from tracerboy_tpu.accel.bvh import WideBVH as JaxWideBVH
    from tracerboy_tpu.accel.validate import validate_bvh as jax_validate

    v = random_soup(np.random.default_rng(21), 2000)
    built, _ = port_build(v)
    bvh = port.to_host_widebvh(built, v[0].shape[0])
    assert validate_bvh(bvh, *v) == []
    assert len(_slots(bvh, False)) >= 2 and len(_slots(bvh, True)) >= 2
    broken = dataclasses.replace(
        bvh, bounds_lo=bvh.bounds_lo.copy(), bounds_hi=bvh.bounds_hi.copy(),
        children=bvh.children.copy())
    corrupt, names = CORRUPTIONS[fault]
    corrupt(broken)
    got = validate_bvh(broken, *v)
    want = jax_validate(JaxWideBVH(**dataclasses.asdict(broken)), *v)
    assert got == want
    assert got and any(names in e for e in got), got
