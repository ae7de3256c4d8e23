"""The row-layout (AoS) helpers that no path of either renderer calls, in
the port against the JAX package's functions of the same names: the BSDF
samplers and weights of shade/bsdf.py, the (..., 3) helpers of
core/mathutil.py, the V3 helpers of core/vec3.py, the brute-force
oracles of trace/intersect.py, trace/instanced.pack_instanced, and
accel/native.py's native_available and build_bvh_auto.

The same inputs, made from a seed with numpy, go through both.
Tolerance: bit-equal where the helper is a single float32 elementwise op
or a copy (splat, full_like, min_c, all_lt, make_affine, and every
boolean result); otherwise atol=1e-6, rtol=1e-5 (transcendentals and
reductions that XLA and torch may round differently). The brute-force
oracles agree on hits, ids and occlusion, t, u and v to the same
tolerance; the BVH builders give the JAX package's tables bit for bit.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N = 64
ATOL, RTOL = 1e-6, 1e-5


def _inputs(seed=20261017):
    rng = np.random.default_rng(seed)

    def unit(n=N):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    def uni(lo=0.0, hi=1.0, shape=(N,)):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    a, b = unit(), unit()
    b[:4] = -a[:4]                       # opposite pairs: the normal
    return dict(
        n=unit(), a=a, b=b, d=unit(), r0=uni(), r1=uni(),
        rough=uni(0.0, 1.0), ior0=uni(1.0, 1.6), ior1=uni(1.0, 2.4),
        nr=uni(0.4, 1.6), rgb=uni(0.0, 1.0, (N, 3)),
        mfp=uni(0.05, 2.0, (N, 3)), phi=uni(0.0, np.pi),
        theta=uni(0.0, 2 * np.pi), m=rng.normal(size=(3, 4)).astype(
            np.float32), p=rng.normal(size=(N, 3)).astype(np.float32),
        lin=rng.normal(size=(3, 3)), tr=rng.normal(size=3))


X = _inputs()
# name -> (module, arguments by key of X or a literal, exact)
CASES = {
    "bsdf.fresnel_factor": ("shade.bsdf", ["ior0", "ior1", "n", "d"], False),
    "bsdf.ggx_ndf": ("shade.bsdf", ["n", "a", "rough"], False),
    "bsdf.diffuse_brdf": ("shade.bsdf", ["d", "n"], False),
    "bsdf.half_vector_safe": ("shade.bsdf", ["a", "b", "n"], False),
    "bsdf.sample_cosine_hemisphere": ("shade.bsdf", ["n", "r0", "r1"], False),
    "bsdf.sample_ggx_reflection": ("shade.bsdf", ["d", "n", "rough", "r0",
                                                  "r1"], False),
    "bsdf.ggx_reflection_pdf": ("shade.bsdf", ["n", "b", "a", "rough"],
                                False),
    "bsdf.sample_pow_lobe": ("shade.bsdf", ["n", "rough", "r0", "r1"], False),
    "bsdf.sample_uniform_sphere": ("shade.bsdf", ["r0", "r1"], False),
    "bsdf.specular_weight": ("shade.bsdf", ["d", "a", "n", "b", "rough"],
                             False),
    "bsdf.artist_albedo_to_absorption": ("shade.bsdf", ["rgb", "mfp"],
                                         False),
    "mathutil.refract_dir": ("core.mathutil", ["d", "n", "nr"], False),
    "mathutil.channel_average": ("core.mathutil", ["rgb"], False),
    "mathutil.orthonormal_basis": ("core.mathutil", ["n"], False),
    "mathutil.reorient_around_normal": ("core.mathutil", ["d", "n"], False),
    "mathutil.spherical_to_dir": ("core.mathutil", ["phi", "theta"], False),
    "mathutil.transform_points": ("core.mathutil", ["m", "p"], False),
    "mathutil.transform_dirs": ("core.mathutil", ["m", "p"], False),
    "mathutil.make_affine": ("core.mathutil", ["lin", "tr"], True),
    "vec3.splat": ("core.vec3", [(0.25, -1.5, 3.0)], True),
    "vec3.full_like": ("core.vec3", ["V3:p", 0.7], True),
    "vec3.all_lt": ("core.vec3", ["V3:p", 0.5], True),
    "vec3.min_c": ("core.vec3", ["V3:p"], True),
    "vec3.luminance": ("core.vec3", ["V3:rgb"], False),
}


def _args(keys, jnp_side):
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as jv3
    from tracerboy_tpu_torch.core import vec3 as tv3

    out = []
    for k in keys:
        if not isinstance(k, str):
            out.append(k)
        elif k.startswith("V3:"):
            a = X[k[3:]]
            if jnp_side:
                out.append(jv3.V3(*(jnp.asarray(a[:, i]) for i in range(3))))
            else:
                out.append(tv3.V3(*(torch.from_numpy(a[:, i].copy())
                                    for i in range(3))))
        elif k in ("lin", "tr"):
            out.append(X[k])             # float64 host values, cast inside
        else:
            out.append(jnp.asarray(X[k]) if jnp_side
                       else torch.from_numpy(X[k]))
    return out


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    import importlib

    module, keys, exact = CASES[name]
    fn = name.split(".")[1]
    jax_fn = getattr(importlib.import_module(f"tracerboy_tpu.{module}"), fn)
    port_fn = getattr(importlib.import_module(
        f"tracerboy_tpu_torch.{module}"), fn)
    want = _leaves(jax_fn(*_args(keys, True)))
    got = _leaves(port_fn(*_args(keys, False)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if exact or w.dtype == np.bool_:
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def _procedural_triangles():
    from tracerboy_tpu_torch.scene.compile import load_scene

    cs = load_scene("shadertoy:cornell", film_size=(16, 12))
    tri = np.asarray(cs.as_numpy()["tri_v0"]), np.asarray(
        cs.as_numpy()["tri_v1"]), np.asarray(cs.as_numpy()["tri_v2"])
    rng = np.random.default_rng(3)
    o = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.2, 3.0, 256).astype(np.float32)
    return tri, o, d, tm


@pytest.mark.parametrize("watertight", [False, True])
def test_brute_force_oracles_match_jax(watertight):
    """brute_force_closest (both triangle tests) and brute_force_anyhit on
    the cornell box's triangles, from rays inside the box: hits, ids and
    occlusion equal; t, u and v to atol=1e-6, rtol=1e-5 (XLA may contract
    the Moller-Trumbore dot products into FMAs)."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import intersect as jint
    from tracerboy_tpu_torch.trace import intersect as tint

    (v0, v1, v2), o, d, tm = _procedural_triangles()
    ref = [np.asarray(x) for x in jint.brute_force_closest(
        *map(jnp.asarray, (o, d, v0, v1, v2)), t_max=jnp.asarray(tm),
        watertight=watertight)]
    got = [x.numpy() for x in tint.brute_force_closest(
        *map(torch.from_numpy, (o, d, v0, v1, v2)),
        t_max=torch.from_numpy(tm), watertight=watertight)]
    assert (ref[1] >= 0).sum() > 50
    assert np.array_equal(got[1], ref[1])
    for g, w in zip(got[::2] + got[3:], ref[::2] + ref[3:]):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    occ_ref = np.asarray(jint.brute_force_anyhit(
        *map(jnp.asarray, (o, d, v0, v1, v2)), jnp.asarray(tm)))
    occ = tint.brute_force_anyhit(*map(torch.from_numpy, (o, d, v0, v1, v2)),
                                  torch.from_numpy(tm)).numpy()
    assert occ.dtype == np.bool_ and np.array_equal(occ, occ_ref)


def test_pack_instanced_matches_jax():
    """The TLAS tables, object bases and packed attribute rows of three
    objects under five instances (one of an unknown object), with the same
    pack_object callable in both packages."""
    from tracerboy_tpu.trace.instanced import pack_instanced as jax_pack
    from tracerboy_tpu_torch.trace.instanced import pack_instanced

    rng = np.random.default_rng(11)
    objects = {}
    for name, t in (("tree", 7), ("rock", 5), ("bush", 3)):
        v = rng.normal(size=(3, t, 3)).astype(np.float32)
        objects[name] = (v[0], v[1], v[2],
                         rng.normal(size=(t, 19)).astype(np.float32))

    def pack_object(v0, v1, v2):
        order = np.concatenate([np.arange(len(v0))[::-1], [0]])
        return {"tri_map": order, "n": len(v0)}, None

    def affine(seed):
        r = np.random.default_rng(seed)
        m = np.eye(4)
        m[:3, :3] = r.normal(size=(3, 3)) + 2 * np.eye(3)
        m[:3, 3] = r.normal(size=3)
        return m

    instances = [("tree", affine(1)), ("rock", affine(2)),
                 ("tree", affine(3)), ("ghost", affine(4)),
                 ("bush", affine(5))]
    ref = jax_pack(objects, instances, None, pack_object)
    got = pack_instanced(objects, instances, None, pack_object)
    assert set(got[0]) == set(ref[0])
    for k in ref[0]:
        want = np.asarray(ref[0][k])
        assert got[0][k].numpy().dtype == want.dtype, k
        assert np.array_equal(got[0][k].numpy(), want), k
    assert got[1]["obj_names"] == ref[1]["obj_names"]
    assert got[1]["obj_base"] == ref[1]["obj_base"]
    assert np.array_equal(got[2], ref[2])


def _bvh_fields(bvh):
    return {k: np.asarray(getattr(bvh, k)) for k in (
        "bounds_lo", "bounds_hi", "children", "tri_order", "world_lo",
        "world_hi")} | {"leaf_size": bvh.leaf_size, "num_tris": bvh.num_tris}


@pytest.mark.parametrize("env", ["native", "python"])
def test_build_bvh_auto_matches_jax(monkeypatch, env):
    """build_bvh_auto in both packages on the cornell box's triangles: the
    native SAH builder, and under TB_BVH=python the LBVH; equal trees."""
    from tracerboy_tpu.accel import native as jax_native
    from tracerboy_tpu_torch.accel import native

    if env == "python":
        monkeypatch.setenv("TB_BVH", "python")
    else:
        monkeypatch.delenv("TB_BVH", raising=False)
    (v0, v1, v2), _, _, _ = _procedural_triangles()
    assert native.native_available() == jax_native.native_available()
    got, ref = native.build_bvh_auto(v0, v1, v2), \
        jax_native.build_bvh_auto(v0, v1, v2)
    a, b = _bvh_fields(got), _bvh_fields(ref)
    for k in b:
        assert np.array_equal(a[k], b[k]), k


def test_build_bvh_auto_falls_back_as_jax_does(monkeypatch):
    """Where the native library does not build or load, build_bvh_auto
    takes the LBVH (accel/bvh.build_bvh), as the JAX package's does; the
    native entry point itself still raises."""
    from tracerboy_tpu.accel import bvh as jax_bvh
    from tracerboy_tpu_torch.accel import native

    def broken():
        raise RuntimeError("building tbbvh failed (1)")

    (v0, v1, v2), _, _, _ = _procedural_triangles()
    monkeypatch.delenv("TB_BVH", raising=False)
    monkeypatch.setattr(native, "_load", broken)
    assert not native.native_available()
    a = _bvh_fields(native.build_bvh_auto(v0, v1, v2))
    b = _bvh_fields(jax_bvh.build_bvh(v0, v1, v2))
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    with pytest.raises(RuntimeError):
        native.build_bvh_native(v0, v1, v2)
