"""Camera, shading and post-processing modules of the PyTorch port against
the JAX package on the same seeded numpy inputs.

Tolerances: primary rays 1e-6 absolute; shading functions 1e-5 (relative
and absolute) -- both packages evaluate the same float32 expressions, and
what differs is the last ulps of rsqrt and the transcendental functions
(pow, acos, atan2, exp) between XLA's CPU code and PyTorch's (XLA's rsqrt
differs from PyTorch's on 34% of float32 inputs, measured).

One measured exception: the GGX NDF at the minimum roughness 0.04 has
a2 = 2.6e-6 in the denominator (a2 - 1) cos^2 + 1, so near the lobe's
peak an ulp in the half vector moves D by up to ~1/a2 ulps. On 8192
random samples 6 values of ggx_reflection_pdf_soa / specular_weight_soa
differ by 1.3e-4 .. 2.0e-4 relative, all at that peak. Those two are held
to 1e-5 on 99.5% of samples and to 1e-3 on all of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracerboy_tpu.core import vec3 as jv3
from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
from tracerboy_tpu.shade import bsdf as jbsdf
from tracerboy_tpu_torch.core import vec3 as tv3
from tracerboy_tpu_torch.scene.compile import from_jax_pytree
from tracerboy_tpu_torch.shade import bsdf as tbsdf

torch.set_num_threads(2)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def scenes():
    """The benchmark scene as the JAX pytree and as the port's tensors
    carried from it."""
    cs = jax_load_scene("shadertoy", film_size=(64, 36))
    jtree = cs.as_pytree()
    nptree = jax.tree_util.tree_map(np.asarray, jtree)
    return cs, jtree, from_jax_pytree(nptree, "cpu")


def _v3_pair(a):
    """(N, 3) numpy -> (jax V3, torch V3)."""
    a = np.asarray(a, np.float32)
    return (jv3.V3(*(jnp.asarray(a[:, k]) for k in range(3))),
            tv3.V3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))))


def _s_pair(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(j, t, **tol):
    tol = tol or TOL
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _close(a, b, **tol)
        return
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **tol)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dof", [False, True])
def test_primary_rays_match(scenes, dof):
    from tracerboy_tpu.trace.camera import generate_primary_rays_soa as jgen
    from tracerboy_tpu_torch.trace.camera import (
        generate_primary_rays_soa as tgen,
    )

    cs, jtree, ttree = scenes
    rng = np.random.default_rng(1)
    W, H = 64, 36
    ids = rng.integers(0, W * H, N)
    ju, tu = _s_pair(rng.random(N, dtype=np.float32))
    jvv, tvv = _s_pair(rng.random(N, dtype=np.float32))
    jdu, tdu = _s_pair(rng.random(N, dtype=np.float32))
    jdv, tdv = _s_pair(rng.random(N, dtype=np.float32))
    focus, aperture = (2.5, 0.05) if dof else (0.0, 0.01)
    jo, jd = jgen(jtree["camera"], W, H, jnp.asarray(ids.astype(np.int32)),
                  ju, jvv, dof_focus_distance=jnp.float32(focus),
                  dof_aperture_width=jnp.float32(aperture), dof_u=jdu,
                  dof_v=jdv)
    def port(dtype):
        return tgen(ttree["camera"], W, H, torch.from_numpy(ids),
                    *(x.to(dtype) for x in (tu, tvv)),
                    dof_focus_distance=focus, dof_aperture_width=aperture,
                    dof_u=tdu.to(dtype), dof_v=tdv.to(dtype))

    to, td = port(torch.float32)
    try:
        _close(jo, to, rtol=0, atol=1e-6)
        _close(jd, td, rtol=0, atol=1e-6)
    except AssertionError as err:
        # A once-seen failure of the dof case (ROADMAP.md Queue 3): record
        # what the cause needs.
        diagnosis = _ray_diagnosis(jo, to, port)
        raise AssertionError(f"{err}\n{diagnosis}") from None


def _ray_diagnosis(jo, to, port):
    """The process state and, for the origins, whether the port repeats
    its values and which side lies nearer a float64 evaluation."""
    import ctypes

    before = _thread_switches()
    again = port(torch.float32)[0]
    after = _thread_switches()
    exact = port(torch.float64)[0]
    lines = [f"threads {torch.get_num_threads()}, cpu capability "
             f"{torch.backends.cpu.get_cpu_capability()}, fegetround "
             f"{ctypes.CDLL('libm.so.6').fegetround():#x}",
             _mkl_state(),
             # The threads that woke inside the repeated call: those whose
             # context-switch counts moved while it ran.
             f"OS threads {len(after)}, of them "
             f"{sum(after[t] != before.get(t) for t in after)} switched "
             f"context inside the repeated call"]
    for k in "xyz":
        j = np.asarray(getattr(jo, k), np.float64)
        t, t2, e = (np.asarray(getattr(v, k), np.float64)
                    for v in (to, again, exact))
        lines.append(f"origin {k}: port again max|d| {np.abs(t2 - t).max()}, "
                     f"max|port - f64| {np.abs(t - e).max()}, "
                     f"max|jax - f64| {np.abs(j - e).max()}")
        # torch splits a vectorised math call over its threads in chunks
        # of 2048 lanes: does the error sit in one chunk?
        off = np.abs(t - e) > 1e-6
        lines.append(f"origin {k}: lanes off by > 1e-6 per 2048-lane chunk "
                     f"{[int(c.sum()) for c in np.split(off, len(off) // 2048)]}")
    return "\n".join(lines + [torch.__config__.parallel_info()])


def _mkl_state() -> str:
    """MKL's VML mode (accuracy in the low 4 bits: 1 LA, 2 HA, 3 EP),
    mkl_get_dynamic() and its thread limit, read from the MKL that torch
    links (mkl_serv_get_dynamic is the function behind mkl_get_dynamic)."""
    import ctypes
    import os

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))

    def call(name):
        fn = getattr(lib, name, None)
        return "not exported" if fn is None else fn()

    mode = call("vmlGetMode")
    return (f"MKL VML mode {mode:#x}" if isinstance(mode, int)
            else f"MKL VML mode {mode}") + (
        f", mkl_get_dynamic {call('mkl_serv_get_dynamic')}, "
        f"mkl_get_max_threads {call('mkl_serv_get_max_threads')}")


def _thread_switches() -> dict:
    """{thread id: (voluntary, involuntary) context switches} of this
    process's threads."""
    import os

    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/status") as f:
                fields = dict(line.split(":", 1) for line in f if ":" in line)
        except OSError:
            continue
        out[tid] = (int(fields["voluntary_ctxt_switches"]),
                    int(fields["nonvoluntary_ctxt_switches"]))
    return out


# The process-wide states that test_dof_rays_ignore_process_state sets
# are set in a child process, so that no other test of the worker runs
# under them (torch's thread pool keeps the FPU environment of the
# thread that created it).
_STATE_SCRIPT = r"""
import ctypes, json, os, sys
import numpy as np
import torch
from tracerboy_tpu_torch.trace.camera import generate_primary_rays_soa

cam = torch.load(sys.argv[1])
N, W, H = int(sys.argv[2]), 64, 36

def rays():
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, W * H, N))
    u, v, du, dv = (torch.from_numpy(rng.random(N, dtype=np.float32))
                    for _ in range(4))
    o, d = generate_primary_rays_soa(cam, W, H, ids, u, v,
                                     dof_focus_distance=2.5,
                                     dof_aperture_width=0.05, dof_u=du,
                                     dof_v=dv)
    return torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])

libm = ctypes.CDLL("libm.so.6")
torch_cpu = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__),
                                     "lib", "libtorch_cpu.so"))
vml_set = getattr(torch_cpu, "vmlSetMode", None)
ref = rays()
out = {}
for state in sys.argv[3:]:
    threads = torch.get_num_threads()
    vml_mode = None
    if state == "threads_1":
        torch.set_num_threads(1)
    elif state == "threads_6":
        torch.set_num_threads(6)
    elif state == "flush_denormal":
        torch.set_flush_denormal(True)
    elif state == "round_upward":
        libm.fesetround(0x800)                  # FE_UPWARD on x86-64
    elif vml_set is not None:                   # vml_mode_ep
        vml_mode = vml_set(ctypes.c_uint(0x3))  # VML_EP
    out[state] = float((rays() - ref).abs().max())
    torch.set_num_threads(threads)
    torch.set_flush_denormal(False)
    libm.fesetround(0)                          # FE_TONEAREST
    if vml_mode is not None:
        vml_set(ctypes.c_uint(vml_mode))
print(json.dumps(out))
"""
STATES = ["threads_1", "threads_6", "flush_denormal", "round_upward",
          "vml_mode_ep"]


@pytest.fixture(scope="module")
def dof_rays_under_states(scenes, tmp_path_factory):
    """Max |change| of the port's depth-of-field rays under each state,
    measured in a child process against its own rays in the default
    state."""
    import json
    import os
    import subprocess
    import sys

    path = tmp_path_factory.mktemp("camera") / "camera.pt"
    torch.save(dict(scenes[2]["camera"]), path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", _STATE_SCRIPT, str(path), str(N), *STATES],
        capture_output=True, text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("state", STATES)
def test_dof_rays_ignore_process_state(dof_rays_under_states, state):
    """The depth-of-field rays of test_primary_rays_match[True] once
    differed from the JAX package's by up to 1.04e-5 on 1,184 of 4,096
    lanes in one tier-1 run (ROADMAP.md Queue 3; cause not found). The
    process-wide states a test file run before it in the same worker could
    leave behind do not explain that: torch's thread count, flush-to-zero
    and MKL's VML accuracy mode (torch passes its accuracy with each call)
    move the port's rays by not one bit, and an upward FPU rounding mode
    moves each float32 operation by an ulp (measured at most 4.8e-7 on
    these rays), inside the comparison's 1e-6."""
    bound = 1e-6 if state == "round_upward" else 0.0
    assert dof_rays_under_states[state] <= bound


def _bsdf_cases(rng):
    n = _unit(rng)
    d = _unit(rng)
    d = np.where((d * n).sum(1, keepdims=True) > 0, -d, d)  # toward surface
    out = _unit(rng)
    rough = rng.random(N, dtype=np.float32)
    r0 = rng.random(N, dtype=np.float32)
    r1 = rng.random(N, dtype=np.float32)
    nr = (0.6 + rng.random(N) * 1.2).astype(np.float32)
    rdn = np.abs((d * n).sum(1)).astype(np.float32)
    return dict(n=n, d=d, out=out, rough=rough, r0=r0, r1=r1, nr=nr,
                rdn=rdn)


BSDF_CALLS = {
    "sample_cosine_hemisphere_soa":
        lambda m, c: m.sample_cosine_hemisphere_soa(c["n"], c["r0"],
                                                    c["r1"]),
    "sample_pow_lobe_soa": lambda m, c: m.sample_pow_lobe_soa(
        c["n"], c["rough"], c["r0"], c["r1"]),
    "sample_ggx_reflection_soa": lambda m, c: m.sample_ggx_reflection_soa(
        c["d"], c["n"], c["rough"], c["r0"], c["r1"]),
    "ggx_reflection_pdf_soa": lambda m, c: m.ggx_reflection_pdf_soa(
        c["n"], c["out"], m.half_vector_safe_soa(-c["d"], c["out"], c["n"]),
        c["rough"]),
    "half_vector_safe_soa": lambda m, c: m.half_vector_safe_soa(
        -c["d"], c["out"], c["n"]),
    "diffuse_brdf_soa": lambda m, c: m.diffuse_brdf_soa(c["out"], c["n"]),
    "specular_weight_soa": lambda m, c: m.specular_weight_soa(
        c["d"], c["out"], c["n"], c["n"], c["rough"]),
    "sample_uniform_sphere_soa": lambda m, c: m.sample_uniform_sphere_soa(
        c["r0"], c["r1"]),
    "refract_or_reflect_soa": lambda m, c: m.refract_or_reflect_soa(
        c["d"], c["n"], c["nr"], c["rdn"]),
    "artist_albedo_to_absorption_soa":
        lambda m, c: m.artist_albedo_to_absorption_soa(c["absorb"],
                                                       c["mfp"]),
}


ILL_CONDITIONED = ("ggx_reflection_pdf_soa", "specular_weight_soa")


@pytest.mark.parametrize("fn", sorted(BSDF_CALLS))
def test_bsdf_function_matches(fn):
    rng = np.random.default_rng(sorted(BSDF_CALLS).index(fn))
    c = _bsdf_cases(rng)
    c["absorb"] = rng.random((N, 3), dtype=np.float32)
    c["mfp"] = (0.05 + rng.random((N, 3))).astype(np.float32)
    jc, tc = {}, {}
    for k, v in c.items():
        if v.ndim == 2:
            jc[k], tc[k] = _v3_pair(v)
        else:
            jc[k], tc[k] = _s_pair(v)
    j, t = BSDF_CALLS[fn](jbsdf, jc), BSDF_CALLS[fn](tbsdf, tc)
    if fn in ILL_CONDITIONED:
        j, t = np.asarray(j), t.numpy()
        within = np.isclose(t, j, **TOL).mean()
        assert within >= 0.995, within
        _close(j, t, rtol=1e-3, atol=1e-5)
    else:
        _close(j, t)


def test_fetch_material_matches(scenes):
    from tracerboy_tpu.shade.surface import fetch_material_soa as jfetch
    from tracerboy_tpu_torch.shade.surface import fetch_material_soa as tfetch

    cs, jtree, ttree = scenes
    rng = np.random.default_rng(3)
    M = cs.materials["flags"].shape[0]
    mid = rng.integers(0, M, N)
    uvu = (rng.random(N) * 3 - 1).astype(np.float32)
    uvv = (rng.random(N) * 3 - 1).astype(np.float32)
    back = rng.random(N) < 0.3
    lanes = rng.integers(0, 10**6, N)
    kw = dict(has_mix=True, has_textures=True, has_emissive_tex=True,
              has_specular_tex=True, has_image_tex=True, has_scale_tex=True)
    j = jfetch(jtree, jnp.asarray(mid.astype(np.int32)), jnp.asarray(uvu),
               jnp.asarray(uvv), jnp.asarray(back),
               jnp.asarray(lanes.astype(np.int32)), 5, 2, 0, **kw)
    t = tfetch(ttree, torch.from_numpy(mid), torch.from_numpy(uvu),
               torch.from_numpy(uvv), torch.from_numpy(back),
               torch.from_numpy(lanes), 5, 2, 0, **kw)
    assert set(j) == set(t)
    for key in j:
        _close(j[key], t[key])


def test_eval_texture_all_record_types():
    """Image (with gamma), checker, scale-of-two and constant records."""
    from tracerboy_tpu.shade.surface import eval_texture as jeval
    from tracerboy_tpu_torch.shade.surface import eval_texture as teval

    rng = np.random.default_rng(4)
    imgs = rng.random((2, 8, 8, 3), dtype=np.float32)
    sizes = np.array([[8, 8], [6, 5]], np.int32)
    recs = dict(
        ttype=np.array([0, 1, 2, 3, 0], np.int32),
        flags=np.array([1, 0, 0, 0, 0], np.int32),
        image_idx=np.array([0, -1, -1, -1, 1], np.int32),
        uscale=np.array([1.0, 7.0, 1.0, 1.0, 2.0], np.float32),
        vscale=np.array([1.0, 3.0, 1.0, 1.0, 0.5], np.float32),
        color1=rng.random((5, 3), dtype=np.float32),
        color2=rng.random((5, 3), dtype=np.float32),
        sub1=np.array([-1, -1, 0, -1, -1], np.int32),
        sub2=np.array([-1, -1, 1, -1, -1], np.int32),
    )
    tex = rng.integers(0, 5, N)
    uv = (rng.random((N, 2)) * 4 - 2).astype(np.float32)
    j = jeval({k: jnp.asarray(v) for k, v in recs.items()},
              jnp.asarray(imgs), jnp.asarray(sizes),
              jnp.asarray(tex.astype(np.int32)), jnp.asarray(uv))
    t = teval({k: torch.from_numpy(v) for k, v in recs.items()},
              torch.from_numpy(imgs), torch.from_numpy(sizes),
              torch.from_numpy(tex), torch.from_numpy(uv))
    _close(j, t)


@pytest.mark.parametrize("use_ris", [False, True])
def test_sample_one_light_matches(scenes, use_ris):
    from tracerboy_tpu.shade.nee import sample_one_light_soa as jsample
    from tracerboy_tpu_torch.shade.nee import sample_one_light_soa as tsample

    cs, jtree, ttree = scenes
    rng = np.random.default_rng(5)
    pos = (rng.random((N, 3)) * [8, 2, 8] - [4, 0, 6]).astype(np.float32)
    jp, tp = _v3_pair(pos)
    lanes = rng.integers(0, 10**6, N)
    j = jsample(jtree["lights"], cs.num_lights, jp,
                jnp.asarray(lanes.astype(np.int32)), 3, 1, use_ris=use_ris,
                seed=2)
    t = tsample(ttree["lights"], cs.num_lights, tp, torch.from_numpy(lanes),
                3, 1, use_ris=use_ris, seed=2)
    assert set(j) == set(t)
    for key in j:
        _close(j[key], t[key])


def test_environment_lookups_match(scenes):
    from tracerboy_tpu.shade import env as jenv
    from tracerboy_tpu_torch.shade import env as tenv

    cs, jtree, ttree = scenes
    rng = np.random.default_rng(6)
    jd, td = _v3_pair(_unit(rng))
    eh, ew = cs.env_map.shape[:2]
    mask = rng.random(N) < 0.7
    _close(
        jenv.sample_environment_soa(jd, jtree["env_r"], jtree["env_g"],
                                    jtree["env_b"], eh, ew,
                                    jtree["env_transform"],
                                    jtree["env_color_scale"]),
        tenv.sample_environment_soa(td, ttree["env_r"], ttree["env_g"],
                                    ttree["env_b"], eh, ew,
                                    ttree["env_transform"],
                                    ttree["env_color_scale"]))
    _close(
        jenv.sample_environment_quad_soa(jd, jtree["env_quad"], eh, ew,
                                         jtree["env_transform"],
                                         jtree["env_color_scale"],
                                         gather_mask=jnp.asarray(mask)),
        tenv.sample_environment_quad_soa(td, ttree["env_quad"], eh, ew,
                                         ttree["env_transform"],
                                         ttree["env_color_scale"],
                                         gather_mask=torch.from_numpy(mask)))


@pytest.mark.parametrize("op", range(8))
def test_tonemap_operator_matches(op):
    from tracerboy_tpu.core import tonemap as jtm
    from tracerboy_tpu_torch.core import tonemap as ttm

    rng = np.random.default_rng(op)
    c = (rng.random((N, 3)) ** 3 * 8).astype(np.float32)
    _close(jtm.tonemap(op, jnp.asarray(c)),
           ttm.tonemap(op, torch.from_numpy(c)))


def test_display_transform_and_histogram_match():
    from tracerboy_tpu.post import pipeline as jpp
    from tracerboy_tpu_torch.post import pipeline as tpp

    rng = np.random.default_rng(8)
    img = (rng.random((36, 64, 3)) ** 4 * 5).astype(np.float32)
    img[:3] = 0.0                                 # black bin
    np.testing.assert_array_equal(
        np.asarray(jpp.luminance_histogram(jnp.asarray(img))),
        tpp.luminance_histogram(torch.from_numpy(img)).numpy())
    _close(jpp.display_transform(jnp.asarray(img), 1.0, 7, True, True),
           tpp.display_transform(torch.from_numpy(img), 1.0, 7, True, True))


def test_mathutil_matches():
    from tracerboy_tpu.core import mathutil as jm
    from tracerboy_tpu_torch.core import mathutil as tm

    rng = np.random.default_rng(10)
    a = rng.normal(size=(N, 3)).astype(np.float32)
    b = rng.normal(size=(N, 3)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("dot", "cross", "reflect"):
        _close(getattr(jm, name)(ja, jb), getattr(tm, name)(ta, tb))
    for name in ("length", "normalize", "saturate", "luminance"):
        _close(getattr(jm, name)(ja), getattr(tm, name)(ta))
