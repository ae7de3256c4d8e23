"""Alpha cutouts, normal maps and transparent shadows of the port
(trace/wavefront.py: _alpha_at_hit, _closest_dispatch, _occluded_dispatch,
_shadow_transmittance; shade/surface.apply_normal_map) against the JAX
package's.

- _alpha_at_hit on seeded hits of the textured scene of
  tests/test_torch_textures.py, in all three id spaces (tri_attr_rows,
  pk_attr_rows, pk_sh_attr_rows): bit for bit, but where a gamma-flagged
  alpha image is decoded by pow (XLA's rounds otherwise in the last
  place: within 3e-7), and the a < 0.9 decisions equal away from that
  rounding of the cutoff; apply_normal_map on seeded normals, tangents and UVs: within
  1e-6 (XLA and torch may round a normalisation's rsqrt differently).
- The scenes of tests/test_features.py (TestAlphaCutout, TestNormalMapping,
  TestTransparentShadows) rendered by both packages, with the JAX tests'
  own assertions re-stated for the port; images under
  tests/test_torch_renderer.py's tolerance, |d| <= 1e-3 (1 + |ref|) on
  >= 99% of pixels and the mean to 1e-4 relative (normal AOVs 1e-4).
- A 2,050-triangle field of alpha-cut quads (the companion path) on the
  port's "twin" backend (the kernels' plain versions over the packed
  BVHs: re-fire waves and closest hits over the shadow BVH) against the
  JAX "jnp" backend, with the re-fire and shadow-round launches counted.
- utils/demo_scene.py's textured scene, small, through the port's CLI on
  the CPU at 32x18.
- Under the `cuda` marker (run on the card with `python -m pytest
  --noconftest -m cuda tests/test_torch_alpha.py`; this module imports
  jax and the JAX package only inside the tests that compare with them;
  skipped without a card): every closest-hit
  launch of a textured render on the card, main, re-fire and shadow-BVH
  rounds, against traverse.closest_hit_plain on the same rays.
"""

import dataclasses
import textwrap

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.core.image_io import write_png
from tracerboy_tpu_torch.trace import kernels, traverse
from tracerboy_tpu_torch.trace import wavefront as wf
from tracerboy_tpu_torch.utils.config import default_output_settings

torch.set_num_threads(2)


def JaxRenderer(*args, **kwargs):
    """The JAX package's Renderer, imported only by the tests that compare
    with it: the card's machine has no jax, and runs this module's cuda
    tests alone."""
    from tracerboy_tpu import Renderer as jax_renderer

    return jax_renderer(*args, **kwargs)


def jax_settings():
    from tracerboy_tpu.utils.config import default_output_settings as jax

    return jax()


def write_textured_scene(d, env="sky.hdr"):
    from test_torch_textures import write_textured_scene as write

    return write(d, env)


def assert_close(acc, ref, tol=1e-3):
    close = (np.abs(acc - ref) <= tol * (1 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


def write_scene(tmp_path, body, name="scene.pbrt"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


# ---------------------------------------------------------------------------
# Stage by stage.

@pytest.mark.parametrize("attr_key", ["tri_attr_rows", "pk_attr_rows",
                                      "pk_sh_attr_rows"])
def test_alpha_at_hit_matches_jax(tmp_path, attr_key):
    import jax.numpy as jnp

    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
    from tracerboy_tpu.trace import wavefront as jwf
    from tracerboy_tpu_torch.scene.compile import load_scene

    path = write_textured_scene(tmp_path)
    ref_scene = jax_load_scene(path, use_cache=False).as_pytree(
        pack_pallas=True)
    scene = load_scene(path, use_cache=False).as_tensors("cpu")
    T = scene[attr_key].shape[0]
    rng = np.random.default_rng(len(attr_key))
    n = 16384
    tri = rng.integers(-1, T, n).astype(np.int32)
    # Half the hits on the triangles whose material has an alpha texture.
    mat = scene[attr_key][:, 15].round().long()
    cutouts = np.flatnonzero(
        (scene["materials"]["alpha_tex"][mat] >= 0).numpy())
    tri[::2] = rng.choice(cutouts, n // 2)
    u = rng.random(n).astype(np.float32)
    v = (rng.random(n) * (1 - u)).astype(np.float32)
    want = np.asarray(jwf._alpha_at_hit(ref_scene, jnp.asarray(tri),
                                        jnp.asarray(u), jnp.asarray(v),
                                        attr_key))
    got = wf._alpha_at_hit(scene, torch.from_numpy(tri),
                           torch.from_numpy(u), torch.from_numpy(v),
                           attr_key).numpy()
    assert got.dtype == np.float32
    # Bit for bit, except that a gamma-flagged alpha image (the explicit
    # mask here: PBRT images default to gamma) is decoded by pow, which
    # XLA and torch round differently in the last place.
    mat = scene[attr_key][:, 15].round().long()[
        torch.from_numpy(tri).long().clamp(0, T - 1)]
    rec = scene["materials"]["alpha_tex"][mat].clamp_min(0)
    gamma = ((scene["tex_records"]["flags"][rec] & 1) != 0).numpy()
    gamma &= (scene["materials"]["alpha_tex"][mat] >= 0).numpy() & (tri >= 0)
    assert 0 < gamma.sum() < (tri >= 0).sum()
    np.testing.assert_array_equal(got[~gamma], want[~gamma])
    np.testing.assert_allclose(got[gamma], want[gamma], rtol=0, atol=3e-7)
    # The cutout decisions agree wherever alpha is not within that
    # rounding of the cutoff (here: everywhere).
    cut = got < wf.ALPHA_CUTOFF
    edge = np.abs(want - np.float32(0.9)) <= 3e-7
    np.testing.assert_array_equal(cut[~edge], (want < 0.9)[~edge])
    # About half of the cutout hits land on alpha-0 texels.
    assert 0.1 < cut.mean() < 0.4
    assert (got[tri < 0] == 1.0).all()


def test_apply_normal_map_matches_jax(tmp_path):
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as jv3
    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
    from tracerboy_tpu.shade.surface import apply_normal_map as jax_apply
    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.shade.surface import apply_normal_map

    path = write_textured_scene(tmp_path)
    ref_scene = jax_load_scene(path, use_cache=False).as_pytree(
        pack_pallas=True)
    scene = load_scene(path, use_cache=False).as_tensors("cpu")
    rng = np.random.default_rng(9)
    n = 4096
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = rng.normal(size=(n, 3)).astype(np.float32)
    uv = (rng.random((n, 2)) * 3 - 1).astype(np.float32)
    ntex = rng.integers(-1, scene["tex_records"]["ttype"].shape[0],
                        n).astype(np.int32)
    want = jax_apply(ref_scene, jnp.asarray(ntex),
                     jv3.V3(*jnp.asarray(nrm.T)), jv3.V3(*jnp.asarray(tan.T)),
                     jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]))
    got = apply_normal_map(scene, torch.from_numpy(ntex),
                           v3.V3(*torch.from_numpy(nrm.T)),
                           v3.V3(*torch.from_numpy(tan.T)),
                           torch.from_numpy(uv[:, 0]),
                           torch.from_numpy(uv[:, 1]))
    got = np.stack([c.numpy() for c in got], -1)
    want = np.stack([np.asarray(c) for c in want], -1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Records without a normal map keep the normal exactly.
    np.testing.assert_array_equal(got[ntex < 0], nrm[ntex < 0])
    assert np.abs(got - nrm).max() > 0.1


# ---------------------------------------------------------------------------
# tests/test_features.py's scenes, in both packages.

ALPHA_CUTOUT = """
    LookAt 0 0 4  0 0 0  0 1 0
    Camera "perspective" "float fov" [ 40 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 32 ]
    WorldBegin
    Texture "cut" "float" "imagemap" "string filename" ["cut.png"]
    AttributeBegin
    AreaLightSource "diffuse" "rgb L" [ 5 5 5 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -6 -6 -2  6 -6 -2  6 6 -2  -6 6 -2 ]
    AttributeEnd
    Material "matte" "rgb Kd" [ 0.02 0.02 0.02 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -4 -4 0  4 -4 0  4 4 0  -4 4 0 ]
      "float uv" [ 0 0  1 0  1 1  0 1 ]
      "texture alpha" "cut"
    WorldEnd
"""


def _cut_scene(tmp_path):
    img = np.zeros((16, 16, 3), np.float32)
    img[:, 8:] = 1.0  # right half opaque (alpha=1), left transparent
    write_png(str(tmp_path / "cut.png"), img)
    return write_scene(tmp_path, ALPHA_CUTOUT)


_JAX_CUTOUT = {}


def _jax_cutout(tmp_path, backend, spp, monkeypatch):
    """The JAX renderer's accumulator on ALPHA_CUTOUT (memoised: the
    files are the same in every test)."""
    key = (backend, spp)
    if key not in _JAX_CUTOUT:
        monkeypatch.setenv("TB_TRAVERSAL", backend)
        ref = JaxRenderer(_cut_scene(tmp_path), film_size=(32, 32))
        assert ref.wave_config().has_alpha
        ref.render_sample(spp)
        _JAX_CUTOUT[key] = np.asarray(ref.state.accum)
    return _JAX_CUTOUT[key]


@pytest.mark.parametrize("backend,jax_backend", [
    ("brute", "brute"), ("jnp", "jnp"), ("pallas", "brute")])
def test_camera_rays_pass_through_cutout(tmp_path, monkeypatch, backend,
                                         jax_backend):
    """JAX TestAlphaCutout.test_camera_rays_pass_through_cutout, in the
    port on brute force, "wide" (TB_TRAVERSAL=jnp) and the packed kernel
    path (TB_TRAVERSAL=pallas: the kernels' plain versions here)."""
    ref = _jax_cutout(tmp_path, jax_backend, 4, monkeypatch)
    monkeypatch.setenv("TB_TRAVERSAL", backend)
    r = Renderer(_cut_scene(tmp_path), film_size=(32, 32), device="cpu")
    assert r.wave_config().has_alpha
    r.render_sample(4)
    assert_close(r.state.accum.numpy(), ref)
    img = r.resolve_radiance().numpy()
    left = img[:, : img.shape[1] // 2 - 2].mean()
    right = img[:, img.shape[1] // 2 + 2:].mean()
    bright, dark = max(left, right), min(left, right)
    assert bright > 3.0, (left, right)     # emitter radiance visible
    assert bright > 10 * dark, (left, right)


def test_cutout_shadows_pass_through(tmp_path, monkeypatch):
    """JAX TestAlphaCutout.test_cutout_shadows_pass_through (brute force,
    8 samples), and the same render against the JAX renderer's."""
    ref = _jax_cutout(tmp_path, "brute", 8, monkeypatch)
    monkeypatch.setenv("TB_TRAVERSAL", "brute")
    r = Renderer(_cut_scene(tmp_path), film_size=(32, 32), device="cpu")
    r.render_sample(8)
    assert_close(r.state.accum.numpy(), ref)
    img = r.resolve_radiance().numpy()
    assert np.isfinite(img).all()
    halves = (img[:, :12].mean(), img[:, -12:].mean())
    assert max(halves) > 1.0


NORMAL_MAP_QUAD = """
    LookAt 0 0 4  0 0 0  0 1 0
    Camera "perspective" "float fov" [ 40 ]
    Film "image" "integer xresolution" [ 24 ] "integer yresolution" [ 24 ]
    WorldBegin
    LightSource "infinite" "rgb L" [ 1 1 1 ]
    Texture "bump" "color" "imagemap" "string filename" ["nm.png"]
    Material "uber" "rgb Kd" [ 0.6 0.6 0.6 ] "texture normalmap" "bump"
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -4 -4 0  4 -4 0  4 4 0  -4 4 0 ]
      "float uv" [ 0 0  1 0  1 1  0 1 ]
    WorldEnd
"""


def _normal_map_render(make, settings, tmp_path, enable):
    img = np.full((8, 8, 3), 0.5, np.float32)
    img[..., 0] = 0.25          # a constant tilt along the tangent
    write_png(str(tmp_path / "nm.png"), img)
    path = write_scene(tmp_path, NORMAL_MAP_QUAD)
    s = settings()
    s = dataclasses.replace(s, performance_settings=dataclasses.replace(
        s.performance_settings, enable_normal_maps=enable))
    r = make(path, s)
    assert r.wave_config().has_normal_maps == enable
    r.render_sample(4)
    nrm = np.asarray(r._last_aovs["normal"]).reshape(24, 24, 3)
    return np.asarray(r.state.accum), np.asarray(r.resolve_radiance()), nrm


@pytest.mark.parametrize("enable", [True, False])
def test_normal_map_matches_jax(tmp_path, enable):
    """JAX TestNormalMapping's scene with normal maps on and off: the
    accumulator and the normal AOV against the JAX renderer's."""
    ref = _normal_map_render(
        lambda p, s: JaxRenderer(p, settings=s, film_size=(24, 24)),
        jax_settings, tmp_path, enable)
    got = _normal_map_render(
        lambda p, s: Renderer(p, settings=s, film_size=(24, 24),
                              device="cpu"),
        default_output_settings, tmp_path, enable)
    assert_close(got[0], ref[0])
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)


def test_normal_map_tilts_normal_aov_and_shading(tmp_path):
    """JAX TestNormalMapping.test_normal_map_tilts_normal_aov_and_shading,
    re-stated for the port."""
    def render(enable):
        _, img, nrm = _normal_map_render(
            lambda p, s: Renderer(p, settings=s, film_size=(24, 24),
                                  device="cpu"),
            default_output_settings, tmp_path, enable)
        return img, nrm

    img_on, nrm_on = render(True)
    img_off, nrm_off = render(False)
    c = 12
    assert abs(nrm_off[c, c, 2]) > 0.95
    assert np.abs(nrm_on[c, c] - nrm_off[c, c]).max() > 0.2
    assert np.abs(img_on - img_off).mean() > 1e-3


def _pane_scene(tmp_path, glass_pane):
    """TestTransparentShadows' scene: a floor, a small area light above
    and, with glass_pane, a glass pane between them."""
    pane = """
MakeNamedMaterial "pane" "string type" "glass" "float index" [ 1.5 ]
AttributeBegin
NamedMaterial "pane"
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ] "point P" [ -0.6 1.0 -0.6 0.6 1.0 -0.6 0.6 1.0 0.6 -0.6 1.0 0.6 ]
AttributeEnd
""" if glass_pane else ""
    body = f"""
Transform [ 1 0 0 0  0 1 0 0  0 0 -1 0  0 -1 6.8 1]
Camera "perspective" "float fov" [ 19.5 ]
Film "image" "integer xresolution" [ 24 ] "integer yresolution" [ 24 ]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "rgb L" [ 20 20 20 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ] "point P" [ -0.3 1.9 -0.3 0.3 1.9 -0.3 0.3 1.9 0.3 -0.3 1.9 0.3 ]
AttributeEnd
{pane}
Material "matte" "rgb Kd" [ 0.7 0.7 0.7 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ] "point P" [ -1 0 -1 -1 0 1 1 0 1 1 0 -1 ]
WorldEnd
"""
    return write_scene(tmp_path, body, f"pane{int(glass_pane)}.pbrt")


def _pane_render(make, settings, path, transparent, spp=8):
    s = settings()
    s = s.replace(performance_settings=dataclasses.replace(
        s.performance_settings, max_bounces=2, use_blue_noise=False,
        transparent_shadows=transparent))
    r = make(path, s)
    assert r.wave_config().transparent_shadows == transparent
    r.render_sample(spp)
    return np.asarray(r.state.accum), np.asarray(r.resolve_radiance())


@pytest.mark.parametrize("backend", ["brute", "pallas", "jnp"])
def test_transparent_shadows_match_jax(tmp_path, monkeypatch, backend):
    """TestTransparentShadows' three renders (the pane with and without
    transparent shadows, the clear scene with them) against the JAX
    renderer's on brute force, and the JAX tests' assertions re-stated
    for the port on each of its backends (the packed one marches the
    shadow BVH)."""
    glass = _pane_scene(tmp_path, True)
    clear = _pane_scene(tmp_path, False)
    runs = {"hard": (glass, False), "soft": (glass, True),
            "clear": (clear, True), "clear_hard": (clear, False)}
    got = {}
    monkeypatch.setenv("TB_TRAVERSAL", backend)
    for name, (path, transparent) in runs.items():
        got[name] = _pane_render(
            lambda p, s: Renderer(p, settings=s, film_size=(24, 24),
                                  device="cpu"),
            default_output_settings, path, transparent)
    if backend == "brute":
        for name, (path, transparent) in runs.items():
            ref = _pane_render(
                lambda p, s: JaxRenderer(p, settings=s, film_size=(24, 24)),
                jax_settings, path, transparent)
            assert_close(got[name][0], ref[0])
    soft, hard, clr = got["soft"][1], got["hard"][1], got["clear"][1]
    floor = np.s_[12:, :, :]
    assert soft[floor].mean() > hard[floor].mean() * 1.5, (
        soft[floor].mean(), hard[floor].mean())
    assert soft[floor].mean() < clr[floor].mean() * 1.01
    # Without glass, transparent shadows change nothing.
    np.testing.assert_allclose(got["clear"][1], got["clear_hard"][1],
                               atol=1e-5)


# ---------------------------------------------------------------------------
# A cutout field above the brute-force cutoff, on the packed backend.

LEAF_FIELD = """\
LookAt 0 3.2 5  0 0.6 0  0 1 0
Camera "perspective" "float fov" [ 50 ]
Film "image" "integer xresolution" [ 24 ] "integer yresolution" [ 18 ]
Integrator "path" "integer maxdepth" [ 3 ]
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "rgb L" [ 0.6 0.7 0.9 ]
AttributeEnd
LightSource "distant" "point from" [ 1 5 2 ] "point to" [ 0 0 0 ]
  "rgb L" [ 2.5 2.5 2.5 ]
Texture "leaf" "spectrum" "imagemap" "string filename" [ "leaf.png" ]
Material "matte" "rgb Kd" [ 0.6 0.55 0.5 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -8 0 -8  8 0 -8  8 0 8  -8 0 8 ]
Material "matte" "texture Kd" "leaf"
Shape "trianglemesh" "integer indices" [ {idx} ]
  "point P" [ {pts} ] "float uv" [ {uvs} ]
WorldEnd
"""


def write_leaf_field(tmp_path, n=32):
    """n x n tilted quads (2 n^2 triangles) over a ground plane, all
    sharing an RGBA leaf whose texels alternate opaque and alpha-0 in
    stripes: the companion-alpha path, camera and shadow rays passing
    through several leaves."""
    leaf = np.ones((8, 8, 4), np.float32)
    leaf[..., 1] = 0.7
    leaf[:, ::2, 3] = 0.0
    write_png(str(tmp_path / "leaf.png"), leaf)
    pts, idx, uvs = [], [], []
    for i in range(n):
        for j in range(n):
            x, z = -3 + 6 * (i + 0.5) / n, -3 + 6 * (j + 0.5) / n
            y = 0.3 + 0.9 * ((i * 7 + j * 3) % 11) / 11
            h = 0.6 * 6 / n
            base = len(pts)
            pts += [(x - h, y, z - h), (x + h, y + 0.2 * h, z - h),
                    (x + h, y + 0.4 * h, z + h), (x - h, y + 0.2 * h, z + h)]
            uvs += [(0, 0), (1, 0), (1, 1), (0, 1)]
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    body = LEAF_FIELD.format(
        idx=" ".join(map(str, idx)),
        pts=" ".join(f"{c:.5f}" for p in pts for c in p),
        uvs=" ".join(f"{c:g}" for p in uvs for c in p))
    return write_scene(tmp_path, body, "leaves.pbrt")


def test_leaf_field_twin_backend_matches_jax_jnp(tmp_path, monkeypatch):
    path = write_leaf_field(tmp_path)
    monkeypatch.setenv("TB_TRAVERSAL", "jnp")
    ref = JaxRenderer(path, film_size=(24, 18))
    assert ref.wave_config().has_alpha
    ref.render_sample(2)
    monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    r = Renderer(path, film_size=(24, 18), device="cpu")
    assert r.compiled.num_tris > 2048 and r.traversal == "kernel"
    r.traversal = "twin"
    cfg = r.wave_config()
    assert cfg.has_alpha and cfg.traversal == "twin" and not cfg.env_nee
    tables = []
    for name in ("closest_hit_plain", "anyhit_plain"):
        real = getattr(traverse, name)

        def counting(o, d, t_max, nodes, tris_bw, roots=None, _real=real,
                     _name=name):
            tables.append((_name, nodes))
            return _real(o, d, t_max, nodes, tris_bw, roots)

        monkeypatch.setattr(traverse, name, counting)
    r.render_sample(2)
    # render_sample(2) is one merged wave: per bounce one main closest hit
    # and cfg.alpha_rounds re-fires over the main BVH, and a shadow march of
    # cfg.alpha_rounds + 1 closest hits over the shadow BVH; no any-hit.
    main = [n for k, n in tables if n is r.scene["pk_nodes"]]
    shadow = [n for k, n in tables if n is r.scene["pk_sh_nodes"]]
    assert all(k == "closest_hit_plain" for k, _ in tables)
    assert len(main) == cfg.max_bounces * (1 + cfg.alpha_rounds)
    assert len(shadow) == cfg.max_bounces * (cfg.alpha_rounds + 1)
    assert_close(r.state.accum.numpy(), np.asarray(ref.state.accum))


def _leaf_rays(cs, n, seed):
    """Half camera rays into the canopy, half random rays from inside the
    scene bounds; t_max infinite, finite (a light distance) or 0."""
    rng = np.random.default_rng(seed)
    lo = np.minimum(np.minimum(cs.tri_v0, cs.tri_v1), cs.tri_v2).min(0)
    hi = np.maximum(np.maximum(cs.tri_v0, cs.tri_v1), cs.tri_v2).max(0)
    half = n // 2
    o1 = np.tile(np.array([0, 3.2, 5], np.float32), (half, 1))
    tgt = np.array([-3, 0.3, -3]) + np.array([6, 1.2, 6]) * rng.random(
        (half, 3))
    o2 = lo + (hi - lo) * rng.random((n - half, 3))
    d2 = rng.normal(size=(n - half, 3))
    d2[:, 1] = np.abs(d2[:, 1])             # mostly up through leaves
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([tgt - o1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = np.full(n, 1e30, np.float32)
    kind = rng.random(n)
    tm[kind < 0.3] = (2 + 6 * rng.random(int((kind < 0.3).sum()))).astype(
        np.float32)
    tm[kind > 0.95] = 0.0
    return o, d, tm


@pytest.mark.parametrize("stage", ["closest", "occluded", "transmittance"])
def test_alpha_stages_match_jax(tmp_path, stage):
    """_closest_dispatch (re-fires from just past each cut hit, t measured
    from the ray origin), _occluded_dispatch and _shadow_transmittance on
    the leaf field, the port's "wide" backend against the JAX "jnp" one
    (the same 8-wide BVH, scene-order ids): hits equal, ids equal outside
    ties, t to 1e-5 relative (tests/test_torch_traverse_wide.py's bound);
    occlusion equal on >= 99.9% of rays; transmittance to 1e-5 on >=
    99.9%."""
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as jv3
    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
    from tracerboy_tpu.trace import wavefront as jwf
    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.scene.compile import load_scene

    path = write_leaf_field(tmp_path)
    cs = load_scene(path, use_cache=False)
    scene = cs.as_tensors("cpu")
    ref_scene = jax_load_scene(path, use_cache=False).as_pytree()
    o, d, tm = _leaf_rays(cs, 4096, seed=len(stage))
    jcfg = jwf.WaveConfig(width=8, height=8, traversal="jnp", has_alpha=True,
                          leaf_size=cs.leaf_size)
    cfg = wf.WaveConfig(width=8, height=8, traversal="wide", has_alpha=True,
                        leaf_size=cs.leaf_size)
    jargs = (jv3.V3(*jnp.asarray(o.T)), jv3.V3(*jnp.asarray(d.T)),
             jnp.asarray(tm))
    args = (v3.V3(*torch.from_numpy(o.T.copy())),
            v3.V3(*torch.from_numpy(d.T.copy())), torch.from_numpy(tm))
    if stage == "closest":
        want = [np.asarray(x) for x in jwf._closest_dispatch(
            ref_scene, *jargs, jcfg)[:4]]
        got = [x.numpy() for x in wf._closest_dispatch(scene, *args,
                                                       cfg)[:4]]
        hit = want[1] >= 0
        np.testing.assert_array_equal(got[1] >= 0, hit)
        np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
        same = hit & (got[1] == want[1])
        assert same.sum() >= 0.999 * hit.sum()
        # Cut hits were re-fired: many rays end behind a leaf they passed,
        # and a hit still cut after the last re-fire is rare.
        first = wf._closest(scene, *args, dataclasses.replace(
            cfg, has_alpha=False))[:4]
        assert (first[1].numpy() != got[1]).sum() > 100

        def cut_share(t, tri, u, v):
            a = wf._alpha_at_hit(scene, tri, u, v).numpy()
            return (a < wf.ALPHA_CUTOFF)[tri.numpy() >= 0].mean()

        assert (cut_share(*(torch.from_numpy(x) for x in got))
                < 0.2 * cut_share(*first))
    elif stage == "occluded":
        want = np.asarray(jwf._occluded_dispatch(ref_scene, *jargs, jcfg))
        got = wf._occluded_dispatch(scene, *args, cfg).numpy()
        assert (got == want).mean() >= 0.999
        plain = wf._occluded(scene, *args, cfg).numpy()
        assert (plain & ~got).sum() > 100       # rays through cut texels
        assert not (got & ~plain).any()
    else:
        jcfg = dataclasses.replace(jcfg, transparent_shadows=True)
        cfg = dataclasses.replace(cfg, transparent_shadows=True)
        want = np.asarray(jwf._shadow_transmittance(ref_scene, *jargs, jcfg))
        got = wf._shadow_transmittance(scene, *args, cfg).numpy()
        assert ((np.abs(got - want) <= 1e-5).mean()) >= 0.999
        occ = wf._occluded_dispatch(scene, *args, cfg).numpy()
        # No glass in the field: transmittance is 0 or 1; 0 wherever the
        # occlusion march finds an opaque hit, and also where a ray is
        # still passing cutouts after the last round (counted occluded).
        assert ((got == 0) | (got == 1)).all()
        assert (got[occ] == 0).all()
        assert ((got == 0) & ~occ).sum() > 0


def test_realtime_frames_take_the_alpha_path(tmp_path):
    """RealTime mode renders through the same wave: on the leaf field the
    fused frame and the plain frame are finite, and each of their waves
    runs the re-fires and the shadow-BVH rounds (twin calls on the CPU)."""
    from tracerboy_tpu_torch.utils.config import OutputSettings, RenderMode

    path = write_leaf_field(tmp_path, n=24)
    r = Renderer(path, film_size=(16, 12), device="cpu",
                 settings=OutputSettings(render_mode=RenderMode.REAL_TIME))
    assert r.traversal == "brute"
    r.traversal = "kernel"
    cfg = r.wave_config()
    assert cfg.has_alpha and cfg.decouple_albedo
    kernels.reset_counters()
    frame = r.render_realtime_frame()
    assert frame.shape == (12, 16, 3) and np.isfinite(frame).all()
    per_wave = cfg.max_bounces * (2 + 2 * cfg.alpha_rounds)
    assert kernels.TWIN_CALLS["closest"] == per_wave
    assert kernels.TWIN_CALLS["anyhit"] == 0
    fused = r.render_realtime_frame_fused()
    assert torch.isfinite(fused).all()
    assert kernels.TWIN_CALLS["closest"] == 2 * per_wave


# ---------------------------------------------------------------------------
# The demo scene.

def test_textured_demo_scene_through_the_cli(tmp_path):
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.utils.demo_scene import write_textured_scene \
        as write_demo

    tex, lit = write_demo(str(tmp_path), grid=16, sky=(32, 16), leaves=8,
                          albedo=64, normal=32, leaf=32)
    for scene, extra in ((tex, []), (lit, []),
                         (lit, ["--transparent-shadows"])):
        out = tmp_path / "o.png"
        stats = {}
        assert cli.main([scene, "--device", "cpu", "--size", "32x18",
                         "--spp", "2", "-q", "--out", str(out),
                         "--hdr-out", str(tmp_path / "o.exr"), *extra],
                        stats=stats) == 0
        img = image_io.read_ldr(str(out))
        assert img.shape == (18, 32, 3)
        rad = image_io.read_exr_rgb(str(tmp_path / "o.exr"))
        assert np.isfinite(rad).all() and rad.mean() > 0
        assert stats["spp"] == 2
    assert (tmp_path / "textured.pbrt.tbcache.npz").exists()


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transparent", [False, True])
def test_refire_and_shadow_waves_equal_their_plain_version(
        cuda_device, tmp_path, monkeypatch, transparent):
    """Every closest-hit launch of a textured render on the card (the
    leaf field: main waves, re-fires, shadow-BVH rounds) against
    traverse.closest_hit_plain on the same rays: hits and ids equal
    outside ties, t to 1e-6 relative."""
    path = write_leaf_field(tmp_path, n=48)
    calls = []
    real = traverse.closest_hit

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        calls.append((o.clone(), d.clone(), t_max.clone(), nodes, tris_bw))
        return real(o, d, t_max, nodes, tris_bw, roots)

    r = Renderer(path, film_size=(160, 90), device="cuda")
    r.settings = r.settings.replace(
        performance_settings=dataclasses.replace(
            r.settings.performance_settings,
            transparent_shadows=transparent))
    assert r.traversal == "kernel" and r.wave_config().has_alpha
    monkeypatch.setattr(traverse, "closest_hit", recording)
    r.render_sample(2)
    monkeypatch.setattr(traverse, "closest_hit", real)
    shadow = [c for c in calls if c[3] is r.scene["pk_sh_nodes"]]
    refire = [c for c in calls if c[3] is r.scene["pk_nodes"]
              and (c[2] == 0).float().mean() > 0.5]
    assert shadow and refire
    kernels.reset_counters()
    for o, d, tm, nodes, tris in calls:
        t_k, tri_k, u_k, v_k = real(o, d, tm, nodes, tris)
        t_p, tri_p, u_p, v_p = traverse.closest_hit_plain(o, d, tm, nodes,
                                                          tris)
        assert torch.equal(tri_k >= 0, tri_p >= 0)
        both = (tri_k >= 0) & (tri_p >= 0)
        if not both.any():
            continue
        rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
        assert rel.max().item() <= 1e-6
        assert (tri_k != tri_p)[both].float().mean().item() <= 1e-4
    assert kernels.stack_overflows() == 0
