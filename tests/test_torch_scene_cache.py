"""The port's .npz scene cache (scene/compile.py: save_compiled,
load_compiled, _cache_path, load_scene, load_scene_async) against the JAX
package's, on the textured scene of tests/test_torch_textures.py.

Tolerances: none. A cache written by either package loads in the other
to leaves equal bit for bit to that package's own compile; a scene
reloaded from its cache equals the compile that wrote it; a cache older
than its scene is compiled again; a film_size only swaps the film
dimensions (the cache file is not rewritten); a read-only scene directory
caches under $TB_SCENE_CACHE; the CLI renders a .npz argument as it
renders the scene file; a cache with volume keys is refused.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from tracerboy_tpu.scene import compile as jax_compile
from tracerboy_tpu_torch.scene import compile as port_compile
from tracerboy_tpu_torch.scene.compile import load_scene
from test_torch_scene import _assert_same_leaves
from test_torch_textures import write_textured_scene

torch.set_num_threads(2)


def _jax_tree(cs):
    return jax.tree_util.tree_map(np.asarray,
                                  cs.as_pytree(pack_pallas=True))


def _cache_of(path):
    return path + ".tbcache.npz"


def test_roundtrip_is_bit_equal(tmp_path):
    path = write_textured_scene(tmp_path)
    first = load_scene(path)
    assert os.path.exists(_cache_of(path))
    again = load_scene(path)
    _assert_same_leaves(first.as_numpy(), again.as_numpy())
    assert again.camera.lens_height == first.camera.lens_height
    assert again.camera.focal_distance == first.camera.focal_distance
    for name in ("num_tris", "num_lights", "has_env", "film_width",
                 "film_height", "sampler_spp", "max_depth", "leaf_size"):
        assert getattr(again, name) == getattr(first, name), name
        assert type(getattr(again, name)) is type(getattr(first, name))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_loads_in_the_other_package(tmp_path, writer):
    path = write_textured_scene(tmp_path)
    if writer == "jax":
        ref = jax_compile.load_scene(path)          # writes the cache
        assert os.path.exists(_cache_of(path))
        stamp = os.stat(_cache_of(path)).st_mtime_ns
        got = load_scene(path)                      # reads it
        assert os.stat(_cache_of(path)).st_mtime_ns == stamp
        _assert_same_leaves(_jax_tree(ref), got.as_numpy())
        _assert_same_leaves(_jax_tree(ref),
                            load_scene(_cache_of(path)).as_numpy())
    else:
        got = load_scene(path)
        stamp = os.stat(_cache_of(path)).st_mtime_ns
        ref = jax_compile.load_scene(path)
        assert os.stat(_cache_of(path)).st_mtime_ns == stamp
        _assert_same_leaves(_jax_tree(ref), got.as_numpy())
        _assert_same_leaves(
            _jax_tree(jax_compile.load_compiled(_cache_of(path))),
            got.as_numpy())
    # Both equal a compile that never saw a cache.
    fresh = jax_compile.load_scene(path, use_cache=False)
    _assert_same_leaves(_jax_tree(fresh), got.as_numpy())


def test_same_file_format_key_for_key(tmp_path):
    path = write_textured_scene(tmp_path)
    port_cs = load_scene(path, use_cache=False)
    jax_cs = jax_compile.load_scene(path, use_cache=False)
    port_compile.save_compiled(str(tmp_path / "p.npz"), port_cs)
    jax_compile.save_compiled(str(tmp_path / "j.npz"), jax_cs)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
            assert p[k].tobytes() == j[k].tobytes(), k


def test_stale_cache_is_rebuilt(tmp_path):
    path = write_textured_scene(tmp_path)
    first = load_scene(path)
    stamp = os.stat(_cache_of(path)).st_mtime_ns
    text = open(path).read().replace('"float uscale" [ 3 ]',
                                     '"float uscale" [ 5 ]')
    with open(path, "w") as f:
        f.write(text)
    # The scene is now newer than its cache.
    later = os.path.getmtime(_cache_of(path)) + 2
    os.utime(path, (later, later))
    second = load_scene(path)
    assert os.stat(_cache_of(path)).st_mtime_ns != stamp    # rewritten
    assert 5.0 in second.tex_records["uscale"]
    assert 5.0 not in first.tex_records["uscale"]
    # A scene file older than its cache keeps the cache.
    earlier = os.path.getmtime(_cache_of(path)) - 2
    os.utime(path, (earlier, earlier))
    stamp = os.stat(_cache_of(path)).st_mtime_ns
    third = load_scene(path)
    assert os.stat(_cache_of(path)).st_mtime_ns == stamp
    _assert_same_leaves(second.as_numpy(), third.as_numpy())


def test_film_size_hits_cache(tmp_path):
    path = write_textured_scene(tmp_path)
    a = load_scene(path, film_size=(64, 48))
    assert (a.film_width, a.film_height) == (64, 48)
    stamp = os.stat(_cache_of(path)).st_mtime_ns
    b = load_scene(path, film_size=(32, 32))
    assert (b.film_width, b.film_height) == (32, 32)
    assert os.stat(_cache_of(path)).st_mtime_ns == stamp
    # The cache holds the file's own film; the camera does not change.
    c = load_scene(path)
    assert (c.film_width, c.film_height) == (40, 30)
    np.testing.assert_array_equal(a.camera.position, b.camera.position)
    _assert_same_leaves(a.as_numpy(), b.as_numpy())


def test_readonly_scene_dir_uses_user_cache(tmp_path, monkeypatch):
    ro = tmp_path / "ro"
    ro.mkdir()
    path = write_textured_scene(ro)
    real_access = os.access
    # Tests may run as root, which ignores permission bits: stub the
    # check instead, as the JAX package's test does.
    monkeypatch.setattr(os, "access", lambda p, mode: (
        False if str(p) == str(ro) else real_access(p, mode)))
    cachedir = tmp_path / "cache"
    monkeypatch.setenv("TB_SCENE_CACHE", str(cachedir))
    assert (port_compile._cache_path(path)
            == jax_compile._cache_path(path))
    first = load_scene(path, film_size=(32, 32))
    cached = list(cachedir.glob("*.npz"))
    assert len(cached) == 1, cached
    assert not os.path.exists(_cache_of(path))
    stamp = cached[0].stat().st_mtime_ns
    second = load_scene(path, film_size=(32, 32))
    assert cached[0].stat().st_mtime_ns == stamp
    _assert_same_leaves(first.as_numpy(), second.as_numpy())


def test_cache_path_beside_a_writable_scene(tmp_path):
    path = write_textured_scene(tmp_path)
    assert port_compile._cache_path(path) == jax_compile._cache_path(path)
    assert port_compile._cache_path(path) == _cache_of(path)


def test_cache_path_keeps_the_reference_checkout_rule(tmp_path,
                                                      monkeypatch):
    """With every directory writable, a scene under the reference checkout
    still caches under $TB_SCENE_CACHE (the JAX rule), and a scene
    elsewhere beside itself; both packages give the same paths."""
    monkeypatch.setattr(os, "access", lambda p, mode: True)
    monkeypatch.setenv("TB_SCENE_CACHE", str(tmp_path / "cache"))
    ref_scene = os.path.join(port_compile.REFERENCE_CHECKOUT, "Scenes",
                             "cornell-box", "scene.pbrt")
    scratch = str(tmp_path / "scene.pbrt")
    for path in (ref_scene, scratch):
        assert port_compile._cache_path(path) == jax_compile._cache_path(
            path)
    assert port_compile._cache_path(ref_scene).startswith(
        str(tmp_path / "cache"))
    assert port_compile._cache_path(scratch) == _cache_of(scratch)


def test_volume_cache_loads(tmp_path):
    """A compiled scene with a volume round-trips through the .npz cache
    (the vol.* keys), and the JAX package reads the same file."""
    from dataclasses import replace

    from tracerboy_tpu_torch.scene.volume import procedural_cloud

    path = write_textured_scene(tmp_path)
    vol = procedural_cloud(6)
    cs = replace(load_scene(path, use_cache=False), vol_density=vol.density,
                 vol_lo=vol.lo, vol_hi=vol.hi, vol_sigma_a=vol.sigma_a,
                 vol_sigma_s=vol.sigma_s, vol_g=0.5)
    port_compile.save_compiled(str(tmp_path / "v.npz"), cs)
    got = load_scene(str(tmp_path / "v.npz"))
    assert got.has_volume and got.vol_g == 0.5
    _assert_same_leaves(cs.as_numpy(), got.as_numpy())
    ref = jax_compile.load_compiled(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(ref.vol_density, vol.density)
    np.testing.assert_array_equal(ref.vol_sigma_s, vol.sigma_s)


def test_unreadable_cache_is_compiled_again(tmp_path):
    path = write_textured_scene(tmp_path)
    with open(_cache_of(path), "wb") as f:
        f.write(b"not a zip file")
    later = os.path.getmtime(path) + 2
    os.utime(_cache_of(path), (later, later))
    got = load_scene(path)
    _assert_same_leaves(load_scene(path, use_cache=False).as_numpy(),
                        got.as_numpy())
    with np.load(_cache_of(path)) as z:     # rewritten
        assert "scalar.num_tris" in z.files


def test_load_scene_async(tmp_path):
    path = write_textured_scene(tmp_path)
    seen = []
    fut = port_compile.load_scene_async(path, film_size=(20, 10),
                                        on_progress=seen.append)
    cs = fut.result(timeout=300)
    assert seen == ["parsing", "done"]
    assert (cs.film_width, cs.film_height) == (20, 10)
    _assert_same_leaves(load_scene(path, use_cache=False,
                                   film_size=(20, 10)).as_numpy(),
                        cs.as_numpy())


def test_cli_renders_a_npz_scene(tmp_path):
    """The port's CLI takes a compiled .npz as it takes the scene file:
    the same PNG and the same radiance."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io

    path = write_textured_scene(tmp_path)
    load_scene(path)
    outs = {}
    for name, scene in (("pbrt", path), ("npz", _cache_of(path))):
        t0 = time.time()
        assert cli.main([scene, "--device", "cpu", "--size", "16x12",
                         "--spp", "1", "--max-bounces", "2", "-q",
                         "--out", str(tmp_path / f"{name}.png"),
                         "--hdr-out", str(tmp_path / f"{name}.exr")]) == 0
        assert time.time() - t0 < 300
        outs[name] = (image_io.read_ldr(str(tmp_path / f"{name}.png")),
                      image_io.read_exr_rgb(str(tmp_path / f"{name}.exr")))
    np.testing.assert_array_equal(outs["pbrt"][0], outs["npz"][0])
    np.testing.assert_array_equal(outs["pbrt"][1], outs["npz"][1])
    assert np.isfinite(outs["npz"][1]).all() and outs["npz"][1].mean() > 0
