"""ShaderToy-mode procedural scenes (no scene file needed).

A numpy copy of tracerboy_tpu/scene/procedural.py: both packages build
bit-identical scenes from it.

The reference's kernel doubles as a self-contained ShaderToy demo with
two compiled-in scenes — a sphere-garden benchmark and a cornell box —
built from analytic sphere/box/bounded-plane primitives
(kernel.glsl:13-25 IS_SHADER_TOY, 260-440 intersectors, 660-745 scene
tables, 897-940 material table). The TPU-first equivalent TESSELLATES
the same primitives into the standard triangle pipeline: one scene
representation, one traversal path, no second intersector stack to
maintain — and the demo still needs zero on-disk assets:

    Renderer("shadertoy")           # the sphere-garden benchmark
    Renderer("shadertoy:cornell")   # the cornell box

Geometry semantics mirror the reference exactly: a BoundedPlane's axes
are half-extent vectors (corners origin +- Axis1 +- Axis2,
kernel.glsl:313-330 BoundedPlaneIntersection's |proj| < |axis| test); a
Box is the parallelepiped origin +- Axis1 +- Axis2 +- Axis3 (its six
bounded planes, kernel.glsl:369-391); spheres get lat-long UVs
(GetSphereAttributes, kernel.glsl:760-767).
"""

from __future__ import annotations

import numpy as np

from tracerboy_tpu_torch.scene import types as ir


def _sphere_mesh(center, radius, n_lat=24, n_lon=48):
    """UV-sphere TriangleMeshIR with analytic normals + lat-long uvs."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    t, p = np.meshgrid(lat, lon, indexing="ij")
    nrm = np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], axis=-1
    ).reshape(-1, 3)
    pos = np.asarray(center, np.float32) + radius * nrm
    uv = np.stack(
        [t / np.pi, (p + np.pi / 2) / np.pi], axis=-1
    ).reshape(-1, 2)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            b = a + n_lon + 1
            idx.append([a, b, a + 1])
            idx.append([a + 1, b, b + 1])
    return (pos.astype(np.float32), nrm.astype(np.float32),
            uv.astype(np.float32), np.asarray(idx, np.int32))


def _mesh(material, pos, nrm, uv, idx, emission=None):
    return ir.TriangleMeshIR(
        indices=idx, positions=pos, normals=nrm, uvs=uv,
        material=material, emission=emission,
    )


def sphere(center, radius, material, emission=None, n=24):
    pos, nrm, uv, idx = _sphere_mesh(center, radius, n, 2 * n)
    return _mesh(material, pos, nrm, uv, idx, emission)


def bounded_plane(origin, normal, axis1, axis2, material, emission=None):
    """Quad spanning origin +- axis1 +- axis2 (axes = half extents)."""
    o = np.asarray(origin, np.float32)
    a1 = np.asarray(axis1, np.float32)
    a2 = np.asarray(axis2, np.float32)
    pos = np.stack([o - a1 - a2, o + a1 - a2, o + a1 + a2, o - a1 + a2])
    n = np.asarray(normal, np.float32)
    n = n / max(np.linalg.norm(n), 1e-9)
    nrm = np.tile(n, (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return _mesh(material, pos, nrm, uv, idx, emission)


def box(origin, axis1, axis2, axis3, material):
    """Parallelepiped origin +- axis1 +- axis2 +- axis3 as 6 quads."""
    meshes = []
    axes = [np.asarray(a, np.float32) for a in (axis1, axis2, axis3)]
    o = np.asarray(origin, np.float32)
    for i in range(3):
        a, b, c = axes[i], axes[(i + 1) % 3], axes[(i + 2) % 3]
        n = a / max(np.linalg.norm(a), 1e-9)
        meshes.append(bounded_plane(o + a, n, b, c, material))
        meshes.append(bounded_plane(o - a, -n, b, c, material))
    return meshes


def _camera(position, look_at, up, lens_height, focal_distance):
    """CameraIR whose from_pbrt extraction reproduces the given
    ShaderToy CameraDescription frame (kernel.glsl:669-745)."""
    position = np.asarray(position, np.float64)
    look_at = np.asarray(look_at, np.float64)
    up = np.asarray(up, np.float64)
    view = look_at - position
    view /= np.linalg.norm(view)
    right = np.cross(view, up)
    right /= np.linalg.norm(right)
    up_c = np.cross(right, view)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up_c * (lens_height / 2.0)
    c2w[:3, 2] = view
    # Camera.from_pbrt advances the eye by (focal+0.01) along view to
    # place the lens plane; pre-subtract so the lens lands at position.
    c2w[:3, 3] = position - (focal_distance + 0.01) * view
    fov = 2.0 * np.degrees(np.arctan((lens_height / 2.0) / focal_distance))
    return ir.CameraIR(type="perspective", fov=float(fov),
                       camera_to_world=c2w)


def _mat(name, type_, **kw):
    m = ir.MaterialIR(name=name, type=type_)
    for k, v in kw.items():
        setattr(m, k, np.asarray(v, np.float32)
                if isinstance(v, (list, tuple)) else v)
    return m


def _benchmark_scene() -> ir.SceneIR:
    """SCENE_TRACERBOY_BENCHMARK (kernel.glsl:672-721): a 4x5 sphere
    garden over a checkered floor, one box, one area light; material
    table per GetMaterialInternal (kernel.glsl:917-935)."""
    s = ir.SceneIR(base_dir=".")
    s.camera = _camera((0, 1.3, 1.8), (0, 1, 0), (0, 1, 0), 2.0, 3.5)
    s.film.xresolution, s.film.yresolution = 1280, 720

    s.textures["floor_check"] = ir.TextureIR(
        name="floor_check", type="checkerboard", uscale=40.0, vscale=40.0,
        tex1=np.array([0.74, 0.74, 0.74], np.float32),
        tex2=np.array([0.2, 0.2, 0.2], np.float32),
    )
    M = s.materials
    M["floor"] = _mat("floor", "matte", map_kd="floor_check")
    M["wall"] = _mat("wall", "plastic", kd=(0.9, 0.9, 0.9),
                     ks=(0.08, 0.08, 0.08), roughness=0.001)
    M["bronze"] = _mat("bronze", "substrate", kd=(0.55, 0.2, 0.075),
                       ks=(0.6, 0.6, 0.6), uroughness=0.1)
    M["gold"] = _mat("gold", "substrate", kd=(0.65, 0.5, 0.075),
                     ks=(0.7, 0.7, 0.7), uroughness=0.15)
    M["blue_plastic"] = _mat("blue_plastic", "plastic",
                             kd=(0.05, 0.05, 0.55), ks=(0.3, 0.3, 0.3))
    M["radioactive"] = _mat("radioactive", "matte", kd=(0.05, 0.45, 0.05))
    M["mirror"] = _mat("mirror", "mirror", kr=(0.95, 0.95, 0.95))
    M["rough_mirror"] = _mat("rough_mirror", "metal", index=1.5,
                             roughness=0.5)
    M["refractive"] = _mat("refractive", "glass", index=1.5)
    M["ice"] = _mat("ice", "glass", index=1.1, roughness=0.1)
    M["glass"] = _mat("glass", "glass", index=1.05)
    M["wax"] = _mat("wax", "subsurface", index=1.05,
                    mfp=(0.2, 0.2, 0.2), kd=(0.725, 0.1, 0.1))
    M["wood"] = _mat("wood", "matte", kd=(0.5, 0.5, 0.5))
    M["checker_s"] = _mat("checker_s", "matte", map_kd="floor_check")
    M["light"] = _mat("light", "matte", kd=(0, 0, 0))

    shapes = s.shapes
    shapes.append(bounded_plane((0, 0, 0), (0, 1, 0), (10, 0, 0),
                                (0, 0, 10), "floor"))
    shapes.append(bounded_plane(
        (0, 2.0, 0), (0, -1, 0), (0.5, 0, 0), (0, 0, 0.5), "light",
        emission=np.array([12.0, 11.0, 10.0], np.float32),
    ))
    shapes.extend(box((0.0, 0.6, -1.5), (0, 0.6, 0),
                      (-0.285, 0.0, 0.09), (-0.09, 0.0, -0.29), "wall"))
    rows = [
        (0.5, ["rough_mirror", "ice", "wood", "refractive", "glass"]),
        (-1.5, ["glass", "checker_s", "blue_plastic", "mirror", None]),
        (-3.5, ["radioactive", "glass", "wax", "wall", "checker_s"]),
        (-5.5, ["wall", "wood", "rough_mirror", "gold", "rough_mirror"]),
    ]
    for z, mats in rows:
        xs = [2.0, 1.0, 0.0, -1.0, -2.0]
        for x, m in zip(xs, mats):
            if m is None:
                continue
            emission = (np.array([0.0, 1.5, 0.0], np.float32)
                        if m == "radioactive" else None)
            shapes.append(sphere((x, 0.4, z), 0.4, m, emission=emission))
    return s


def _cornell_scene() -> ir.SceneIR:
    """SCENE_CORNELL_BOX (kernel.glsl:721-745)."""
    s = ir.SceneIR(base_dir=".")
    s.camera = _camera((0, 1.0, 0.97), (0, 1, 0), (0, 1, 0), 2.0, 5.819)
    s.film.xresolution, s.film.yresolution = 800, 600
    M = s.materials
    M["wall"] = _mat("wall", "matte", kd=(0.725, 0.71, 0.68))
    M["left"] = _mat("left", "matte", kd=(0.63, 0.065, 0.05))
    M["right"] = _mat("right", "matte", kd=(0.14, 0.45, 0.091))
    M["light"] = _mat("light", "matte", kd=(0, 0, 0))
    P = bounded_plane
    s.shapes += [
        P((-1, 1, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), "left"),
        P((1, 1, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1), "right"),
        P((0, 1, -1), (0, 0, 1), (1, 0, 0), (0, 1, 0), "wall"),
        P((0, 2, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1), "wall"),
        P((0, 0, 0), (0, 1, 0), (1, 0, 0), (0, 0, 1), "wall"),
        P((-0.005, 1.98, 0.085), (0, -1, 0), (0.235, 0, 0),
          (0, 0, 0.19), "light",
          emission=np.array([17.0, 12.0, 4.0], np.float32)),
    ]
    s.shapes += box((0.3275, 0.3, 0.3275), (0, 0.3, 0),
                    (0.2875, 0.0, 0.0875), (0.0875, 0.0, -0.2875), "wall")
    s.shapes += box((-0.335, 0.6, -0.29), (0, 0.6, 0),
                    (-0.285, 0.0, 0.09), (-0.09, 0.0, -0.29), "wall")
    return s


def _sky_env(h=128, w=256):
    """Soft gradient sky dome for the open benchmark scene (the
    ShaderToy build is lit by its procedural background)."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    horizon = np.clip(np.cos(theta), 0.0, 1.0)[:, None]
    sky = np.stack([
        np.broadcast_to(0.35 + 0.25 * horizon, (h, w)),
        np.broadcast_to(0.45 + 0.30 * horizon, (h, w)),
        np.broadcast_to(0.65 + 0.35 * horizon, (h, w)),
    ], axis=-1)
    return sky.astype(np.float32)


def shadertoy_scene(name: str = "benchmark", film_size=None):
    """Compile a built-in procedural scene ('benchmark' or 'cornell')."""
    import dataclasses

    from tracerboy_tpu_torch.scene.compile import compile_scene

    if name in ("", "benchmark"):
        s = _benchmark_scene()
        env = _sky_env()
    elif name == "cornell":
        s = _cornell_scene()
        env = None
    else:
        raise ValueError(f"unknown shadertoy scene: {name!r} "
                         "(benchmark | cornell)")
    cs = compile_scene(s, film_size=film_size)
    if env is not None:
        cs = dataclasses.replace(
            cs, env_map=env, has_env=True,
            env_transform=np.eye(3, dtype=np.float32),
            env_color_scale=np.ones(3, np.float32),
        )
    return cs
