"""Typed scene IR: the host-side scene graph between parsing and compilation.

Plays the role of the reference's `pbrt::Scene` semantic graph
(PBRTParser/include/pbrtParser/Scene.h:89-1247): both the PBRT parser and the
generic mesh importer emit this IR, and only the scene compiler consumes it.
All arrays are numpy. A copy of tracerboy_tpu/scene/types.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FilmIR:
    xresolution: int = 640
    yresolution: int = 480
    filename: str = "out.png"


@dataclass
class SamplerIR:
    type: str = "sobol"
    pixel_samples: int = 16


@dataclass
class IntegratorIR:
    type: str = "path"
    max_depth: int = 5


@dataclass
class CameraIR:
    type: str = "perspective"
    fov: float = 90.0
    camera_to_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    lens_radius: float = 0.0
    focal_distance: float = 1e6


@dataclass
class MaterialIR:
    """Union of the parameters across pbrt's material classes.

    `type` selects which fields are meaningful, mirroring the dynamic casts in
    the reference's CreateMaterial (TracerBoy/TracerBoy.cpp:273-505).
    """

    name: str = ""
    type: str = "matte"
    kd: np.ndarray | None = None
    ks: np.ndarray | None = None
    kr: np.ndarray | None = None
    kt: np.ndarray | None = None
    map_kd: str | None = None
    map_ks: str | None = None
    map_bump: str | None = None
    map_normal: str | None = None
    map_opacity: str | None = None
    roughness: float = 0.0
    uroughness: float = 0.0
    vroughness: float = 0.0
    remap_roughness: bool = True
    index: float = 1.5
    opacity: np.ndarray | None = None
    sigma: float = 0.0
    # disney
    color: np.ndarray | None = None
    metallic: float = 0.0
    spec_trans: float = 0.0
    # mix
    material0: str | None = None
    material1: str | None = None
    amount: float = 0.5
    # subsurface (mean free path; scattering = 1/mfp at conversion)
    mfp: np.ndarray | None = None
    # hair (fiber absorption)
    sigma_a: np.ndarray | None = None


@dataclass
class TextureIR:
    name: str = ""
    type: str = "imagemap"  # imagemap | checkerboard | scale | constant | mix
    filename: str = ""
    gamma: bool = True
    uscale: float = 1.0
    vscale: float = 1.0
    scale: float = 1.0
    tex1: np.ndarray | None = None
    tex2: np.ndarray | None = None
    tex1_name: str | None = None
    tex2_name: str | None = None
    # noise-texture parameters (fbm / wrinkled / marble / windy)
    octaves: int = 8
    roughness: float = 0.5
    variation: float = 0.2


@dataclass
class TriangleMeshIR:
    indices: np.ndarray = None      # (T, 3) int32
    positions: np.ndarray = None    # (V, 3) float32, object space
    normals: np.ndarray | None = None
    uvs: np.ndarray | None = None
    tangents: np.ndarray | None = None
    material: str = ""
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    emission: np.ndarray | None = None  # radiance if an area light
    alpha_texture: str | None = None
    reverse_orientation: bool = False


@dataclass
class SphereIR:
    radius: float = 1.0
    material: str = ""
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    emission: np.ndarray | None = None
    reverse_orientation: bool = False


@dataclass
class CurveIR:
    control_points: np.ndarray = None  # (4 + 3k, 3) cubic bezier segments
    width0: float = 1.0
    width1: float = 1.0
    degree: int = 3
    material: str = ""
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    emission: np.ndarray | None = None
    reverse_orientation: bool = False


@dataclass
class AreaLightIR:
    L: np.ndarray = None


@dataclass
class InfiniteLightIR:
    mapname: str = ""
    L: np.ndarray = None
    scale: np.ndarray = None
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class DistantLightIR:
    L: np.ndarray = None
    direction: np.ndarray = None  # world-space, from->to
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class PointLightIR:
    I: np.ndarray = None
    from_point: np.ndarray = None
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class ObjectIR:
    name: str = ""
    shapes: list = field(default_factory=list)


@dataclass
class InstanceIR:
    object_name: str = ""
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class SceneIR:
    base_dir: str = "."
    film: FilmIR = field(default_factory=FilmIR)
    sampler: SamplerIR = field(default_factory=SamplerIR)
    integrator: IntegratorIR = field(default_factory=IntegratorIR)
    camera: CameraIR = field(default_factory=CameraIR)
    pixel_filter: str = "box"
    filter_xwidth: float = 1.0
    materials: dict = field(default_factory=dict)   # name -> MaterialIR
    textures: dict = field(default_factory=dict)    # name -> TextureIR
    shapes: list = field(default_factory=list)      # top-level shapes
    objects: dict = field(default_factory=dict)     # name -> ObjectIR
    instances: list = field(default_factory=list)   # InstanceIR
    lights: list = field(default_factory=list)      # non-area lights
    # One optional heterogeneous medium (the reference's single-volume
    # model, TracerBoy.cpp:1096-1184 / TracerBoy.h:733): a VolumeIR
    # from MakeNamedMedium "heterogeneous" or an external grid file.
    volume: object = None

    def triangle_count(self) -> int:
        n = 0
        for s in self.all_shapes():
            if isinstance(s, TriangleMeshIR):
                n += len(s.indices)
        return n

    def all_shapes(self):
        """Yield all shapes including instanced ones (transform composed)."""
        for s in self.shapes:
            yield s
        for inst in self.instances:
            obj = self.objects.get(inst.object_name)
            if obj is None:
                continue
            for s in obj.shapes:
                import copy

                s2 = copy.copy(s)
                s2.transform = inst.transform @ s.transform
                yield s2
