"""Built-in scene registry.

Parity: ``load_scene_ids`` / ``setup_scenes`` (``src/render/scenes.rs``): list
``scenes/*.json`` stems; if none exist, generate the six built-in scenes
(single-sphere, cartesian, two-spheres, three-spheres, cornell, mesh) and save
them. All constants below match ``scenes.rs:43-318`` and are computed in f32
so the serialized JSON matches the reference's files (e.g. the emission
``14.700001 = f32(0.98*15)`` in single-sphere.json).
"""

from __future__ import annotations

import os

import numpy as np

from path_tracer_tpu_torch.models.camera import Camera
from path_tracer_tpu_torch.models.geometry import single_quad_mesh
from path_tracer_tpu_torch.models.material import Material, ReflectType
from path_tracer_tpu_torch.models.off import load_off
from path_tracer_tpu_torch.models.scene import SceneDescriptor, SceneObject

F32 = np.float32

BOX = np.array([2.6, 2.0, 8.8], np.float32)  # Cornell box half-extents


def _v(x, y, z) -> np.ndarray:
    return np.array([x, y, z], np.float32)


def _cornell_box() -> list[SceneObject]:
    """The 7 wall quads of the Cornell box (scenes.rs:51-123)."""
    light_tint = _v(0.98, 1.0, 0.9)
    return [
        # Right wall - Red
        SceneObject.from_mesh(
            _v(BOX[0], 0, 0),
            single_quad_mesh(BOX[1], BOX[2], 0, True),
            Material(_v(0.85, 0.25, 0.25), _v(0, 0, 0), ReflectType.DIFFUSE),
        ),
        # Left wall - Blue
        SceneObject.from_mesh(
            _v(-BOX[0], 0, 0),
            single_quad_mesh(BOX[1], BOX[2], 0, False),
            Material(_v(0.25, 0.35, 0.85), _v(0, 0, 0), ReflectType.DIFFUSE),
        ),
        # Top wall - White
        SceneObject.from_mesh(
            _v(0, BOX[1], 0),
            single_quad_mesh(BOX[2], BOX[0], 1, True),
            Material(_v(0.8, 0.8, 0.8), _v(0, 0, 0), ReflectType.DIFFUSE),
        ),
        # Bottom wall - White
        SceneObject.from_mesh(
            _v(0, -BOX[1], 0),
            single_quad_mesh(BOX[2], BOX[0], 1, False),
            Material(_v(0.7, 0.7, 0.7), _v(0, 0, 0), ReflectType.DIFFUSE),
        ),
        # Back wall - White
        SceneObject.from_mesh(
            _v(0, 0, -BOX[2]),
            single_quad_mesh(BOX[0], BOX[1], 2, True),
            Material(_v(0.95, 0.95, 0.95), _v(0, 0, 0), ReflectType.DIFFUSE),
        ),
        # Front wall - Invisible/Black
        SceneObject.from_mesh(
            _v(0, 0, BOX[2]),
            single_quad_mesh(BOX[0], BOX[1], 2, True),
            Material(_v(0.05, 0.05, 0.05), _v(0, 0, 0), ReflectType.DIFFUSE),
        ),
        # The ceiling area light source (slightly yellowish)
        SceneObject.from_mesh(
            _v(0, BOX[1] - F32(0.04), 0),
            single_quad_mesh(BOX[2], BOX[0], 1, True),
            Material(light_tint, light_tint * F32(0.9), ReflectType.DIFFUSE),
        ),
    ]


def builtin_scenes(mesh_dir: str = "meshes") -> list[SceneDescriptor]:
    """The six built-in scenes (scenes.rs:131-317)."""
    default_camera = Camera.looking(
        _v(0, -BOX[1] + F32(1.8), BOX[2] - F32(1.0)), _v(0, -0.06, -1.0)
    )
    diffuse = ReflectType.DIFFUSE

    def cam():
        # clone WITHOUT re-normalizing (parity: `default_camera.clone()`)
        return Camera(
            position=default_camera.position.copy(),
            direction=default_camera.direction.copy(),
        )

    scenes = [
        SceneDescriptor(
            id="single-sphere",
            objects=[
                SceneObject.sphere(
                    _v(0, 0, 0),
                    1.0,
                    Material(
                        _v(1, 1, 1),
                        _v(F32(0.98) * 15, 15.0, F32(0.9) * 15),
                        diffuse,
                    ),
                )
            ],
            camera=cam(),
        ),
        SceneDescriptor(
            id="cartesian",
            objects=[
                SceneObject.sphere(
                    _v(0, 0, 0), 0.3, Material(_v(0.9, 0.9, 0.9), _v(0, 0, 0), diffuse)
                ),
                SceneObject.sphere(
                    _v(1, 0, 0), 0.3, Material(_v(0.8, 0, 0), _v(0, 0, 0), diffuse)
                ),
                SceneObject.sphere(
                    _v(-1, 0, 0), 0.3, Material(_v(0, 0, 0.8), _v(0, 0, 0), diffuse)
                ),
                SceneObject.sphere(
                    _v(0, 1, 0), 0.3, Material(_v(0, 0.8, 0), _v(0, 0, 0), diffuse)
                ),
            ],
            camera=cam(),
        ),
        SceneDescriptor(
            id="two-spheres",
            objects=[
                SceneObject.sphere(
                    _v(0, 0, 0), 1.0, Material(_v(1, 0, 0), _v(0, 0, 0), diffuse)
                ),
                SceneObject.sphere(
                    _v(0, 0, 10), 1.0, Material(_v(0, 0, 0), _v(10, 10, 10), diffuse)
                ),
            ],
            camera=cam(),
        ),
        SceneDescriptor(
            id="three-spheres",
            objects=[
                SceneObject.sphere(
                    _v(0, 0, -3), 1.0, Material(_v(1, 0.2, 0.2), _v(0, 0, 0), diffuse)
                ),
                SceneObject.sphere(
                    _v(4, 2, 0), 1.0, Material(_v(0, 0, 0), _v(20, 10, 10), diffuse)
                ),
                SceneObject.sphere(
                    _v(-6, -2, 0), 1.0, Material(_v(0, 0, 0), _v(5, 9, 20), diffuse)
                ),
            ],
            camera=cam(),
        ),
        SceneDescriptor(
            id="cornell",
            objects=[
                # mirroring
                SceneObject.sphere(
                    _v(-1.3, -BOX[1] + F32(0.8), -1.3),
                    0.8,
                    Material(
                        _v(0.999, 0.999, 0.999), _v(0, 0, 0), ReflectType.SPECULAR
                    ),
                ),
                # refracting
                SceneObject.sphere(
                    _v(1.3, -BOX[1] + F32(0.8), -0.2),
                    0.8,
                    Material(
                        _v(0.999, 0.999, 0.999), _v(0, 0, 0), ReflectType.REFRACT
                    ),
                ),
                # emission
                SceneObject.sphere(
                    _v(0.08, -BOX[1] + F32(0.8), -0.8),
                    0.5,
                    Material(
                        _v(0.999, 0.999, 0.999),
                        _v(0.98, 1.0, 0.9) * F32(2.0),
                        diffuse,
                    ),
                ),
                # diffuse
                SceneObject.sphere(
                    _v(-0.08, -BOX[1] + F32(0.8), 0.7),
                    0.5,
                    Material(_v(0.4, 0.9, 0.49), _v(0, 0, 0), diffuse),
                ),
            ]
            + _cornell_box(),
            camera=cam(),
        ),
    ]

    mesh_path = os.path.join(mesh_dir, "mctri.off")
    mesh_objects = []
    if os.path.exists(mesh_path):
        mesh = load_off(mesh_path, 0.16)
        mesh.file = {"path": mesh_path, "scale": F32(0.16)}
        mesh_objects.append(
            SceneObject.from_mesh(
                _v(-0.8, -BOX[1] + F32(0.5), 0.0),
                mesh,
                Material(_v(F32(234.0) / 255, 1.0, 0.0), _v(0, 0, 0), diffuse),
            )
        )
    scenes.append(
        SceneDescriptor(
            id="mesh",
            objects=mesh_objects + _cornell_box(),
            camera=Camera.looking(
                _v(0.9, -BOX[1] + F32(1.8), BOX[2] - F32(1.0)),
                _v(-0.09, -0.06, -1.0),
            ),
        )
    )
    return scenes


def load_scene_ids(scene_dir: str = "scenes", mesh_dir: str = "meshes") -> list[str]:
    """List scene ids from scene_dir; generate + save built-ins if empty
    (parity with ``load_scene_ids``, scenes.rs:10-41)."""
    ids = []
    if os.path.isdir(scene_dir):
        for name in sorted(os.listdir(scene_dir)):
            if name.endswith(".json") and os.path.isfile(
                os.path.join(scene_dir, name)
            ):
                ids.append(name[: -len(".json")])
    if not ids:
        scenes = builtin_scenes(mesh_dir)
        for scene in scenes:
            try:
                scene.save(scene_dir)
            except OSError as e:
                print(f"Failed to save scene '{scene.id}': {e}")
        ids = [s.id for s in scenes]
    return ids


def load_scene(scene_id: str, scene_dir: str = "scenes", mesh_dir: str = "meshes"):
    """Load a scene by id, generating built-ins if the file is missing."""
    path = os.path.join(scene_dir, f"{scene_id}.json")
    if not os.path.exists(path):
        for scene in builtin_scenes(mesh_dir):
            if scene.id == scene_id:
                return scene
        raise FileNotFoundError(f"no such scene: {scene_id}")
    return SceneDescriptor.load(scene_id, scene_dir)
