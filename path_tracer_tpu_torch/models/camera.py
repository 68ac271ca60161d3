"""Pinhole camera.

Parity: ``camera_data::CameraData`` in the reference
(``src/render/mod.rs:158-234``): focal_length 0.035 m, sensor_width 0.036 m,
aspect ratio 3:2, sensor-plane basis with up-vector switch at |dir.y| >= 0.9,
lens center at ``position + direction * focal_length``.

Counterpart of ``path_tracer_tpu.models.camera``, with the look-at and
perspective matrices that viewport picking (``viewer.controls``) and the
raster preview use.

All math is float32 to match the reference's f32 arithmetic bit-for-bit where
possible (e.g. the serialized normalized direction of the built-in scenes).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

F32 = np.float32

DEFAULT_FOCAL_LENGTH = F32(0.035)
DEFAULT_SENSOR_WIDTH = F32(0.036)
DEFAULT_ASPECT_RATIO = F32(3.0) / F32(2.0)


def _vec3(x) -> np.ndarray:
    v = np.asarray(x, dtype=np.float32)
    if v.shape != (3,):
        raise ValueError(f"expected 3-vector, got shape {v.shape}")
    return v


def normalize_f32(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    # glam's normalize: v * inverse_sqrt(dot(v, v)) in f32
    return (v * F32(1.0 / np.sqrt(np.dot(v, v), dtype=np.float32))).astype(np.float32)


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    focal_length: float = DEFAULT_FOCAL_LENGTH
    sensor_width: float = DEFAULT_SENSOR_WIDTH
    aspect_ratio: float = DEFAULT_ASPECT_RATIO

    def __post_init__(self):
        self.position = _vec3(self.position)
        self.direction = _vec3(self.direction)
        self.focal_length = F32(self.focal_length)
        self.sensor_width = F32(self.sensor_width)
        self.aspect_ratio = F32(self.aspect_ratio)

    @staticmethod
    def looking(position, direction) -> "Camera":
        """Constructor parity: ``CameraData::new`` normalizes the direction."""
        return Camera(position=_vec3(position), direction=normalize_f32(direction))

    def set_direction(self, direction) -> None:
        self.direction = normalize_f32(direction)

    @property
    def sensor_height(self) -> np.float32:
        return F32(self.sensor_width / self.aspect_ratio)

    def lens_center(self) -> np.ndarray:
        return (self.position + self.direction * self.focal_length).astype(np.float32)

    def orthogonals(self) -> tuple[np.ndarray, np.ndarray]:
        """(su, sv): orthogonal sensor-plane spanning vectors scaled by the
        sensor dimensions (``mod.rs:221-232``)."""
        d = self.direction
        up = (
            np.array([0, 1, 0], np.float32)
            if abs(float(d[1])) < 0.9
            else np.array([0, 0, 1], np.float32)
        )
        su = normalize_f32(np.cross(d, up).astype(np.float32))
        sv = np.cross(su, d).astype(np.float32)
        return (su * self.sensor_width).astype(np.float32), (
            sv * self.sensor_height
        ).astype(np.float32)

    # --- rasterizer and picking support (viewport parity, mod.rs:188-202) ---

    def fov_y(self) -> float:
        return float(2.0 * np.arctan(self.sensor_height / (2.0 * self.focal_length)))

    def view_matrix(self) -> np.ndarray:
        """Right-handed look-at from position toward lens_center, up +Y."""
        eye = self.position.astype(np.float64)
        center = self.lens_center().astype(np.float64)
        up = np.array([0.0, 1.0, 0.0])
        f = center - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4)
        m[0, :3] = s
        m[1, :3] = u
        m[2, :3] = -f
        m[0, 3] = -np.dot(s, eye)
        m[1, 3] = -np.dot(u, eye)
        m[2, 3] = np.dot(f, eye)
        return m.astype(np.float32)

    def projection_matrix(self, aspect_ratio: float) -> np.ndarray:
        """Right-handed perspective, depth range [0,1] (wgpu convention),
        near 0.001, far 1000 — parity with ``Mat4::perspective_rh``."""
        fov, near, far = self.fov_y(), 0.001, 1000.0
        f = 1.0 / np.tan(fov / 2.0)
        m = np.zeros((4, 4))
        m[0, 0] = f / aspect_ratio
        m[1, 1] = f
        m[2, 2] = far / (near - far)
        m[2, 3] = near * far / (near - far)
        m[3, 2] = -1.0
        return m.astype(np.float32)

    def view_projection(self, aspect_ratio: float) -> np.ndarray:
        return (
            self.projection_matrix(aspect_ratio).astype(np.float64)
            @ self.view_matrix().astype(np.float64)
        ).astype(np.float32)

    # --- JSON (scene schema parity) ---

    @staticmethod
    def from_json(obj: dict) -> "Camera":
        # Unknown keys (e.g. legacy "updating_direction") are ignored.
        return Camera(
            position=_vec3(obj["position"]),
            direction=_vec3(obj["direction"]),
            focal_length=obj.get("focal_length", DEFAULT_FOCAL_LENGTH),
            sensor_width=obj.get("sensor_width", DEFAULT_SENSOR_WIDTH),
            aspect_ratio=obj.get("aspect_ratio", DEFAULT_ASPECT_RATIO),
        )

    def to_json(self) -> dict:
        return {
            "position": self.position,
            "direction": self.direction,
            "focal_length": F32(self.focal_length),
            "sensor_width": F32(self.sensor_width),
            "aspect_ratio": F32(self.aspect_ratio),
        }

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Camera)
            and np.array_equal(self.position, other.position)
            and np.array_equal(self.direction, other.direction)
            and self.focal_length == other.focal_length
            and self.sensor_width == other.sensor_width
            and self.aspect_ratio == other.aspect_ratio
        )
