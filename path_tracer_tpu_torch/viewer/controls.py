"""Interactive camera controls — pure math, host-side.

Parity with the reference viewport's modifier-key control scheme
(``src/views/viewport_tab.rs:207-371``): plain scroll = orbit, Shift = zoom,
Cmd = pan, Shift+Cmd = look-around; orbit pivots around the ray-cast hit
point under the view center with bounding-box then distance fallbacks
(``OrbitingAround::new`` viewport_tab.rs:40-56, ``get_orbit_point``
viewport_tab.rs:401-431); yaw/pitch via axis-angle rotations with the same
sensitivities (orbit 0.0018, zoom |pos|*0.002, pan |pos|*0.0002, look 1/h).

Counterpart of ``path_tracer_tpu.viewer.controls``, copied onto the port's
camera and host intersector.
"""

from __future__ import annotations

import numpy as np

from path_tracer_tpu_torch.models.camera import Camera, normalize_f32
from path_tracer_tpu_torch.models.scene import SceneDescriptor, pack_scene
from path_tracer_tpu_torch.ops.host_intersect import (
    intersect_bounds_packed,
    intersect_packed,
    pack_scene_bounds,
)

ORBIT_SENSITIVITY = 0.0018
ZOOM_MAGNITUDE = 0.002
PAN_MAGNITUDE = 0.0002
LOOK_AROUND_SENSITIVITY = 1.0

UP = np.array([0.0, 1.0, 0.0], np.float32)


def axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix (Mat4::from_axis_angle equivalent, 3x3)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return (np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)).astype(np.float32)


class SceneNavigator:
    """Holds the picking structures for a scene and applies camera moves."""

    def __init__(self, scene: SceneDescriptor):
        self.scene = scene
        self.packed = pack_scene(scene)
        self.bbox_tris, self.bbox_obj = pack_scene_bounds(scene)
        self._orbit_point: np.ndarray | None = None

    # --- picking ---

    def get_orbit_point(self) -> np.ndarray:
        """Pivot for orbiting: the actual hit along the view axis if any,
        else the nearest bounding-box hit, else a distance-based fallback
        (viewport_tab.rs:40-56,401-431; simplified to global rather than
        per-object preference — identical except when one object's AABB hit
        is nearer than another object's surface hit)."""
        cam = self.scene.camera
        o = cam.lens_center().astype(np.float64)
        d = cam.direction.astype(np.float64)
        actual = intersect_packed(self.packed, o, d)
        if actual is not None:
            return (o + d * actual[0]).astype(np.float32)
        bounds = intersect_bounds_packed(
            self.packed, self.bbox_tris, self.bbox_obj, o, d
        )
        if bounds is not None:
            return (o + d * bounds[0]).astype(np.float32)
        lc = cam.lens_center()
        return (lc + cam.direction * np.linalg.norm(lc)).astype(np.float32)

    def pick_object(self, relx: float, rely: float, aspect_ratio: float):
        """Click-select: unproject screen point via the inverse
        view-projection and intersect (viewport_tab.rs:226-249).
        relx, rely in [0,1] with y measured UP from the bottom edge."""
        cam = self.scene.camera
        x_adj = relx * 2.0 - 1.0
        y_adj = rely * 2.0 - 1.0
        vp = cam.view_projection(aspect_ratio).astype(np.float64)
        inv = np.linalg.inv(vp)
        p = inv @ np.array([x_adj, y_adj, 1.0, 1.0])
        world = p[:3] / p[3]
        direction = normalize_f32((world - cam.position).astype(np.float32))
        hit = intersect_packed(self.packed, cam.lens_center(), direction)
        return None if hit is None else hit[1]

    # --- camera moves (each returns the mutated camera) ---

    def begin_orbit(self) -> None:
        self._orbit_point = self.get_orbit_point()

    def end_orbit(self) -> None:
        self._orbit_point = None

    def orbit(self, dx: float, dy: float) -> Camera:
        """Scroll-orbit around the pivot (viewport_tab.rs:287-327)."""
        cam = self.scene.camera
        if self._orbit_point is None:
            self.begin_orbit()
        pivot = self._orbit_point
        direction = cam.position - pivot
        yaw = axis_angle_matrix(UP, -dx * ORBIT_SENSITIVITY)
        with_yaw = yaw @ direction
        right = normalize_f32(np.cross(with_yaw, UP).astype(np.float32))
        pitch = axis_angle_matrix(right, dy * ORBIT_SENSITIVITY)
        new_dir = pitch @ with_yaw
        cam.position = (pivot + new_dir).astype(np.float32)
        cam.set_direction(-new_dir)
        return cam

    def zoom(self, dy: float) -> Camera:
        """Shift-scroll: dolly along the view direction
        (viewport_tab.rs:276-286)."""
        cam = self.scene.camera
        magnitude = np.linalg.norm(cam.position) * ZOOM_MAGNITUDE
        cam.position = (cam.position + cam.direction * dy * magnitude).astype(
            np.float32
        )
        return cam

    def pan(self, dx: float, dy: float) -> Camera:
        """Cmd-scroll: translate in the view plane (viewport_tab.rs:328-343)."""
        cam = self.scene.camera
        right = normalize_f32(np.cross(cam.direction, UP).astype(np.float32))
        up = normalize_f32(np.cross(right, cam.direction).astype(np.float32))
        move = right * -dx + up * dy
        magnitude = np.linalg.norm(cam.position) * PAN_MAGNITUDE
        cam.position = (cam.position + move * magnitude).astype(np.float32)
        return cam

    def look_around(self, dx: float, dy: float, viewport_height: float) -> Camera:
        """Shift+Cmd-scroll: rotate the view direction in place
        (viewport_tab.rs:344-367)."""
        cam = self.scene.camera
        s = LOOK_AROUND_SENSITIVITY / viewport_height
        yaw = axis_angle_matrix(UP, -dx * s)
        new_dir = yaw @ cam.direction
        right = normalize_f32(np.cross(new_dir, UP).astype(np.float32))
        pitch = axis_angle_matrix(right, -dy * s)
        cam.set_direction(pitch @ new_dir)
        return cam
