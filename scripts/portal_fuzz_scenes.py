"""Random portal-eligible scenes: one heavy mesh plus cheap primitives.

Each scene is one random heavy mesh (a bumpy tessellated sphere of 80 to
220 triangles, at least ``PORTAL_MIN_TRIS``) plus at most 128 cheap
primitives (random spheres, one of them a light above the mesh and about a
third of the others lights, a floor quad and a few random triangles), seen
from a random camera. tests/test_torch_portal_fuzz.py holds the portal
scheduler to the brute-force route on them; chip_smoke.py holds K2 to its
plain version on one. Imports neither jax nor the JAX package.

  from portal_fuzz_scenes import fuzz_scene;  fuzz_scene(seed)
"""

import numpy as np

import path_tracer_tpu_torch as tpt


def _material(g, light=False):
    color = g.uniform(0.2, 0.9, 3).astype(np.float32)
    if light:
        return tpt.Material(color, np.full(3, g.uniform(2.0, 8.0), np.float32),
                            tpt.ReflectType.DIFFUSE)
    kind = tpt.ReflectType(int(g.choice(3, p=[0.6, 0.2, 0.2])))
    return tpt.Material(color, np.zeros(3, np.float32), kind)


def _bumpy_sphere(g):
    """A closed tessellated sphere with random radii: nu * (2 nv - 2)
    triangles, at least 80."""
    nu, nv = int(g.integers(8, 12)), int(g.integers(6, 12))
    th = np.linspace(0.0, np.pi, nv + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, nu + 1)[None, :]
    r = 1.0 + 0.2 * g.random((nv + 1, nu + 1))
    r[:, -1] = r[:, 0]
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th) + 0.0 * ph,
                    r * np.sin(th) * np.sin(ph)], axis=-1)
    tris = []
    for i in range(nv):
        for j in range(nu):
            a, b = pts[i, j], pts[i, j + 1]
            c, d = pts[i + 1, j], pts[i + 1, j + 1]
            if i > 0:
                tris.append([a, b, c])
            if i < nv - 1:
                tris.append([b, d, c])
    return np.asarray(tris, np.float32)


def fuzz_scene(seed: int) -> tpt.SceneDescriptor:
    g = np.random.default_rng(seed)
    heavy = _bumpy_sphere(g)
    objs = [tpt.SceneObject.from_mesh(g.uniform(-0.5, 0.5, 3).astype(np.float32),
                                      tpt.Mesh.from_triangles(heavy),
                                      _material(g))]
    objs.append(tpt.SceneObject.sphere(  # a light in view, above the mesh
        np.array([g.uniform(-2, 2), 3.0, -2.0], np.float32), 1.5,
        _material(g, light=True)))
    for _ in range(int(g.integers(2, 40))):
        centre = np.array([g.uniform(-4, 4), g.uniform(-2, 4),
                           g.uniform(-6, 0)], np.float32)
        objs.append(tpt.SceneObject.sphere(centre, float(g.uniform(0.2, 1.2)),
                                           _material(g, g.random() < 0.3)))
    floor = np.array([[[-10, -2, -12], [10, -2, -12], [-10, -2, 6]],
                      [[10, -2, -12], [10, -2, 6], [-10, -2, 6]]], np.float32)
    loose = g.uniform(-3, 3, (int(g.integers(1, 20)), 3, 3)).astype(np.float32)
    objs.append(tpt.SceneObject.from_mesh(
        np.zeros(3, np.float32),
        tpt.Mesh.from_triangles(np.concatenate([floor, loose])), _material(g)))
    eye = np.array([g.uniform(-1, 1), g.uniform(0, 1), 8.0], np.float32)
    look = np.array([g.uniform(-0.1, 0.1), g.uniform(-0.1, 0.1), -1.0],
                    np.float32)
    return tpt.SceneDescriptor(id=f"fuzz{seed}", objects=objs,
                               camera=tpt.Camera.looking(eye, look))


# ---- a strip: tiles in a row, and rays whose lines enter all of them ----

STRIP_HALF = 0.05  # half the strip's height and depth


def strip_scene(n_tris: int = 2240) -> tpt.SceneDescriptor:
    """A portal-eligible scene of ``n_tris`` small triangles laid along the
    x axis from -6 to 6 (all with the same centroid y and z, so their Morton
    order is their order along x and the tiles of TRI_TILE rows lie in a
    row: 35 tiles for 2,240), a floor and a light sphere."""
    h = STRIP_HALF
    x0 = np.linspace(-6.0, 6.0, n_tris, dtype=np.float32)
    w = np.float32(0.8 * 12.0 / n_tris)
    tris = np.zeros((n_tris, 3, 3), np.float32)
    tris[:, 0] = np.stack([x0, np.full_like(x0, -h), np.full_like(x0, -h)], 1)
    tris[:, 1] = np.stack([x0 + w, np.full_like(x0, h), np.full_like(x0, -h)], 1)
    tris[:, 2] = np.stack([x0, np.full_like(x0, h), np.full_like(x0, h)], 1)
    grey = tpt.Material(np.full(3, 0.7, np.float32), np.zeros(3, np.float32),
                        tpt.ReflectType.DIFFUSE)
    light = tpt.Material(np.full(3, 0.9, np.float32), np.full(3, 6.0, np.float32),
                         tpt.ReflectType.DIFFUSE)
    floor = np.array([[[-10, -1, -8], [10, -1, -8], [-10, -1, 8]],
                      [[10, -1, -8], [10, -1, 8], [-10, -1, 8]]], np.float32)
    objs = [tpt.SceneObject.from_mesh(np.zeros(3, np.float32),
                                      tpt.Mesh.from_triangles(tris), grey),
            tpt.SceneObject.from_mesh(np.zeros(3, np.float32),
                                      tpt.Mesh.from_triangles(floor), grey),
            tpt.SceneObject.sphere(np.array([0.0, 3.0, -1.0], np.float32), 1.0,
                                   light)]
    return tpt.SceneDescriptor(id="strip", objects=objs, camera=tpt.Camera.looking(
        np.array([0.0, 0.6, 7.0], np.float32),
        np.array([0.0, -0.1, -1.0], np.float32)))


def strip_rays(n: int, g) -> tuple[np.ndarray, np.ndarray]:
    """n rays ([n, 3] origins and unit directions, float32) along the
    strip of ``strip_scene``, from either end, within its height and depth:
    each one's line enters every tile's AABB."""
    sign = np.where(g.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = -7.0 * sign
    o[:, 1:] = g.uniform(-0.8 * STRIP_HALF, 0.8 * STRIP_HALF, (n, 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = sign
    return o, d
