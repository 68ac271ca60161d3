"""Raster preview: a z-buffer rasterizer in plain torch with the reference
viewport's shading semantics.

Counterpart of ``path_tracer_tpu.viewer.raster`` (the reference's wgpu
pipelines and WESL shaders, ``src/views/viewport/viewport_render.rs`` and
``src/shaders/*.wesl``):

- scene tessellation (numpy): spheres → 16×32 UV mesh, meshes → their
  triangles, plus the adaptive log-spaced ground grid (``get_grid``,
  viewport_render.rs:472-504); vertex budget 40K (viewport_render.rs:428);
  a near-plane clip (``clip_near_plane``);
- objects pass: MVP transform; normal FAKED as ``normalize(world_position)``
  (the reference's centered-model assumption, objects.wesl:29); lighting
  with hard-coded light at (1,-5,5), ambient 0.1, specular 0.5, shininess 32
  (objects.wesl:40-71);
- sky pass: vertical gradient top (0.2,0.2,0.2) → bottom (0.13,0.1,0.1)
  modulated by camera direction (sky.wesl:29-47);
- outline/post pass: split screen — bottom half color, top half depth^0.4
  (outline.wesl:27-45).

Depth convention is wgpu's [0,1]; world-position varyings interpolate
perspective-correct, depth linearly in screen space (GPU behaviour).
``_raster_core`` runs on the given device as a loop over chunks of 256
triangles, each a [pixels, 256] edge-function test. The viewer app does
not call it (its ``/preview.png`` is the progressive renderer), as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.models.camera import Camera
from path_tracer_tpu_torch.models.geometry import sphere_to_triangles
from path_tracer_tpu_torch.models.scene import SceneDescriptor

SKY_TOP = np.array([0.2, 0.2, 0.2], np.float32)
SKY_BOTTOM = np.array([0.13, 0.1, 0.1], np.float32)
LIGHT_POSITION = np.array([1.0, -5.0, 5.0], np.float32)
LIGHT_COLOR = np.array([1.0, 1.0, 1.0], np.float32)
AMBIENT_STRENGTH = 0.1
SPECULAR_STRENGTH = 0.5
SHININESS = 32.0
VERTEX_BUDGET = 1024 * 40
GRID_LINES = 5
GRID_COLOR = np.array([0.5, 0.5, 0.5], np.float32)
CHUNK = 256  # triangles a step of the z-buffer loop


def grid_triangles(camera: Camera) -> tuple[np.ndarray, np.ndarray]:
    """Adaptive ground grid (viewport_render.rs:472-504): 2*(2*5+1) lines of
    2 triangles each, log-scaled spacing, width 0.02*zoom."""
    zoom = float(np.linalg.norm(camera.position)) / 5.0
    spacing = float(10 ** int(np.floor(np.log10(zoom * 1.2 + 1.0))))
    half_w = 0.02 * zoom / 2.0
    extent = GRID_LINES * spacing

    tris = []
    for axis in (np.array([1.0, 0, 0]), np.array([0.0, 0, 1])):
        other = np.cross(np.array([0.0, 1.0, 0.0]), axis)
        for i in range(-GRID_LINES, GRID_LINES + 1):
            off = i * spacing
            p1 = axis * (off - half_w) - other * extent
            p2 = axis * (off + half_w) - other * extent
            p3 = p1 + other * extent * 2.0
            p4 = p2 + other * extent * 2.0
            tris.append(np.stack([p1, p2, p4]))
            tris.append(np.stack([p1, p4, p3]))
    t = np.asarray(tris, np.float32)
    return t, np.tile(GRID_COLOR, (len(t), 1))


def tessellate_scene(scene: SceneDescriptor) -> tuple[np.ndarray, np.ndarray]:
    """Triangles [T,3,3] + flat colors [T,3]; grid first, then objects
    (get_verts, viewport_render.rs:439-459), truncated to the vertex budget."""
    tris, colors = [], []
    g_t, g_c = grid_triangles(scene.camera)
    tris.append(g_t)
    colors.append(g_c)
    for obj in scene.objects:
        t = (
            sphere_to_triangles(obj.radius)
            if obj.is_sphere
            else obj.mesh.triangles
        )
        t = t + obj.position[None, None, :]
        tris.append(t.astype(np.float32))
        colors.append(np.tile(obj.material.color, (len(t), 1)))
    t = np.concatenate(tris)
    c = np.concatenate(colors).astype(np.float32)
    max_tris = VERTEX_BUDGET // 3
    return t[:max_tris], c[:max_tris]


def _fma(a, b, c):
    """a * b + c rounded once to float32 (an exact float64 product, then one
    sum), as XLA contracts the JAX package's multiply-adds: the depth
    interpolation at near-plane-clipped vertices is ill-conditioned, and a
    second rounding moves depth by up to ~2e-4."""
    return (a.double() * b.double() + c.double()).float()


def _rsqrt_rows(v):
    return torch.rsqrt(torch.clamp(torch.sum(v * v, dim=1, keepdim=True), min=1e-20))


def _raster_core(tri_v, tri_color, view_proj, cam_dir, width: int,
                 height: int, chunk: int = CHUNK):
    """Rasterize triangles tri_v [T,3,3] with colors [T,3] (tensors on one
    device) through view_proj [4,4]; cam_dir [3] is the camera's unit
    direction. Returns (color [H,W,3], depth [H,W], composite [H,W,3])."""
    H, W = height, width
    dev = tri_v.device
    f32 = torch.float32

    # project: world -> clip -> NDC -> screen, the four clip rows in one
    # product (a matrix-vector product for w rounds otherwise)
    hom = tri_v.reshape(-1, 3) @ view_proj[:, :3].T + view_proj[:, 3][None, :]
    clip = hom[:, :3].reshape(-1, 3, 3)
    wcl = hom[:, 3].reshape(-1, 3)
    ok_w = torch.all(wcl > 1e-6, dim=1)  # crude near-plane reject
    ndc = clip / wcl[:, :, None]
    sx = (ndc[:, :, 0] + 1.0) * 0.5 * W
    sy = (1.0 - ndc[:, :, 1]) * 0.5 * H
    sz = ndc[:, :, 2]
    inv_w = 1.0 / wcl

    px = torch.arange(W, dtype=f32, device=dev) + 0.5
    py = torch.arange(H, dtype=f32, device=dev) + 0.5
    P_x = px[None, :].expand(H, W).reshape(-1)[:, None]  # [HW,1]
    P_y = py[:, None].expand(H, W).reshape(-1)[:, None]

    zbuf = torch.full((H * W,), 1.0, dtype=f32, device=dev)
    wp = torch.zeros((H * W, 3), dtype=f32, device=dev)
    col = torch.zeros((H * W, 3), dtype=f32, device=dev)
    hit = torch.zeros((H * W,), dtype=torch.bool, device=dev)

    for c0 in range(0, tri_v.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        ax, ay, az, aw = sx[sl], sy[sl], sz[sl], inv_w[sl]
        av, ac = tri_v[sl], tri_color[sl]

        # edge functions: e_k(p) for each pixel x tri   [HW, chunk]
        x0, x1, x2 = ax[:, 0][None], ax[:, 1][None], ax[:, 2][None]
        y0, y1, y2 = ay[:, 0][None], ay[:, 1][None], ay[:, 2][None]
        e0 = _fma(x1 - x0, P_y - y0, -((y1 - y0) * (P_x - x0)))
        e1 = _fma(x2 - x1, P_y - y1, -((y2 - y1) * (P_x - x1)))
        e2 = _fma(x0 - x2, P_y - y2, -((y0 - y2) * (P_x - x2)))
        area = _fma(x1 - x0, y2 - y0, -((y1 - y0) * (x2 - x0)))
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
            (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
        )
        inside &= (torch.abs(area) > 1e-12) & ok_w[sl][None, :]
        inv_area = 1.0 / torch.where(torch.abs(area) > 1e-12, area, 1.0)
        b0 = e1 * inv_area  # weight of vertex 0
        b1 = e2 * inv_area
        b2 = e0 * inv_area

        z = _fma(b2, az[:, 2][None], _fma(b1, az[:, 1][None], b0 * az[:, 0][None]))
        inside &= (z >= 0.0) & (z <= 1.0)
        z = torch.where(inside, z, 2.0)

        zmin, win = torch.min(z, dim=1)  # first minimal index
        better = zmin < zbuf

        # perspective-correct world position of the winning triangle
        w_ = win[:, None]
        bw0 = torch.gather(b0, 1, w_)[:, 0]
        bw1 = torch.gather(b1, 1, w_)[:, 0]
        bw2 = torch.gather(b2, 1, w_)[:, 0]
        vwin = av[win]  # [HW,3,3]
        iw = aw[win]  # [HW,3]
        pw = bw0 * iw[:, 0] + bw1 * iw[:, 1] + bw2 * iw[:, 2]
        wpos = (
            vwin[:, 0] * (bw0 * iw[:, 0])[:, None]
            + vwin[:, 1] * (bw1 * iw[:, 1])[:, None]
            + vwin[:, 2] * (bw2 * iw[:, 2])[:, None]
        ) / torch.clamp(pw, min=1e-20)[:, None]

        zbuf = torch.where(better, zmin, zbuf)
        wp = torch.where(better[:, None], wpos, wp)
        col = torch.where(better[:, None], ac[win], col)
        hit = hit | better

    # --- objects.wesl fragment shading ---
    normal = wp * _rsqrt_rows(wp)
    lp = torch.from_numpy(LIGHT_POSITION).to(dev)
    ld = lp[None, :] - wp
    ld = ld * _rsqrt_rows(ld)
    diff = torch.clamp(torch.sum(normal * ld, dim=1), min=0.0)
    view_dir = -wp * _rsqrt_rows(wp)
    refl = -ld - normal * (2.0 * torch.sum(normal * -ld, dim=1, keepdim=True))
    spec = torch.pow(torch.clamp(torch.sum(view_dir * refl, dim=1), min=0.0),
                     SHININESS)
    lit = (
        AMBIENT_STRENGTH
        + diff[:, None] * torch.from_numpy(LIGHT_COLOR).to(dev)[None, :]
        + SPECULAR_STRENGTH * spec[:, None]
    )
    shaded = lit * col

    # --- sky.wesl background ---
    uv_y = P_y / H
    sky = (torch.from_numpy(SKY_TOP).to(dev)[None, :] * (1 - uv_y)
           + torch.from_numpy(SKY_BOTTOM).to(dev)[None, :] * uv_y)
    cam_factor = cam_dir[1] * 0.2  # dot(normalize(dir), +Y) * 0.2
    sky = sky * (1.0 + cam_factor * 0.5)

    color = torch.where(hit[:, None], shaded, sky).reshape(H, W, 3)
    depth = torch.where(hit, zbuf, 1.0).reshape(H, W)

    # --- outline.wesl split-screen post pass ---
    depth_vis = torch.pow(depth, 0.4)[:, :, None].expand(H, W, 3)
    top_half = (torch.arange(H, device=dev) < H // 2)[:, None, None]
    composite = torch.where(top_half, depth_vis, color)
    return color, depth, composite


def clip_near_plane(
    tri_v: np.ndarray, tri_color: np.ndarray, camera: Camera, eps: float = 2e-3
) -> tuple[np.ndarray, np.ndarray]:
    """Sutherland–Hodgman clip of triangles against the camera's near plane
    (the GPU clips in clip space; the rasterizer rejects whole triangles
    with any vertex behind the camera, which would cull the walls of a box
    the camera sits inside)."""
    n = camera.direction.astype(np.float64)
    p0 = camera.position.astype(np.float64) + n * eps
    out_v, out_c = [], []
    for tri, col in zip(tri_v.astype(np.float64), tri_color):
        dist = (tri - p0) @ n
        inside = dist > 0
        if inside.all():
            out_v.append(tri)
            out_c.append(col)
            continue
        if not inside.any():
            continue
        poly = []
        for i in range(3):
            j = (i + 1) % 3
            if inside[i]:
                poly.append(tri[i])
            if inside[i] != inside[j]:
                t = dist[i] / (dist[i] - dist[j])
                poly.append(tri[i] + (tri[j] - tri[i]) * t)
        for k in range(1, len(poly) - 1):
            out_v.append(np.stack([poly[0], poly[k], poly[k + 1]]))
            out_c.append(col)
    if not out_v:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.stack(out_v).astype(np.float32), np.stack(out_c).astype(np.float32)


def render_preview(scene: SceneDescriptor, width: int = 300, height: int = 200,
                   *, device="cuda") -> dict[str, np.ndarray]:
    """Rasterize the scene on ``device``. Returns {'color','depth',
    'composite'} numpy arrays ([H,W,3], [H,W], [H,W,3]); 'composite' is the
    split-screen debug view."""
    tri_v, tri_color = tessellate_scene(scene)
    tri_v, tri_color = clip_near_plane(tri_v, tri_color, scene.camera)
    vp = scene.camera.view_projection(width / height)
    dirn = scene.camera.direction / np.linalg.norm(scene.camera.direction)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    color, depth, composite = _raster_core(
        put(tri_v), put(tri_color), put(vp), put(dirn), width, height)
    return {
        "color": color.cpu().numpy(),
        "depth": depth.cpu().numpy(),
        "composite": composite.cpu().numpy(),
    }
