"""Pieces of the regenerative trace: host prep and plain torch versions.

Counterpart of ``path_tracer_tpu.ops.pallas.trace_kernel``, for the pieces
that the static-scene regen kernel is built from:

- ``detect_quad_pairs``: the wall-quad collapse (host, numpy);
- ``make_raygen``: in-kernel camera sampling on the 2x2 subpixel grid;
- ``shade_phase``: Russian roulette, emission, BSDF sampling;
- ``regen_loop``: lanes own pixels and restart samples until a quota is done.

The torch functions here are the plain versions of what
``csrc/trace_regen.cu`` computes per thread: vectorised over [N] lanes,
every branch a ``torch.where``, operations in the JAX functions' order so
they agree lane for lane under the same uniforms. Per-ray values are lists
of three [N] tensors (x, y, z), as in the JAX functions.

Not ported, being TPU loop tuning: the all-done sync cadence
(``SYNC_EVERY``), ``WHILE_UNROLL`` and the loop-style probe. A CUDA thread
simply leaves its loop when its quota is done.
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import ScenePacked
from path_tracer_tpu_torch.render.raygen import tent_filter

F32 = torch.float32

_PI = np.float32(np.pi)
_TWO_PI = float(np.float32(2.0) * _PI)
_R0 = np.float32((1.5 - 1.0) ** 2 / (1.5 + 1.0) ** 2)
_ONE_MINUS_R0 = float(np.float32(1.0) - _R0)
_INV_IOR = float(np.float32(1.0 / 1.5))


def detect_quad_pairs(packed: ScenePacked):
    """Find consecutive triangle pairs (in packed order) that form a
    parallelogram with identical material — collapsible into ONE quad
    primitive whose Möller–Trumbore acceptance is u,v ∈ [0,1]² instead of
    u+v ≤ 1. Exact-parity argument: the pair shares a plane, so the quad's
    t/normal equal the triangles' (bitwise for the axis-aligned wall quads
    of scenes.rs:321-367); the parallelogram is exactly the union of the
    two triangles; and excluding the departed QUAD is equivalent to
    excluding the departed triangle because the coplanar partner is always
    rejected by the t > EPS_TRI_T test. The first triangle is rotated so
    the parallelogram corner (its vertex not shared with the partner)
    comes first; the partner's unique vertex must equal p1 + p2 - p0 in
    exact f32 (conservative: approximate quads stay as triangles).

    Returns (quads, covered): quads maps first-triangle packed index →
    rotated [3,3] vertices; covered is the set of consumed indices."""
    nt = packed.num_triangles
    tv = np.asarray(packed.tri_v[:nt], np.float32)
    color = np.asarray(packed.tri_color[:nt])
    emis = np.asarray(packed.tri_emis[:nt])
    rtype = np.asarray(packed.tri_rtype[:nt])
    mesh = np.asarray(packed.tri_mesh[:nt])
    quads: dict[int, np.ndarray] = {}
    covered: set[int] = set()
    i = 0
    while i + 1 < nt:
        j = i + 1
        if (
            mesh[i] == mesh[j]
            and np.array_equal(color[i], color[j])
            and np.array_equal(emis[i], emis[j])
            and rtype[i] == rtype[j]
        ):
            A, B = tv[i], tv[j]
            bset = {tuple(v) for v in B}
            uniq = [k for k in range(3) if tuple(A[k]) not in bset]
            if len(uniq) == 1:
                k = uniq[0]
                p0, p1, p2 = A[k], A[(k + 1) % 3], A[(k + 2) % 3]
                shared = {tuple(p1), tuple(p2)}
                uniq_b = [tuple(v) for v in B if tuple(v) not in shared]
                q = p1 + p2 - p0  # f32 arithmetic, exact-match required
                if len(uniq_b) == 1 and np.array_equal(
                    np.asarray(uniq_b[0], np.float32), q
                ):
                    quads[i] = np.stack([p0, p1, p2])
                    covered.update((i, j))
                    i += 2
                    continue
        i += 1
    return quads, covered


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def shade_phase(d, nrm, color, emis, rtype, found, thr, acc, u4,
                new_depth, max_depth, rr_start_depth):
    """Russian roulette + emission + BSDF sample + throughput update.

    Semantics: mod.rs:676-788 with the always-RR refraction branch, and the
    unconditional max-depth cut. Returns (acc', thr', d_new, alive_mask)."""
    u_rr, u1, u2, u_br = u4

    nd = _dot(nrm, d)
    to_ray = nd < 0.0
    nl = [torch.where(to_ray, nrm[k], -nrm[k]) for k in range(3)]

    # --- Russian roulette (mod.rs:676-683) ---
    max_refl = torch.maximum(color[0], torch.maximum(color[1], color[2]))
    rr_on = new_depth > rr_start_depth
    survive = (u_rr < max_refl) & (new_depth < max_depth)
    die_rr = rr_on & ~survive
    scale = torch.where(
        rr_on & survive, 1.0 / torch.clamp(max_refl, min=1e-30), 1.0)

    fm = found.to(F32)
    acc = [acc[k] + thr[k] * emis[k] * fm for k in range(3)]

    # --- diffuse: cosine-weighted around nl (mod.rs:687-715) ---
    r1 = _TWO_PI * u1
    r2s = torch.sqrt(u2)
    w = nl
    use_y = torch.abs(w[0]) > 0.1
    upy = use_y.to(F32)
    upx = (~use_y).to(F32)
    ux = upy * w[2]
    uy = -upx * w[2]
    uz = upx * w[1] - upy * w[0]
    ul = torch.rsqrt(torch.clamp(ux * ux + uy * uy + uz * uz, min=1e-30))
    ux, uy, uz = ux * ul, uy * ul, uz * ul
    vx = w[1] * uz - w[2] * uy
    vy = w[2] * ux - w[0] * uz
    vz = w[0] * uy - w[1] * ux
    cr1 = torch.cos(r1) * r2s
    sr1 = torch.sin(r1) * r2s
    wz = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    dd0 = ux * cr1 + vx * sr1 + w[0] * wz
    dd1 = uy * cr1 + vy * sr1 + w[1] * wz
    dd2 = uz * cr1 + vz * sr1 + w[2] * wz
    dl = torch.rsqrt(torch.clamp(dd0 * dd0 + dd1 * dd1 + dd2 * dd2, min=1e-30))
    d_diff = [dd0 * dl, dd1 * dl, dd2 * dl]

    # --- specular mirror ---
    d_spec = [d[k] - nrm[k] * 2.0 * nd for k in range(3)]

    # --- refract (mod.rs:729-788; always-RR branch, weights Re/P, Tr/(1-P)) ---
    into = to_ray
    nnt = torch.where(into, _INV_IOR, 1.5)
    ddn = _dot(nl, d)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    tsc = ddn * nnt + torch.sqrt(torch.clamp(cos2t, min=0.0))
    td = [d[k] * nnt - nl[k] * tsc for k in range(3)]
    tl = torch.rsqrt(torch.clamp(
        td[0] * td[0] + td[1] * td[1] + td[2] * td[2], min=1e-30))
    td = [x * tl for x in td]
    tdn = _dot(td, nrm)
    c_ = 1.0 - torch.where(into, -ddn, tdn)
    c2 = c_ * c_
    c5 = c_ * (c2 * c2)  # lax.integer_pow's square-and-multiply order
    re = float(_R0) + _ONE_MINUS_R0 * c5
    p_ = 0.25 + 0.5 * re
    lo = u_br < p_
    pick_refl = lo | tir
    d_refr = [torch.where(pick_refl, d_spec[k], td[k]) for k in range(3)]
    w_num = torch.where(lo, re, 1.0 - re)
    w_den = torch.where(lo, p_, 1.0 - p_)
    w_refr = torch.where(tir, 1.0, w_num / w_den)

    is_diff = rtype < 0.5
    is_spec = (rtype >= 0.5) & (rtype < 1.5)
    d_new = [
        torch.where(is_diff, d_diff[k], torch.where(is_spec, d_spec[k], d_refr[k]))
        for k in range(3)
    ]
    wgt = torch.where(is_diff | is_spec, 1.0, w_refr)

    thr_new = [thr[k] * color[k] * scale * wgt for k in range(3)]
    thr_max = torch.maximum(thr_new[0], torch.maximum(thr_new[1], thr_new[2]))
    # unconditional max-depth cut: every sample ends within max_depth steps
    die_depth = new_depth >= max_depth
    alive_new = found & ~die_rr & ~die_depth & (thr_max > 0.0)
    return acc, thr_new, d_new, alive_new


def make_raygen(cam, pix: torch.Tensor):
    """Camera sampling: integer pixel indices [N] → (raygen, lens_center3)
    where raygen(s_idx, u1, u2) → direction3 for the global sample indices
    s_idx [N] (the 2x2 subpixel grid cycles s_idx mod 4).

    cam: ``trace_v2.CameraConsts``. The pixel→(x, y) mapping (with the
    y flip) is integer arithmetic: the JAX kernel's float fix-ups give the
    same values for up to 2^24 pixels."""
    so, su, sv, lc, inv_w, inv_h = cam.floats()
    row = torch.div(pix, cam.width, rounding_mode="floor")
    x = (pix - row * cam.width).to(F32)
    y = (cam.height - 1 - row).to(F32)

    def raygen(s_idx, u1, u2):
        xsub = (s_idx & 1).to(F32)
        ysub = ((s_idx >> 1) & 1).to(F32)
        xf = tent_filter(u1)
        yf = tent_filter(u2)
        sx = (x + 0.5 * (0.5 + xsub + xf)) * inv_w - 0.5
        sy = (y + 0.5 * (0.5 + ysub + yf)) * inv_h - 0.5
        sp = [so[k] + su[k] * sx + sv[k] * sy for k in range(3)]
        dx, dy, dz = lc[0] - sp[0], lc[1] - sp[1], lc[2] - sp[2]
        dl = torch.rsqrt(dx * dx + dy * dy + dz * dz)
        return [dx * dl, dy * dl, dz * dl]

    return raygen, lc


def regen_loop(sample_base, pix, isect, draw, cam, quota, max_depth,
               rr_start_depth):
    """Plain regenerative loop: each lane owns pixel ``pix[i]`` and traces
    ``quota`` full samples, restarting the moment its path dies.

    isect(o, d, prev, alive) → (found, point, nrm, color, emis, rtype,
    new_prev); draw(sample_idx, depth) → six [N] uniforms in slot order
    (u_rr, u1, u2, u_br, raygen u1, raygen u2) for each lane's current
    sample and segment. Returns (acc3, segments [N] i64, done [N] i64).

    Segments count as in the JAX regen_loop: every live lane after
    regeneration adds one per step."""
    raygen, lc = make_raygen(cam, pix)
    n = pix.shape[0]
    dev = pix.device
    zero = torch.zeros(n, dtype=F32, device=dev)
    o = [zero + lc[0], zero + lc[1], zero + lc[2]]
    d = [zero, zero, zero + 1.0]
    thr = [zero, zero, zero]
    acc = [zero, zero, zero]
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)

    for _ in range(quota * max_depth):
        if not bool((done < quota).any()):
            break
        need = ~alive & (done < quota)
        depth = torch.where(need, 0, depth)
        s_global = sample_base + done
        u = draw(s_global, depth)
        d_new = raygen(s_global, u[4], u[5])
        o = [torch.where(need, lc[k], o[k]) for k in range(3)]
        d = [torch.where(need, d_new[k], d[k]) for k in range(3)]
        thr = [torch.where(need, 1.0, thr[k]) for k in range(3)]
        prev = torch.where(need, -1, prev)
        live = alive | need
        counts = counts + live

        found, point, nrm, color, emis, rtype, new_prev = isect(o, d, prev, live)
        new_depth = depth + 1
        acc, thr_new, d2, alive_new = shade_phase(
            d, nrm, color, emis, rtype, found, thr, acc, u[:4],
            new_depth, max_depth, rr_start_depth,
        )
        am = alive_new.to(F32)
        done = done + (live & ~alive_new)
        o = [torch.where(alive_new, point[k], o[k]) for k in range(3)]
        d = [torch.where(alive_new, d2[k], d[k]) for k in range(3)]
        thr = [thr_new[k] * am for k in range(3)]
        prev = torch.where(alive_new, new_prev, -1)
        depth = new_depth
        alive = alive_new
    return acc, counts, done
