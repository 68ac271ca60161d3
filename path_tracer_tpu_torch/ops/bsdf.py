"""BSDF sampling — diffuse / specular / refractive, as masked vector lanes.

Counterpart of ``path_tracer_tpu.ops.bsdf`` (parity with the reference's
``radiance`` branches, ``mod.rs:687-788``), in the JAX functions'
arithmetic:

- Diffuse: cosine-weighted hemisphere sample in a tangent frame whose first
  axis comes from (0,1,0) or (1,0,0) depending on |w.x| > 0.1.
- Specular: perfect mirror about the geometric normal.
- Refract: glass nc=1.0 / nt=1.5, total-internal-reflection fallback, Schlick
  Fresnel with R0 = ((nt-nc)/(nt+nc))^2, branch probability P = 0.25+0.5*Re.

For new_depth <= 2 the reference evaluates both refraction branches
(``mod.rs:760-786``); a wavefront lane follows one, chosen with
probability P and weighted Re/P, Tr/(1-P): the same expectation.

Per-ray values are [R,3] tensors and per-ray scalars [R,1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.141592653589793
NC = 1.0  # index of refraction, air
NT = 1.5  # index of refraction, glass


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(v):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                       min=1e-30))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


class BsdfSample(NamedTuple):
    direction: torch.Tensor  # [R,3] next ray direction
    weight: torch.Tensor  # [R,1] path weight multiplier (beyond material color)


def sample_diffuse(nl, u1, u2) -> torch.Tensor:
    """Cosine-weighted hemisphere around nl (mod.rs:687-715). u1,u2: [R,1]."""
    r1 = 2.0 * PI * u1
    r2 = u2
    r2s = torch.sqrt(r2)
    w = nl
    # u axis: (|w.x| > 0.1 ? (0,1,0) : (1,0,0)) × w, normalized
    use_y = torch.abs(w[:, 0:1]) > 0.1
    up = torch.where(
        use_y,
        torch.tensor([[0.0, 1.0, 0.0]], device=nl.device),
        torch.tensor([[1.0, 0.0, 0.0]], device=nl.device),
    )
    u = _normalize(_cross(up, w))
    v = _cross(w, u)
    d = u * (torch.cos(r1) * r2s) + v * (torch.sin(r1) * r2s) + w * torch.sqrt(1.0 - r2)
    return _normalize(d)


def reflect(d, n) -> torch.Tensor:
    """Mirror reflection d - n*2*(n·d). Sign-invariant in n."""
    return d - n * (2.0 * _dot(n, d))


def sample_refract(d, n, nl, u_branch):
    """Dielectric refraction lane (mod.rs:729-788).

    d: incoming direction [R,3]; n: geometric outward normal; nl: normal
    flipped toward the ray; u_branch: [R,1] uniform for the branch choice.
    Returns (direction, weight)."""
    refl = reflect(d, n)
    into = _dot(n, nl) > 0.0  # [R,1]
    nnt = torch.where(into, NC / NT, NT / NC)
    ddn = _dot(d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0

    # (into ? 1 : -1) * n == nl, so the transmitted direction uses nl:
    tdir = _normalize(d * nnt - nl * (ddn * nnt + torch.sqrt(torch.clamp(cos2t, min=0.0))))

    r0 = ((NT - NC) / (NT + NC)) ** 2
    c = 1.0 - torch.where(into, -ddn, _dot(tdir, n))
    c2 = c * c
    re = r0 + (1.0 - r0) * (c * (c2 * c2))  # c**5 in lax.integer_pow's order
    tr = 1.0 - re
    p = 0.25 + 0.5 * re

    pick_refl = u_branch < p
    direction = torch.where(pick_refl, refl, tdir)
    weight = torch.where(pick_refl, re / p, tr / (1.0 - p))

    direction = torch.where(tir, refl, direction)
    weight = torch.where(tir, 1.0, weight)
    return direction, weight


def sample_bsdf(d, n, nl, rtype, u) -> BsdfSample:
    """Evaluate all three BSDF lanes under masks and select by rtype.

    d [R,3]: incoming; n [R,3]: outward geometric normal; nl [R,3]: normal
    toward ray; rtype [R] int; u [R,3]: uniforms (u1, u2, u_branch)."""
    u1, u2, ub = u[:, 0:1], u[:, 1:2], u[:, 2:3]
    d_diff = sample_diffuse(nl, u1, u2)
    d_spec = _normalize(reflect(d, n))  # normalize: no-op mathematically
    d_refr, w_refr = sample_refract(d, n, nl, ub)

    rt = rtype[:, None]
    direction = torch.where(rt == 0, d_diff, torch.where(rt == 1, d_spec, d_refr))
    weight = torch.where(rt == 2, w_refr, 1.0)
    return BsdfSample(direction=direction, weight=weight)
