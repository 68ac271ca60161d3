// The full-scene closest-hit intersector over the table-driven scene, for one
// ray per thread: the single definition that K3 (portal_resolve.cu) and K4
// (trace_regen_prim.cu) include, as the JAX package's K3 and K4 share
// trace_kernel.make_isect. Its plain torch version is
// path_tracer_tpu_torch/ops/kernels/trace_kernel.py isect_full_plain, which
// holds the semantics in its docstring; the operations here follow it in
// order.
//
// The tables (KernelScene: spheres [S, 12], bounding spheres [M, 4],
// triangle rows [T, 32], tile AABBs [C, 6]) stay in device memory and are
// read through the read-only cache (__ldg). The mesh scene's 840 triangle
// rows are 107 KB: they would fit in shared memory, but a resident block
// would then pin most of an SM's 227 KB for a kernel whose threads walk
// different tiles, and every tile a warp reads is shared by the warp's
// lanes through L1 anyway. Moving them to shared memory is a measured
// decision for a later change.
//
// Per-lane culling: the always-tested base set first, then each Morton tile
// whose AABB the lane's ray enters closer than its best hit so far. The
// JAX kernel makes the same test for a block of lanes at once and runs a
// tile for all of them if any lane needs it; a tile the ray cannot enter
// closer holds no strictly closer hit, so the result per lane is the same.

#pragma once

#include "common.cuh"

namespace pt {

// KernelScene row layouts: ops/kernels/trace_kernel.py S_* and T_*
constexpr int SPH_F = 12;
constexpr int S_CENTER = 0, S_RAD2 = 3, S_COLOR = 4, S_EMIS = 7, S_RTYPE = 10,
              S_ORDER = 11;
constexpr int TRI_F = 32;
constexpr int T_N = 0, T_E1 = 3, T_E2 = 6, T_E2XA = 9, T_AXE1 = 12, T_NA = 15,
              T_NORMAL = 16, T_COLOR = 19, T_EMIS = 22, T_RTYPE = 25,
              T_ORDER = 26, T_QUAD = 27, T_PID = 28, T_GATE = 29;
constexpr int TILE_F = 6;
constexpr int TRI_TILE = 64;
constexpr int MAX_BND = 32;  // bounding spheres, one bit each
constexpr float GATE_NONE = -1.0f;

struct FullScene {
  const float* sph;
  int n_sph;
  const float* bnd;
  int n_bnd;
  const float* tri;
  int n_tri;
  const float* tiles;
  int n_tiles;
  int tile_base;
};

struct Hit {
  bool found;
  float point[3], nrm[3], color[3], emis[3];
  float rtype;
  float new_prev;  // packed triangle id of the hit, -1 for a sphere or miss
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// The JAX intersector's expanded sphere test (BIG = miss; r2 <= 0 marks
// padding, whose far-away center makes b^2 - |op|^2 cancel)
__device__ __forceinline__ float sphere_t(const float* c, float rad2,
                                          const float o[3], const float d[3]) {
  const float c0 = ld(c), c1 = ld(c + 1), c2 = ld(c + 2);
  const float cd = 0.0f + c0 * d[0] + c1 * d[1] + c2 * d[2];
  const float co = 0.0f + c0 * o[0] + c1 * o[1] + c2 * o[2];
  const float cc = 0.0f + c0 * c0 + c1 * c1 + c2 * c2;
  const float od = 0.0f + o[0] * d[0] + o[1] * d[1] + o[2] * d[2];
  const float oo = 0.0f + o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  const float b = cd - od;
  const float det = b * b - (cc - 2.0f * co + oo) + rad2;
  const float sq = sqrtf(fmaxf(det, 0.0f));
  const float t_near = b - sq;
  const float t_far = b + sq;
  const float t = t_near >= EPS ? t_near : (t_far >= EPS ? t_far : BIG);
  return (det < 0.0f || rad2 <= 0.0f) ? BIG : t;
}

__device__ __forceinline__ float dot_row(const float* row, const float v[3]) {
  return ld(row) * v[0] + ld(row + 1) * v[1] + ld(row + 2) * v[2];
}

// Distance to triangle/quad row r (BIG = no valid hit)
__device__ __forceinline__ float tri_t(const float* r, const float o[3],
                                       const float d[3], const float m[3],
                                       float prevf, uint32_t gate_ok) {
  const float det = -dot_row(r + T_N, d);
  const float udet = dot_row(r + T_E2, m) - dot_row(r + T_E2XA, d);
  const float vdet = -dot_row(r + T_E1, m) - dot_row(r + T_AXE1, d);
  const float tdet = dot_row(r + T_N, o) - ld(r + T_NA);
  const bool dvalid = fabsf(det) >= EPS;
  const float inv = 1.0f / (dvalid ? det : 1.0f);
  const float u = udet * inv;
  const float v = vdet * inv;
  const float t = tdet * inv;
  const float uv_hi = ld(r + T_QUAD) > 0.5f ? v : u + v;
  bool valid = dvalid && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
               uv_hi <= 1.0f && t > EPS && ld(r + T_PID) != prevf;
  const float gate = ld(r + T_GATE);
  if (gate != GATE_NONE)
    valid = valid && gate >= 0.0f &&
            ((gate_ok >> static_cast<int>(gate)) & 1u) != 0u;
  return valid ? t : BIG;
}

// Strictly-closer scan of rows [lo, hi)
__device__ __forceinline__ void tri_rows(const float* tri, int lo, int hi,
                                         const float o[3], const float d[3],
                                         const float m[3], float prevf,
                                         uint32_t gate_ok, float& d_t,
                                         int& r_t) {
  for (int r = lo; r < hi; ++r) {
    const float t = tri_t(tri + r * TRI_F, o, d, m, prevf, gate_ok);
    if (t < d_t) {
      d_t = t;
      r_t = r;
    }
  }
}

__device__ __forceinline__ void isect_full(const FullScene& sc,
                                           const float o[3], const float d[3],
                                           float prevf, bool alive, Hit& h) {
  // spheres: first minimum in table order
  float d_s = BIG;
  int i_s = 0;
  for (int s = 0; s < sc.n_sph; ++s) {
    const float* row = sc.sph + s * SPH_F;
    const float t = sphere_t(row + S_CENTER, ld(row + S_RAD2), o, d);
    if (t < d_s) {
      d_s = t;
      i_s = s;
    }
  }
  uint32_t gate_ok = 0u;
  for (int g = 0; g < sc.n_bnd; ++g) {
    const float* row = sc.bnd + g * 4;
    if (sphere_t(row, ld(row + 3), o, d) < BIG) gate_ok |= 1u << g;
  }

  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float d_t = BIG;
  int r_t = 0;
  tri_rows(sc.tri, 0, sc.n_tiles ? sc.tile_base : sc.n_tri, o, d, m, prevf,
           gate_ok, d_t, r_t);
  if (sc.n_tiles && alive) {
    float inv[3];
    for (int k = 0; k < 3; ++k)
      inv[k] = 1.0f / (fabsf(d[k]) < TINY ? TINY : d[k]);
    for (int c = 0; c < sc.n_tiles; ++c) {
      const float* box = sc.tiles + c * TILE_F;
      float t_en = 0.0f, t_ex = BIG;
      for (int k = 0; k < 3; ++k) {
        const float ta = (ld(box + k) - o[k]) * inv[k];
        const float tb = (ld(box + 3 + k) - o[k]) * inv[k];
        t_en = fmaxf(t_en, fminf(ta, tb));
        t_ex = fminf(t_ex, fmaxf(ta, tb));
      }
      const float bound = fminf(d_t, d_s);
      if (t_ex >= t_en && t_ex >= 0.0f && t_en < bound) {
        const int lo = sc.tile_base + c * TRI_TILE;
        tri_rows(sc.tri, lo, lo + TRI_TILE, o, d, m, prevf, gate_ok, d_t, r_t);
      }
    }
  }

  const float* srow = sc.sph + i_s * SPH_F;
  const float* trow = sc.tri + r_t * TRI_F;
  const bool sph_wins =
      d_s < d_t || (d_s == d_t && ld(srow + S_ORDER) < ld(trow + T_ORDER));
  const float t = sph_wins ? d_s : d_t;
  h.found = t < BIG && alive;
  for (int k = 0; k < 3; ++k) h.point[k] = o[k] + d[k] * t;
  if (sph_wins) {
    float sn[3];
    for (int k = 0; k < 3; ++k) sn[k] = h.point[k] - ld(srow + S_CENTER + k);
    const float sl =
        rsqrtf(fmaxf(sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2], TINY));
    for (int k = 0; k < 3; ++k) {
      h.nrm[k] = sn[k] * sl;
      h.color[k] = ld(srow + S_COLOR + k);
      h.emis[k] = ld(srow + S_EMIS + k);
    }
    h.rtype = ld(srow + S_RTYPE);
  } else {
    for (int k = 0; k < 3; ++k) {
      h.nrm[k] = ld(trow + T_NORMAL + k);
      h.color[k] = ld(trow + T_COLOR + k);
      h.emis[k] = ld(trow + T_EMIS + k);
    }
    h.rtype = ld(trow + T_RTYPE);
  }
  h.new_prev = (h.found && !sph_wins) ? ld(trow + T_PID) : -1.0f;
}

// Launch-time checks shared by the kernels that take a FullScene
inline bool full_scene_ok(const FullScene& sc) {
  return sc.n_sph > 0 && sc.n_tri > 0 && sc.n_bnd >= 0 &&
         sc.n_bnd <= MAX_BND && sc.n_tiles >= 0 && sc.tile_base >= 0 &&
         sc.tile_base + sc.n_tiles * TRI_TILE <= sc.n_tri;
}

}  // namespace pt
