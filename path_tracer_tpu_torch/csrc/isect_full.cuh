// The full-scene closest-hit intersector over the table-driven scene, for one
// ray per thread: the single definition that K3 (portal_resolve.cu), K4
// (trace_regen_prim.cu) and K6/K7 (trace_stepped.cu) include, as the JAX
// package's K3 and K4 share trace_kernel.make_isect. Its plain torch version
// is path_tracer_tpu_torch/ops/kernels/trace_kernel.py isect_full_plain,
// which holds the semantics in its docstring; the operations here follow it
// in order.
//
// Where the rows live is a template parameter of the scan:
//  - GlobalRows: the KernelScene tables (spheres [S, 12], bounding spheres
//    [M, 4], triangle rows [T, 32], tile AABBs [C, 6]) in device memory,
//    read through the read-only cache (__ldg). K3, K4, K6 and K7 use it for
//    a scene whose compact table is too large for shared memory. Where a
//    group of lanes tests one tile's rows (K3's group split, K4's warp
//    queries), it reads them from KernelScene.hit_tiles instead, the
//    tiles' compact rows field by field (tile_group_rows below), so that a
//    load of one field of consecutive rows is one line;
//  - SharedRows: the compact hit-test rows (KernelScene.hit [T, 20]: the 19
//    floats the distance test reads) and the small tables, staged by the
//    kernel into shared memory (stage_scene). K3 and K6 use it: with K3's
//    lanes sorted by the tiles they enter, a warp's lanes read one row at a
//    time, a broadcast. Measured on the H100 (PERF.md; scripts/ablate_k3.py,
//    scripts/ablate_k6.py): the shared table cuts K3's time by a quarter on
//    sorted lanes and by a third on unsorted ones. K4 scans the same table
//    through scan_lane, scan_warp and isect_surface below, which split
//    isect_full at the winner and take a ray whose line enters a tile with
//    a whole warp; K7 through scan_lane, scan_group (a ray by a group of a
//    warp's lanes) and isect_surface.
// K4 alone reads a level of boxes above the tiles, in either row mode: one
// box for each run of TILE_GROUP consecutive tiles
// (KernelScene.tile_groups, through __ldg), which its filing
// (enters_a_tile_grouped) and its warp scan (scan_warp) test before the
// run's tiles, so that a ray slab-tests the tiles of the runs its line
// enters only. The boxes are unions of the tiles' in float32,
// exact, and (box - o) * inv is monotone under rounding: a line that
// enters a tile enters its run's box, no later. So a run the line misses,
// or enters no closer than the bound, holds no tile that the flat scan
// would test, and the grouped scans give the flat ones' results bit for
// bit.
// The shading fields of the winning row (normal, colour, emission, type,
// order, id) are read from the 32-float rows in device memory after the
// scan, for that row only.
//
// Per-lane culling: the always-tested base set first, then each Morton tile
// whose AABB the lane's ray enters closer than its best hit so far. The
// JAX kernel makes the same test for a block of lanes at once and runs a
// tile for all of them if any lane needs it; a tile the ray cannot enter
// closer holds no strictly closer hit, so the result per lane is the same.

#pragma once

#include "common.cuh"

namespace pt {

// KernelScene row layouts: ops/kernels/trace_kernel.py S_*, T_* and HIT_COLS
constexpr int SPH_F = 12;
constexpr int S_CENTER = 0, S_RAD2 = 3, S_COLOR = 4, S_EMIS = 7, S_RTYPE = 10,
              S_ORDER = 11;
constexpr int TRI_F = 32;
constexpr int T_N = 0, T_E1 = 3, T_E2 = 6, T_E2XA = 9, T_AXE1 = 12, T_NA = 15,
              T_NORMAL = 16, T_COLOR = 19, T_EMIS = 22, T_RTYPE = 25,
              T_ORDER = 26, T_QUAD = 27, T_PID = 28, T_GATE = 29;
constexpr int HIT_F = 20;  // T_N .. T_NA, then T_QUAD, T_PID, T_GATE, a pad
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
  const float* hit = nullptr;  // compact rows (SharedRows)
};

// The distance test's rows, and how every scan table is loaded
struct GlobalRows {
  static constexpr int F = TRI_F, N = T_N, E1 = T_E1, E2 = T_E2,
                       E2XA = T_E2XA, AXE1 = T_AXE1, NA = T_NA, QUAD = T_QUAD,
                       PID = T_PID, GATE = T_GATE;
  static __device__ __forceinline__ const float* rows(const FullScene& sc) {
    return sc.tri;
  }
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
};

struct SharedRows {
  static constexpr int F = HIT_F, N = 0, E1 = 3, E2 = 6, E2XA = 9, AXE1 = 12,
                       NA = 15, QUAD = 16, PID = 17, GATE = 18;
  static __device__ __forceinline__ const float* rows(const FullScene& sc) {
    return sc.hit;
  }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
};

// ---- staging SharedRows' tables into a block's dynamic shared memory ----
constexpr uint32_t BULK_PIECE = 32768;  // bytes a TMA bulk copy

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: arm the mbarrier and copy `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory with TMA bulk
// copies that complete on it
__device__ __forceinline__ void stage_bulk(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(bytes)
               : "memory");
  const char* s = static_cast<const char*>(src);
  const uint32_t d = smem_u32(dst);
  for (uint32_t off = 0; off < bytes; off += BULK_PIECE) {
    const uint32_t len = bytes - off < BULK_PIECE ? bytes - off : BULK_PIECE;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(d + off),
        "l"(s + off), "r"(len), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void wait_bulk(uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(b), "r"(0)
        : "memory");
}

// The IEEE square root and reciprocal as isect_full takes them; K4 and K7
// hand the row tests the exact fast paths of k1_scan.cuh (FastOps)
struct IeeeOps {
  static __device__ __forceinline__ float root(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float rcp(float x) { return 1.0f / x; }
};

struct Hit {
  bool found;
  float point[3], nrm[3], color[3], emis[3];
  float rtype;
  float new_prev;  // packed triangle id of the hit, -1 for a sphere or miss
};

// The reference renderer's sphere test (smallpt's, op = c - o first; BIG =
// miss; r2 <= 0 marks padding, whose far-away center overflows |op|^2).
// The JAX intersector expands |c - o|^2 into |c|^2 - 2 c.o + |o|^2, which
// cancels: a radius-0.2 sphere 13 units from the origin then misjudges a
// ray leaving its own surface by more than the 1e-4 root cutoff.
template <class R, class Ops = IeeeOps>
__device__ __forceinline__ float sphere_t(const float* c, float rad2,
                                          const float o[3], const float d[3]) {
  const float op0 = R::ld(c) - o[0], op1 = R::ld(c + 1) - o[1],
              op2 = R::ld(c + 2) - o[2];
  const float b = op0 * d[0] + op1 * d[1] + op2 * d[2];
  const float det = b * b - (op0 * op0 + op1 * op1 + op2 * op2) + rad2;
  const float sq = Ops::root(fmaxf(det, 0.0f));
  const float t_near = b - sq;
  const float t_far = b + sq;
  const float t = t_near >= EPS ? t_near : (t_far >= EPS ? t_far : BIG);
  return (det < 0.0f || rad2 <= 0.0f) ? BIG : t;
}

template <class R>
__device__ __forceinline__ float dot_row(const float* row, const float v[3]) {
  return R::ld(row) * v[0] + R::ld(row + 1) * v[1] + R::ld(row + 2) * v[2];
}

// Distance to triangle/quad row r (BIG = no valid hit)
template <class R, class Ops = IeeeOps>
__device__ __forceinline__ float tri_t(const float* r, const float o[3],
                                       const float d[3], const float m[3],
                                       float prevf, uint32_t gate_ok) {
  const float det = -dot_row<R>(r + R::N, d);
  const float udet = dot_row<R>(r + R::E2, m) - dot_row<R>(r + R::E2XA, d);
  const float vdet = -dot_row<R>(r + R::E1, m) - dot_row<R>(r + R::AXE1, d);
  const float tdet = dot_row<R>(r + R::N, o) - R::ld(r + R::NA);
  const bool dvalid = fabsf(det) >= EPS;
  const float inv = Ops::rcp(dvalid ? det : 1.0f);
  const float u = udet * inv;
  const float v = vdet * inv;
  const float t = tdet * inv;
  const float uv_hi = R::ld(r + R::QUAD) > 0.5f ? v : u + v;
  bool valid = dvalid && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
               uv_hi <= 1.0f && t > EPS && R::ld(r + R::PID) != prevf;
  const float gate = R::ld(r + R::GATE);
  if (gate != GATE_NONE)
    valid = valid && gate >= 0.0f &&
            ((gate_ok >> static_cast<int>(gate)) & 1u) != 0u;
  return valid ? t : BIG;
}

// Strictly-closer scan of rows [lo, hi)
template <class R, class Ops = IeeeOps>
__device__ __forceinline__ void tri_rows(const float* rows, int lo, int hi,
                                         const float o[3], const float d[3],
                                         const float m[3], float prevf,
                                         uint32_t gate_ok, float& d_t,
                                         int& r_t) {
  for (int r = lo; r < hi; ++r) {
    const float t = tri_t<R, Ops>(rows + r * R::F, o, d, m, prevf, gate_ok);
    if (t < d_t) {
      d_t = t;
      r_t = r;
    }
  }
}

// The slab test of a tile AABB as isect_full's cull makes it: whether the
// ray's line enters the box ahead of the origin, and its entry distance.
// K3 keys its sort with it and K4's scans use it; isect_full keeps its own
// copy inline, so that K6 and K7 compile as before this helper existed.
template <class R>
__device__ __forceinline__ bool tile_slab(const float* box, const float o[3],
                                          const float inv[3], float& t_en) {
  float t_ex = BIG;
  t_en = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float ta = (R::ld(box + k) - o[k]) * inv[k];
    const float tb = (R::ld(box + 3 + k) - o[k]) * inv[k];
    t_en = fmaxf(t_en, fminf(ta, tb));
    t_ex = fminf(t_ex, fmaxf(ta, tb));
  }
  return t_ex >= t_en && t_ex >= 0.0f;
}

__device__ __forceinline__ void inv_dir(const float d[3], float inv[3]) {
  for (int k = 0; k < 3; ++k)
    inv[k] = 1.0f / (fabsf(d[k]) < TINY ? TINY : d[k]);
}

// K3's and K6's sort key: the tiles (of the first KEY_TILES) whose AABB the
// ray's line enters (tile_slab without the distance cull), known before
// any triangle is tested; trace_kernel.py tile_entry_keys. 31 tiles, so
// that bit 31 of a live key is clear and the key SORT_PAD that pads a
// chunk's sort to a power of two sorts after every live key: with a 32nd
// bit a ray whose line enters 32 tiles had the pad's key, and the sort,
// which is not stable, could put a pad before it and drop its bounce
// (tests/test_torch_cuda.py test_cuda_sort_pad_drops_no_ray_on_a_strip_scene).
constexpr int KEY_TILES = 31;
constexpr uint32_t SORT_PAD = 0xffffffffu;

template <class R>
__device__ __forceinline__ uint32_t entry_key(const FullScene& sc,
                                              const float o[3],
                                              const float d[3]) {
  float inv[3];
  inv_dir(d, inv);
  uint32_t key = 0u;
  const int nt = sc.n_tiles < KEY_TILES ? sc.n_tiles : KEY_TILES;
  for (int c = 0; c < nt; ++c) {
    float t_en;
    if (tile_slab<R>(sc.tiles + c * TILE_F, o, inv, t_en)) key |= 1u << c;
  }
  return key;
}

// The scan keeps the best sphere (d_s, i_s) and the best triangle row (d_t,
// r_t) only; the surface of the winner is read after it: spheres through R,
// a triangle's shading fields from its 32-float row in device memory.
template <class R = GlobalRows>
__device__ __forceinline__ void isect_full(const FullScene& sc,
                                           const float o[3], const float d[3],
                                           float prevf, bool alive, Hit& h) {
  // spheres: first minimum in table order
  float d_s = BIG;
  int i_s = 0;
  for (int s = 0; s < sc.n_sph; ++s) {
    const float* row = sc.sph + s * SPH_F;
    const float t = sphere_t<R>(row + S_CENTER, R::ld(row + S_RAD2), o, d);
    if (t < d_s) {
      d_s = t;
      i_s = s;
    }
  }
  uint32_t gate_ok = 0u;
  for (int g = 0; g < sc.n_bnd; ++g) {
    const float* row = sc.bnd + g * 4;
    if (sphere_t<R>(row, R::ld(row + 3), o, d) < BIG) gate_ok |= 1u << g;
  }

  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float d_t = BIG;
  int r_t = 0;
  tri_rows<R>(R::rows(sc), 0, sc.n_tiles ? sc.tile_base : sc.n_tri, o, d, m,
              prevf, gate_ok, d_t, r_t);
  if (sc.n_tiles && alive) {
    float inv[3];
    for (int k = 0; k < 3; ++k)
      inv[k] = 1.0f / (fabsf(d[k]) < TINY ? TINY : d[k]);
    for (int c = 0; c < sc.n_tiles; ++c) {
      const float* box = sc.tiles + c * TILE_F;
      float t_en = 0.0f, t_ex = BIG;
      for (int k = 0; k < 3; ++k) {
        const float ta = (R::ld(box + k) - o[k]) * inv[k];
        const float tb = (R::ld(box + 3 + k) - o[k]) * inv[k];
        t_en = fmaxf(t_en, fminf(ta, tb));
        t_ex = fminf(t_ex, fmaxf(ta, tb));
      }
      const float bound = fminf(d_t, d_s);
      if (t_ex >= t_en && t_ex >= 0.0f && t_en < bound) {
        const int lo = sc.tile_base + c * TRI_TILE;
        tri_rows<R>(R::rows(sc), lo, lo + TRI_TILE, o, d, m, prevf, gate_ok,
                    d_t, r_t);
      }
    }
  }

  const float* srow = sc.sph + i_s * SPH_F;
  const float* trow = sc.tri + r_t * TRI_F;
  const bool sph_wins =
      d_s < d_t || (d_s == d_t && R::ld(srow + S_ORDER) < __ldg(trow + T_ORDER));
  const float t = sph_wins ? d_s : d_t;
  h.found = t < BIG && alive;
  for (int k = 0; k < 3; ++k) h.point[k] = o[k] + d[k] * t;
  if (sph_wins) {
    float sn[3];
    for (int k = 0; k < 3; ++k) sn[k] = h.point[k] - R::ld(srow + S_CENTER + k);
    const float sl =
        rsqrtf(fmaxf(sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2], TINY));
    for (int k = 0; k < 3; ++k) {
      h.nrm[k] = sn[k] * sl;
      h.color[k] = R::ld(srow + S_COLOR + k);
      h.emis[k] = R::ld(srow + S_EMIS + k);
    }
    h.rtype = R::ld(srow + S_RTYPE);
  } else {
    for (int k = 0; k < 3; ++k) {
      h.nrm[k] = __ldg(trow + T_NORMAL + k);
      h.color[k] = __ldg(trow + T_COLOR + k);
      h.emis[k] = __ldg(trow + T_EMIS + k);
    }
    h.rtype = __ldg(trow + T_RTYPE);
  }
  h.new_prev = (h.found && !sph_wins) ? __ldg(trow + T_PID) : -1.0f;
}

// ---- a tile's rows on GlobalRows, for a group of W lanes (K3's group
// split, portal_resolve.cu; K4's warp queries, W = 32) ----
// A group's W lanes test W consecutive rows of one tile at a time. In
// KernelScene.tri's rows (128 bytes each) one field of W rows lies in W
// lines, so a load of one field by a warp touched 32 sectors and a tile
// cost ~1,216 (K3's group split on mesh13k streamed them from L2 and was
// bound by them: 6.9 ms at W 8 against the one-lane trace's 6.8, PERF.md);
// KernelScene.hit_tiles holds the tiles' compact rows field by field
// ([C, HIT_F, TRI_TILE]: field f of row j of tile c at (c * HIT_F + f) *
// TRI_TILE + j), where one field of W rows is W consecutive floats.

// tri_t on a row of hit_tiles: the same operations in the same order
template <class Ops>
__device__ __forceinline__ float tile_tri_t(const float* r, const float o[3],
                                            const float d[3], const float m[3],
                                            float prevf, uint32_t gate_ok) {
  using S = SharedRows;  // the compact rows' field order
  const auto ld = [&](int f) { return __ldg(r + f * TRI_TILE); };
  const auto dot = [&](int f, const float v[3]) {
    return ld(f) * v[0] + ld(f + 1) * v[1] + ld(f + 2) * v[2];
  };
  const float det = -dot(S::N, d);
  const float udet = dot(S::E2, m) - dot(S::E2XA, d);
  const float vdet = -dot(S::E1, m) - dot(S::AXE1, d);
  const float tdet = dot(S::N, o) - ld(S::NA);
  const bool dvalid = fabsf(det) >= EPS;
  const float inv = Ops::rcp(dvalid ? det : 1.0f);
  const float u = udet * inv;
  const float v = vdet * inv;
  const float t = tdet * inv;
  const float uv_hi = ld(S::QUAD) > 0.5f ? v : u + v;
  bool valid = dvalid && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
               uv_hi <= 1.0f && t > EPS && ld(S::PID) != prevf;
  const float gate = ld(S::GATE);
  if (gate != GATE_NONE)
    valid = valid && gate >= 0.0f &&
            ((gate_ok >> static_cast<int>(gate)) & 1u) != 0u;
  return valid ? t : BIG;
}

// A tile's rows (`tile` its HIT_F x TRI_TILE block of hit_tiles, lo its
// first row in the full table) over a group of W lanes: lane g of a group
// tests rows g, g + W, .. (in order, strictly closer), reporting full-table
// rows; the group takes the closest (t, row), first row on a tie; where
// `take`, (d_t, r_t) take it where it is strictly closer. Every lane of
// the warp runs it.
template <int W, class Ops>
__device__ __forceinline__ void tile_group_rows(
    const float* tile, int lo, int g, const float o[3], const float d[3],
    const float m[3], float prevf, uint32_t gate_ok, bool take, float& d_t,
    int& r_t) {
  float bt = BIG;
  int br = 0x7fffffff;
  for (int j = g; j < TRI_TILE; j += W) {
    const float t = tile_tri_t<Ops>(tile + j, o, d, m, prevf, gate_ok);
    if (t < bt) {
      bt = t;
      br = lo + j;
    }
  }
  for (int off = W / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, bt, off);
    const int r2 = __shfl_xor_sync(0xffffffffu, br, off);
    if (t2 < bt || (t2 == bt && r2 < br)) {
      bt = t2;
      br = r2;
    }
  }
  if (take && bt < d_t) {
    d_t = bt;
    r_t = br;
  }
}

// ---- K4's scans (trace_regen_prim.cu): isect_full's tests of a live ray,
// in its order, up to the winner, with the row tests' root and reciprocal
// taken by Ops. Each returns the hit distance (BIG for a miss) and sets
// `code` to the winning triangle row, or to -1 - the sphere's index when a
// sphere wins; isect_surface reads the winner's surface. K4 traces a ray
// whose line enters a tile with a whole warp (scan_warp) and the others a
// lane each (scan_lane), so the scan and the surface are apart. ----

// The spheres (first minimum in table order) and the gates' bits
template <class R, class Ops>
__device__ __forceinline__ void scan_spheres(const FullScene& sc,
                                             const float o[3],
                                             const float d[3], float& d_s,
                                             int& i_s, uint32_t& gate_ok) {
  d_s = BIG;
  i_s = 0;
  for (int s = 0; s < sc.n_sph; ++s) {
    const float* row = sc.sph + s * SPH_F;
    const float t = sphere_t<R, Ops>(row + S_CENTER, R::ld(row + S_RAD2), o, d);
    if (t < d_s) {
      d_s = t;
      i_s = s;
    }
  }
  gate_ok = 0u;
  for (int g = 0; g < sc.n_bnd; ++g) {
    const float* row = sc.bnd + g * 4;
    if (sphere_t<R, Ops>(row, R::ld(row + 3), o, d) < BIG) gate_ok |= 1u << g;
  }
}

// The closer of the best sphere and the best row; an exact tie goes to the
// lower packed order
template <class R>
__device__ __forceinline__ float scan_winner(const FullScene& sc, float d_s,
                                             int i_s, float d_t, int r_t,
                                             int& code) {
  const bool sph_wins =
      d_s < d_t || (d_s == d_t && R::ld(sc.sph + i_s * SPH_F + S_ORDER) <
                                      __ldg(sc.tri + r_t * TRI_F + T_ORDER));
  code = sph_wins ? -1 - i_s : r_t;
  return sph_wins ? d_s : d_t;
}

// A ray whose line enters no tile, in one lane: the spheres and the base
// set (every row of a scene without tiles); isect_full's tile loop would
// test no tile
template <class R, class Ops>
__device__ __forceinline__ float scan_lane(const FullScene& sc,
                                           const float o[3], const float d[3],
                                           float prevf, int& code) {
  float d_s;
  int i_s;
  uint32_t gate_ok;
  scan_spheres<R, Ops>(sc, o, d, d_s, i_s, gate_ok);
  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float d_t = BIG;
  int r_t = 0;
  tri_rows<R, Ops>(R::rows(sc), 0, sc.n_tiles ? sc.tile_base : sc.n_tri, o,
                   d, m, prevf, gate_ok, d_t, r_t);
  return scan_winner<R>(sc, d_s, i_s, d_t, r_t, code);
}

// Rows [lo, hi) of one ray for a whole warp: lane l tests rows lo + l,
// lo + l + 32, .. (in order, strictly closer), the warp takes the closest
// (t, row), first row on a tie, and (d_t, r_t) take it where it is
// strictly closer: the sequential scan's result, in every lane.
template <class R, class Ops>
__device__ __forceinline__ void warp_rows(const float* rows, int lo, int hi,
                                          int lane, const float o[3],
                                          const float d[3], const float m[3],
                                          float prevf, uint32_t gate_ok,
                                          float& d_t, int& r_t) {
  float bt = BIG;
  int br = 0x7fffffff;
  for (int r = lo + lane; r < hi; r += 32) {
    const float t = tri_t<R, Ops>(rows + r * R::F, o, d, m, prevf, gate_ok);
    if (t < bt) {
      bt = t;
      br = r;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, bt, off);
    const int r2 = __shfl_xor_sync(0xffffffffu, br, off);
    if (t2 < bt || (t2 == bt && r2 < br)) {
      bt = t2;
      br = r2;
    }
  }
  if (bt < d_t) {
    d_t = bt;
    r_t = br;
  }
}

// Tile c's rows of one ray for a whole warp: lane l tests rows l and l + 32
// of the tile, the warp takes the closest, first row on a tie, and (d_t,
// r_t) take it where it is strictly closer. On GlobalRows (R::F == TRI_F)
// they are read from hit_tiles (tile_group_rows), on SharedRows from the
// staged compact rows (warp_rows): the same result, bit for bit.
template <class R, class Ops>
__device__ __forceinline__ void warp_tile(const FullScene& sc,
                                          const float* hit_tiles, int c,
                                          int lane, const float o[3],
                                          const float d[3], const float m[3],
                                          float prevf, uint32_t gate_ok,
                                          float& d_t, int& r_t) {
  const int lo = sc.tile_base + c * TRI_TILE;
  if constexpr (R::F == TRI_F)
    tile_group_rows<32, Ops>(
        hit_tiles + static_cast<size_t>(c) * HIT_F * TRI_TILE, lo, lane, o, d,
        m, prevf, gate_ok, true, d_t, r_t);
  else
    warp_rows<R, Ops>(R::rows(sc), lo, lo + TRI_TILE, lane, o, d, m, prevf,
                      gate_ok, d_t, r_t);
}

// Tiles c0 .. c0 + 31 of one ray for a whole warp: the slab tests one a
// lane, and the tiles the ray enters taken in order, each culled by the
// bound so far, as isect_full culls them, their rows split over the lanes
// (warp_tile). `tested` grows by the tiles whose rows the warp tested.
template <class R, class Ops>
__device__ __forceinline__ void warp_tiles(const FullScene& sc,
                                           const float* hit_tiles, int c0,
                                           int lane, const float o[3],
                                           const float d[3], const float m[3],
                                           const float inv[3], float prevf,
                                           uint32_t gate_ok, float d_s,
                                           float& d_t, int& r_t,
                                           unsigned& tested) {
  float t_en = 0.0f;
  const bool in = c0 + lane < sc.n_tiles &&
                  tile_slab<R>(sc.tiles + (c0 + lane) * TILE_F, o, inv, t_en);
  for (unsigned enter = __ballot_sync(0xffffffffu, in); enter;
       enter &= enter - 1) {
    const int k = __ffs(enter) - 1;
    if (__shfl_sync(0xffffffffu, t_en, k) < fminf(d_t, d_s)) {
      warp_tile<R, Ops>(sc, hit_tiles, c0 + k, lane, o, d, m, prevf, gate_ok,
                        d_t, r_t);
      ++tested;
    }
  }
}

// Tiles a run of K4's group level: a warp's width, so that a run's tiles
// are one slab test a lane (trace_kernel.py TILE_GROUP)
constexpr int TILE_GROUP = 32;

// One ray by a whole warp (every lane active, the same ray): the spheres
// in every lane, the base set's rows split over the lanes (warp_rows);
// then the group boxes (`groups`, one a run of TILE_GROUP tiles), 32 at a
// time, one a lane: the runs whose box the ray's line enters are taken in
// order, and a run's tiles (warp_tiles) are tested only where its box's
// entry is closer than the bound so far (`opened` grows by those runs).
// On GlobalRows the tiles' rows come from hit_tiles (NULL on SharedRows).
// The same result as isect_full, bit for bit. `tested` grows by the tiles
// whose rows the warp tested (in every lane).
template <class R, class Ops>
__device__ __forceinline__ float scan_warp(const FullScene& sc,
                                           const float* groups,
                                           const float* hit_tiles,
                                           const float o[3], const float d[3],
                                           float prevf, int lane, int& code,
                                           unsigned& tested,
                                           unsigned& opened) {
  float d_s;
  int i_s;
  uint32_t gate_ok;
  scan_spheres<R, Ops>(sc, o, d, d_s, i_s, gate_ok);
  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float d_t = BIG;
  int r_t = 0;
  warp_rows<R, Ops>(R::rows(sc), 0, sc.n_tiles ? sc.tile_base : sc.n_tri,
                    lane, o, d, m, prevf, gate_ok, d_t, r_t);
  float inv[3];
  inv_dir(d, inv);
  const int n_groups = (sc.n_tiles + TILE_GROUP - 1) / TILE_GROUP;
  for (int g0 = 0; g0 < n_groups; g0 += 32) {
    float t_en = 0.0f;
    const bool in =
        g0 + lane < n_groups &&
        tile_slab<GlobalRows>(groups + (g0 + lane) * TILE_F, o, inv, t_en);
    for (unsigned enter = __ballot_sync(0xffffffffu, in); enter;
         enter &= enter - 1) {
      const int k = __ffs(enter) - 1;
      if (__shfl_sync(0xffffffffu, t_en, k) < fminf(d_t, d_s)) {
        warp_tiles<R, Ops>(sc, hit_tiles, (g0 + k) * TILE_GROUP, lane, o, d,
                           m, inv, prevf, gate_ok, d_s, d_t, r_t, tested);
        ++opened;
      }
    }
  }
  return scan_winner<R>(sc, d_s, i_s, d_t, r_t, code);
}

// ---- K7's scan (trace_stepped.cu): one ray for each group of W lanes of
// a warp (W a power of two, 32 / W rays a warp) ----

// Rows [lo, hi) of each group's ray over the W lanes of the group: lane g
// of a group tests rows lo + g, lo + g + W, .. (in order, strictly closer);
// the group takes the closest (t, row), first row on a tie; where `take`,
// (d_t, r_t) take it where it is strictly closer. Every lane of the warp
// runs it.
template <int W, class R, class Ops>
__device__ __forceinline__ void group_rows(const float* rows, int lo, int hi,
                                           int g, const float o[3],
                                           const float d[3], const float m[3],
                                           float prevf, uint32_t gate_ok,
                                           bool take, float& d_t, int& r_t) {
  float bt = BIG;
  int br = 0x7fffffff;
  for (int r = lo + g; r < hi; r += W) {
    const float t = tri_t<R, Ops>(rows + r * R::F, o, d, m, prevf, gate_ok);
    if (t < bt) {
      bt = t;
      br = r;
    }
  }
  for (int off = W / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, bt, off);
    const int r2 = __shfl_xor_sync(0xffffffffu, br, off);
    if (t2 < bt || (t2 == bt && r2 < br)) {
      bt = t2;
      br = r2;
    }
  }
  if (take && bt < d_t) {
    d_t = bt;
    r_t = br;
  }
}

// Each group's ray (has: the group holds one; every lane of the warp runs
// it): the spheres in every lane, the base set's rows split over the
// group's lanes; the slab tests of W tiles at a time, one a lane; the warp
// walks the union of the tiles its groups' rays enter, in order, and a
// group tests a tile's rows where its ray enters it closer than its best
// hit so far, as isect_full culls. With W 32 it is scan_warp. The same
// result as isect_full, bit for bit.
template <int W, class R, class Ops>
__device__ __forceinline__ float scan_group(const FullScene& sc,
                                            const float o[3],
                                            const float d[3], float prevf,
                                            bool has, int lane, int& code) {
  const int g = lane & (W - 1), first = lane & ~(W - 1);
  float d_s;
  int i_s;
  uint32_t gate_ok;
  scan_spheres<R, Ops>(sc, o, d, d_s, i_s, gate_ok);
  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float d_t = BIG;
  int r_t = 0;
  group_rows<W, R, Ops>(R::rows(sc), 0, sc.n_tiles ? sc.tile_base : sc.n_tri,
                        g, o, d, m, prevf, gate_ok, true, d_t, r_t);
  float inv[3];
  inv_dir(d, inv);
  for (int c0 = 0; c0 < sc.n_tiles; c0 += W) {
    float t_en = 0.0f;
    const bool in =
        has && c0 + g < sc.n_tiles &&
        tile_slab<R>(sc.tiles + (c0 + g) * TILE_F, o, inv, t_en);
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    unsigned any = ball;  // tile c0 + k is bit k: entered by some group
    if constexpr (W < 32)
      for (int s = W; s < 32; s <<= 1) any |= any >> s;
    if constexpr (W < 32) any &= (1u << W) - 1u;
    for (; any; any &= any - 1) {
      const int k = __ffs(any) - 1;
      const float te = __shfl_sync(0xffffffffu, t_en, first + k);
      const bool mine = ((ball >> (first + k)) & 1u) && te < fminf(d_t, d_s);
      if (__any_sync(0xffffffffu, mine)) {
        const int lo = sc.tile_base + (c0 + k) * TRI_TILE;
        group_rows<W, R, Ops>(R::rows(sc), lo, lo + TRI_TILE, g, o, d, m,
                              prevf, gate_ok, mine, d_t, r_t);
      }
    }
  }
  return scan_winner<R>(sc, d_s, i_s, d_t, r_t, code);
}

// Whether the ray's line enters a tile's AABB (tile_slab, as the scans
// test it): where it enters none, isect_full tests the spheres and the
// base set only
template <class R>
__device__ __forceinline__ bool enters_a_tile(const FullScene& sc,
                                              const float o[3],
                                              const float d[3]) {
  float inv[3];
  inv_dir(d, inv);
  for (int c = 0; c < sc.n_tiles; ++c) {
    float t_en;
    if (tile_slab<R>(sc.tiles + c * TILE_F, o, inv, t_en)) return true;
  }
  return false;
}

// enters_a_tile over K4's group level: a run's tiles are tested only
// where the line enters the run's box (`groups`, one a run of TILE_GROUP
// tiles), which it does wherever it enters one of them; the same answer
template <class R>
__device__ __forceinline__ bool enters_a_tile_grouped(const FullScene& sc,
                                                      const float* groups,
                                                      const float o[3],
                                                      const float d[3]) {
  float inv[3];
  inv_dir(d, inv);
  for (int c0 = 0; c0 < sc.n_tiles; c0 += TILE_GROUP) {
    float t_en;
    if (!tile_slab<GlobalRows>(groups + (c0 / TILE_GROUP) * TILE_F, o, inv,
                               t_en))
      continue;
    const int hi =
        c0 + TILE_GROUP < sc.n_tiles ? c0 + TILE_GROUP : sc.n_tiles;
    for (int c = c0; c < hi; ++c)
      if (tile_slab<R>(sc.tiles + c * TILE_F, o, inv, t_en)) return true;
  }
  return false;
}

// The surface of a K4 scan's winner as isect_full reads it (a live ray)
template <class R>
__device__ __forceinline__ void isect_surface(const FullScene& sc,
                                              const float o[3],
                                              const float d[3], float t,
                                              int code, Hit& h) {
  h.found = t < BIG;
  for (int k = 0; k < 3; ++k) h.point[k] = o[k] + d[k] * t;
  if (code < 0) {
    const float* srow = sc.sph + (-1 - code) * SPH_F;
    float sn[3];
    for (int k = 0; k < 3; ++k) sn[k] = h.point[k] - R::ld(srow + S_CENTER + k);
    const float sl =
        rsqrtf(fmaxf(sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2], TINY));
    for (int k = 0; k < 3; ++k) {
      h.nrm[k] = sn[k] * sl;
      h.color[k] = R::ld(srow + S_COLOR + k);
      h.emis[k] = R::ld(srow + S_EMIS + k);
    }
    h.rtype = R::ld(srow + S_RTYPE);
    h.new_prev = -1.0f;
  } else {
    const float* trow = sc.tri + code * TRI_F;
    for (int k = 0; k < 3; ++k) {
      h.nrm[k] = __ldg(trow + T_NORMAL + k);
      h.color[k] = __ldg(trow + T_COLOR + k);
      h.emis[k] = __ldg(trow + T_EMIS + k);
    }
    h.rtype = __ldg(trow + T_RTYPE);
    h.new_prev = h.found ? __ldg(trow + T_PID) : -1.0f;
  }
}

// Where SharedRows' tables sit in a block's dynamic shared memory (bytes
// from its start): the compact rows, spheres, bounding spheres and tile
// AABBs, each 16-byte aligned. K6 stages exactly these; K3 puts its chunk's
// arrays after the same four.
struct SceneLayout {
  int hit, sph, bnd, tiles, bytes;
};

__host__ __device__ inline SceneLayout scene_layout(int n_tri, int n_sph,
                                                    int n_bnd, int n_tiles) {
  SceneLayout l;
  l.hit = 0;
  l.sph = l.hit + align16(n_tri * HIT_F * 4);
  l.bnd = l.sph + align16(n_sph * SPH_F * 4);
  l.tiles = l.bnd + align16(n_bnd * 4 * 4);
  l.bytes = l.tiles + align16(n_tiles * TILE_F * 4);
  return l;
}

// Every thread of the block: start the compact table's TMA copy (thread 0;
// completes on `bar`), copy the small tables, and return the scene that
// reads them from shared memory. The caller syncs the block before any
// thread waits on `bar`, and waits on it before its first scan.
__device__ __forceinline__ FullScene stage_scene(const FullScene& g,
                                                 unsigned char* smem,
                                                 uint64_t* bar) {
  const SceneLayout lay = scene_layout(g.n_tri, g.n_sph, g.n_bnd, g.n_tiles);
  FullScene sc = g;
  float* hit = reinterpret_cast<float*>(smem + lay.hit);
  float* sph = reinterpret_cast<float*>(smem + lay.sph);
  float* bnd = reinterpret_cast<float*>(smem + lay.bnd);
  float* tiles = reinterpret_cast<float*>(smem + lay.tiles);
  if (threadIdx.x == 0)
    stage_bulk(hit, g.hit, static_cast<uint32_t>(g.n_tri * HIT_F * 4), bar);
  for (int i = threadIdx.x; i < g.n_sph * SPH_F; i += blockDim.x)
    sph[i] = g.sph[i];
  for (int i = threadIdx.x; i < g.n_bnd * 4; i += blockDim.x) bnd[i] = g.bnd[i];
  for (int i = threadIdx.x; i < g.n_tiles * TILE_F; i += blockDim.x)
    tiles[i] = g.tiles[i];
  sc.hit = hit;
  sc.sph = sph;
  sc.bnd = bnd;
  sc.tiles = tiles;
  return sc;
}

// Launch-time checks shared by the kernels that take a FullScene
inline bool full_scene_ok(const FullScene& sc) {
  return sc.n_sph > 0 && sc.n_tri > 0 && sc.n_bnd >= 0 &&
         sc.n_bnd <= MAX_BND && sc.n_tiles >= 0 && sc.tile_base >= 0 &&
         sc.tile_base + sc.n_tiles * TRI_TILE <= sc.n_tri;
}

}  // namespace pt
