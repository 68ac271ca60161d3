// K3: the portal scheduler's pool resolve for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas/portal.py:
// trace_pallas_resolve_pool (kernel body _make_kernel_resolve_pool). The
// plain torch version of this file is path_tracer_tpu_torch/ops/kernels/
// portal.py:trace_resolve_pool_plain.
//
// What it computes: one full-scene bounce (isect_full.cuh, the intersector
// K4, K6 and K7 use too) for the active path and the frozen paths of the
// first parts-1 park buffers of each pool column, with the bookkeeping in
// the kernel: part 0 bumps done where its path ended; part j >= 1 bounces
// only a frozen buffer (BUF_STATE 1) with a zero acc, adds that acc to the
// slot's acc, bumps done where the path ended and sets BUF_STATE to 2
// (ready) or 0. Empty and ready buffers pass through; a dead active path is
// not traced, its scratch is cleaned (thr 0, prev -1).
//
// What bounds it on this card: FP32 work in the triangle distance tests
// (no matrix product, so neither wgmma nor the tensor cores apply; the TPU
// kernel's one-hot MXU table read stays unported) and the divergence of a
// warp whose lanes need different tiles: a warp executes the union of its
// lanes' tiles. One thread per column, walking the parts in turn, had 68%
// of its lane slots on a live bounce and 17% of the triangle rows it
// executed needed by a lane (scripts/k3_coherence.py, PERF.md).
//
// Design: a persistent grid (SMs x resident blocks: one block of 1,024
// threads an SM, 64 registers a thread), each block looping over chunks of
// `window` (1,024) pool columns. Per chunk:
//  1. load: one thread per column reads the live flags coalesced (part 0:
//     ROW_ALIVE > 0; part j: BUF_STATE == 1); a warp scan and a block scan
//     pack the live (column, part) items into shared memory in column order,
//     each with its sort key, the tiles its ray's line enters (the slab test
//     without the distance cull, the first KEY_TILES (31) tiles: every tile
//     of a scene of up to 31 tiles, a prefix beyond). The mask comes within 3 points of a key of the tiles a ray
//     really tests in the share of useful rows; a key of the nearest
//     entered tile does worse (scripts/k3_coherence.py, PERF.md);
//  2. sort: a bitonic sort of the chunk's items by key in shared memory, so
//     the lanes of a warp enter the same tiles; warp 0 then orders the
//     groups of 32 sorted items by how many tiles they enter, most first;
//  3. trace: each warp takes the next group until none is left, gathers
//     its items' state (the chunk's columns were just read, so from L2),
//     bounces them and writes their parts' state rows; the acc and whether
//     the path lives go to the item's slot in shared memory. The per-lane
//     cull is exactly isect_full's, so a lane's result does not depend on
//     its warp. In a scene of more tiles than the key holds (the build
//     resolve_pool_kernel<GlobalRows, true>, chosen from n_tiles at
//     launch), the key cannot group a warp's lanes by the tiles past it,
//     and a warp of 32 sorted items ran the union of their tiles (57.5
//     tiles against 5.2 an item on mesh13k's 199, scripts/k3_coherence.py);
//     there each item whose line enters a tile is traced by K3_GROUP (32)
//     lanes over a tile-major copy of the compact rows (scan_group_tiled),
//     the rest one a lane (scan_lane): trace_split below;
//  4. columns: one thread per column adds the parts' acc in part order 0,
//     1, 2, 3, bumps done, and writes every row that no item wrote, once.
// The compact hit-test table (KernelScene.hit, [T, 20], 67 KB for mesh), the
// spheres, bounding spheres and tile AABBs are staged into dynamic shared
// memory once per block, the table with 1-D TMA bulk copies completing on
// an mbarrier that the block first waits on before its first trace, so the
// copy overlaps the first chunk's load and sort. A scene whose tables do not
// fit beside the chunk's arrays in a block's shared memory (a compact table
// above ~150 KB on an H100) reads its rows through the read-only path
// instead (GlobalRows, chosen in pt_resolve_pool_config from the scene's
// size and the card's limit, not on failure); a launch the card refuses
// is reported, never retried another way. The chunk's loads are not
// overlapped with the previous chunk's trace: one block holds the SM.
//
// Random numbers: the counter generator keyed by (seed, pixel, the part's
// own sample row, depth, slot), or injected uniforms[4, parts*n] in the
// JAX package's part-major layout, indexed by (part, column). Built with
// --fmad=false it equals the plain version bit for bit.

#include "isect_full.cuh"

using namespace pt;

namespace {

// pool rows: ops/kernels/portal.py
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13, ROW_DEPTH = 14, V2_ROW_DONE = 15, V2_ROW_PIX = 16,
              V2_ROWS = 18, V3_BUF_BASE = 19, BUF_O = 0, BUF_D = 3,
              BUF_THR = 6, BUF_PREV = 9, BUF_DEPTH = 10, BUF_STATE = 11,
              BUF_ROWS = 12, MAX_PARK_K = 3;

// The design's choices, fixed at build time; scripts/ablate_k3.py builds
// the kernel with others (-D...) to time each part
#ifndef K3_THREADS
#define K3_THREADS 1024  // threads a block
#endif
#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 1  // resident blocks an SM the registers must allow
#endif
#ifndef K3_WINDOW
#define K3_WINDOW 1024  // pool columns a chunk (a power of two, 32 .. 4096)
#endif
#ifndef K3_SORT
#define K3_SORT 1  // 0: trace each chunk's items in column order
#endif
#ifndef K3_GROUP_ORDER
#define K3_GROUP_ORDER 1  // 1: the one-lane trace's warps take the groups with
                          // most key tiles first
#endif
#ifndef K3_SHARED_TABLE
#define K3_SHARED_TABLE 1  // 0: every scene reads its rows from device memory
#endif
#ifndef K3_GROUP
#define K3_GROUP 32  // lanes that trace an item whose line enters a tile,
                     // in a scene of more tiles than the key holds
#endif
constexpr int WARPS = K3_THREADS / 32;
constexpr int MAX_PARTS = MAX_PARK_K + 1;  // an item is (part << 14) | column
constexpr int MAX_WINDOW = 4096;  // columns a chunk (14 bits of an item)
static_assert(K3_WINDOW >= 32 && K3_WINDOW <= MAX_WINDOW &&
                  (K3_WINDOW & (K3_WINDOW - 1)) == 0,
              "K3_WINDOW: a power of two, 32 .. 4096");
static_assert(K3_THREADS % 32 == 0 && K3_THREADS <= 1024, "K3_THREADS");
static_assert(K3_GROUP == 4 || K3_GROUP == 8 || K3_GROUP == 16 ||
                  K3_GROUP == 32,
              "K3_GROUP: 4, 8, 16 or 32 lanes an item");
constexpr int SLOTS = K3_WINDOW * MAX_PARTS;
constexpr int PER = 32 / K3_GROUP;  // tile queries a warp takes at a time
constexpr int ROUNDS = (SLOTS + K3_THREADS - 1) / K3_THREADS;

// Dynamic shared memory of a block, in bytes from its start. For each of
// the chunk's window * MAX_PARTS item slots: a key and an item, by packed
// position; the acc and whether the path lives, by slot (part-major: part *
// window + column in chunk). 19 bytes a slot; with the mesh table and 1,024
// columns a chunk, 147 KB: one block of 1,024 threads an SM.
struct Layout {
  int hit, sph, bnd, tiles, keys, acc, vals, lives, live, bytes;
};

__host__ __device__ inline Layout layout(int n_tri, int n_sph, int n_bnd,
                                         int n_tiles, bool shared_table) {
  constexpr int window = K3_WINDOW;
  Layout l;
  int at = 0;
  l.hit = at;
  if (shared_table) at += align16(n_tri * HIT_F * 4);
  l.sph = at;
  if (shared_table) at += align16(n_sph * SPH_F * 4);
  l.bnd = at;
  if (shared_table) at += align16(n_bnd * 4 * 4);
  l.tiles = at;
  if (shared_table) at += align16(n_tiles * TILE_F * 4);
  const int slots = window * MAX_PARTS;
  l.keys = at;
  at += slots * 4;
  l.acc = at;
  at += slots * 12;
  l.vals = at;
  at += slots * 2;
  l.lives = at;
  at += slots;
  l.live = at;
  at += align16(window);
  l.bytes = at;
  return l;
}

// First row of a part's state: the active path's rows, or buffer j-1's
__device__ __forceinline__ int part_base(int part) {
  return part == 0 ? ROW_O : V3_BUF_BASE + (part - 1) * BUF_ROWS + BUF_O;
}
// Offsets from part_base: o, d, thr are at 0, 3, 6 in both layouts
__device__ __forceinline__ int prev_row(int part) {
  return part == 0 ? ROW_PREV : part_base(part) + BUF_PREV;
}
__device__ __forceinline__ int depth_row(int part) {
  return part == 0 ? ROW_DEPTH : part_base(part) + BUF_DEPTH;
}

// One bounce of a live path. Returns whether it lives on; o, d, thr, acc,
// prev and depth are updated in place. isect(o, d, prev, h) gives the
// closest hit as isect_full gives it for a live path.
template <class Isect>
__device__ __forceinline__ bool bounce(Isect isect, float o[3], float d[3],
                                       float thr[3], float acc[3],
                                       float& prev, float& depth,
                                       const float u[4], int max_depth,
                                       int rr_start_depth) {
  Hit h;
  isect(o, d, prev, h);
  const float new_depth = depth + 1.0f;
  bool alive_new = false;
  float dn[3], thr_new[3];
  if (h.found)
    alive_new = shade(d, h.nrm, h.color, h.emis, h.rtype, thr, acc, u[0],
                      u[1], u[2], u[3], static_cast<int>(new_depth),
                      max_depth, rr_start_depth, dn, thr_new);
  for (int k = 0; k < 3; ++k) {
    if (alive_new) {
      o[k] = h.point[k];
      d[k] = dn[k];
    }
    thr[k] = alive_new ? thr_new[k] : 0.0f;
  }
  depth = new_depth;
  prev = h.new_prev;
  return alive_new;
}

// What a chunk's trace reads and writes besides the scene and the pools
struct Chunk {
  size_t N;
  int base, jax_rows;
  size_t u_stride;
  uint32_t seed;
  int max_depth, rr_start_depth;
  const float* uniforms;
  float* acc_out;  // [3][slots]
  uint8_t* lives;
};

// An item's ray: the origin, direction and departed triangle of its part
__device__ __forceinline__ void item_ray(const float* __restrict__ in,
                                         const Chunk& c, int v, float o[3],
                                         float d[3], float& prev) {
  const int col = c.base + (v & 0x3fff), part = v >> 14;
  const int b = part_base(part);
  for (int k = 0; k < 3; ++k) {
    o[k] = in[(b + k) * c.N + col];
    d[k] = in[(b + 3 + k) * c.N + col];
  }
  prev = in[prev_row(part) * c.N + col];
}

// Bounce item v ((part << 14) | column in chunk) with isect, write its
// part's state rows, and put its acc and whether it lives at its slot
template <class Isect>
__device__ __forceinline__ void resolve_item(const float* __restrict__ in,
                                             float* __restrict__ out,
                                             const Chunk& c, int v,
                                             Isect isect) {
  constexpr int slots = K3_WINDOW * MAX_PARTS;
  const size_t N = c.N;
  const int cl = v & 0x3fff;
  const int part = v >> 14;
  const int slot = part * K3_WINDOW + cl;
  const int col = c.base + cl;
  const int b = part_base(part);
  float o[3], d[3], thr[3], acc[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = in[(b + k) * N + col];
    d[k] = in[(b + 3 + k) * N + col];
    thr[k] = in[(b + 6 + k) * N + col];
    acc[k] = part == 0 ? in[(ROW_ACC + k) * N + col] : 0.0f;
  }
  float prev = in[prev_row(part) * N + col];
  float depth = in[depth_row(part) * N + col];
  float u[4];
  const uint32_t key = mix32(
      pixel_key(c.seed, static_cast<int>(in[V2_ROW_PIX * N + col])),
      static_cast<uint32_t>(
          static_cast<int>(in[(c.jax_rows + part) * N + col])));
  for (int k = 0; k < 4; ++k)
    u[k] = c.uniforms != nullptr
               ? c.uniforms[k * c.u_stride + static_cast<size_t>(part) * N +
                            col]
               : draw(nullptr, 0, 0, key, static_cast<int>(depth), k);
  const bool alive = bounce(isect, o, d, thr, acc, prev, depth, u,
                            c.max_depth, c.rr_start_depth);
  for (int k = 0; k < 3; ++k) {
    out[(b + k) * N + col] = o[k];
    out[(b + 3 + k) * N + col] = d[k];
    out[(b + 6 + k) * N + col] = thr[k];
  }
  out[prev_row(part) * N + col] = prev;
  out[depth_row(part) * N + col] = depth;
  if (part == 0)
    out[ROW_ALIVE * N + col] = alive ? 1.0f : 0.0f;
  else
    out[(b - BUF_O + BUF_STATE) * N + col] = alive ? 2.0f : 0.0f;
  for (int k = 0; k < 3; ++k) c.acc_out[k * slots + slot] = acc[k];
  c.lives[slot] = alive ? 1 : 0;
}

// ---- the group split's scan on GlobalRows: a group's W lanes test W
// consecutive rows of one tile at a time, read tile-major from
// KernelScene.hit_tiles (isect_full.cuh tile_group_rows) ----

// scan_group<W, GlobalRows, Ops> with each tile's rows read from
// hit_tiles: the same result, bit for bit
template <int W, class Ops>
__device__ __forceinline__ float scan_group_tiled(const FullScene& sc,
                                                  const float* hit_tiles,
                                                  const float o[3],
                                                  const float d[3],
                                                  float prevf, bool has,
                                                  int lane, int& code) {
  using R = GlobalRows;
  const int g = lane & (W - 1), first = lane & ~(W - 1);
  float d_s;
  int i_s;
  uint32_t gate_ok;
  scan_spheres<R, Ops>(sc, o, d, d_s, i_s, gate_ok);
  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float d_t = BIG;
  int r_t = 0;
  group_rows<W, R, Ops>(R::rows(sc), 0, sc.tile_base, g, o, d, m, prevf,
                        gate_ok, true, d_t, r_t);
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
      if (__any_sync(0xffffffffu, mine))
        tile_group_rows<W, Ops>(
            hit_tiles + static_cast<size_t>(c0 + k) * HIT_F * TRI_TILE,
            sc.tile_base + (c0 + k) * TRI_TILE, g, o, d, m, prevf, gate_ok,
            mine, d_t, r_t);
    }
  }
  return scan_winner<R>(sc, d_s, i_s, d_t, r_t, code);
}

// Step 3 of a scene with more tiles than the key holds (kGroup): the key
// cannot group a warp's lanes by tiles past the 31st, so a warp that traced
// one sorted item a lane would run the union of its lanes' tiles. Instead:
//  a. each sorted item is filed: a tile query where its line enters a tile
//     (a key bit, or enters_a_tile past them), else a lane query; a stable
//     partition puts the lane queries at [0, nl) and the tile queries, in
//     their sorted order, at [nl, total);
//  b. warps take the tile queries PER at a time in that order (taking
//     them most key tiles first, as the one-lane trace takes its groups,
//     was 4% slower: neighbours in key order share tiles, in L1); each is
//     traced by a group of K3_GROUP lanes that split the base set's and
//     each tile's rows (scan_group_tiled), and lane 0 of the group keeps
//     the winner at the item's slot;
//  c. each thread takes the items tid, tid + K3_THREADS, ..: scans a lane
//     query itself (scan_lane), reads a tile query's winner, and bounces
//     the item as a lane does after isect_full (with the group's owner
//     bouncing its item at once, the 31 other lanes idled through it: 11%
//     slower). The scans give isect_full's result bit for bit, and the
//     draws are keyed by the item, so no result depends on its thread.
// The group split reads its rows on the read-only path: a scene of more
// tiles than the key holds has at least 2,048 rows, whose compact table
// (160 KB) does not fit beside the chunk's arrays in a block's shared
// memory on Hopper. group_items (if not null) gets the chunk's tile
// queries.
__device__ __forceinline__ void trace_split(const FullScene& sc,
                                            const float* __restrict__ in,
                                            float* __restrict__ out,
                                            const Chunk& ch,
                                            const uint32_t* keys,
                                            uint16_t* vals, int total,
                                            int* warp_sum, int* next_item,
                                            const float* hit_tiles,
                                            int* group_items) {
  using R = GlobalRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  // ---- a. file: thread tid holds items tid, tid + K3_THREADS, .. ----
  uint16_t v_r[ROUNDS];
  int before_r[ROUNDS];  // the lane queries before the item
  bool lane_r[ROUNDS];
  int nl = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (r * K3_THREADS >= total) continue;  // uniform over the block
    const int i = r * K3_THREADS + tid;
    uint16_t v = 0;
    bool lq = false;
    if (i < total) {
      v = vals[i];
      if (keys[i] == 0u) {
        float o[3], d[3], prev;
        item_ray(in, ch, v, o, d, prev);
        lq = !enters_a_tile<R>(sc, o, d);
      }
    }
    const unsigned ml = __ballot_sync(0xffffffffu, lq);
    if (lane == 0) warp_sum[warp] = __popc(ml);
    __syncthreads();
    int before = nl + __popc(ml & below);
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_sum[w];
      if (w < warp) before += c;
      nl += c;
    }
    __syncthreads();  // every item is read and warp_sum too
    v_r[r] = v;
    before_r[r] = before;
    lane_r[r] = lq;
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = r * K3_THREADS + tid;
    if (i >= total) continue;
    vals[lane_r[r] ? before_r[r] : nl + i - before_r[r]] = v_r[r];
  }
  const int tile_tasks = (total - nl + PER - 1) / PER;
  if (tid == 0 && group_items != nullptr) atomicAdd(group_items, total - nl);
  __syncthreads();
  // ---- b. trace the tile queries; each owner keeps its item's winner
  // (distance, code) in the acc rows of its slot until c. ----
  constexpr int slots = K3_WINDOW * MAX_PARTS;
  for (;;) {
    int q = 0;
    if (lane == 0) q = atomicAdd(next_item, 1);
    q = __shfl_sync(0xffffffffu, q, 0);
    if (q >= tile_tasks) break;
    const int first = nl + q * PER;
    const int at = first + lane / K3_GROUP;
    const bool has = at < total;
    const int v = vals[has ? at : first];
    float o[3], d[3], prev;
    item_ray(in, ch, v, o, d, prev);
    int code;
    const float t = scan_group_tiled<K3_GROUP, IeeeOps>(sc, hit_tiles, o, d,
                                                        prev, has, lane, code);
    if (has && (lane & (K3_GROUP - 1)) == 0) {
      const int slot = (v >> 14) * K3_WINDOW + (v & 0x3fff);
      ch.acc_out[slot] = t;
      ch.acc_out[slots + slot] = __int_as_float(code);
    }
  }
  __syncthreads();
  // ---- c. bounce every item, one a thread: a lane query's scan here ----
  for (int i = tid; i < total; i += K3_THREADS) {
    const int v = vals[i];
    const int slot = (v >> 14) * K3_WINDOW + (v & 0x3fff);
    resolve_item(in, out, ch, v,
                 [&](const float ro[3], const float rd[3], float prev,
                     Hit& h) {
                   int code;
                   float t;
                   if (i < nl) {
                     t = scan_lane<R, IeeeOps>(sc, ro, rd, prev, code);
                   } else {
                     t = ch.acc_out[slot];
                     code = __float_as_int(ch.acc_out[slots + slot]);
                   }
                   isect_surface<R>(sc, ro, rd, t, code, h);
                 });
  }
}

template <class R, bool kGroup>
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
resolve_pool_kernel(FullScene g, const float* __restrict__ in,
                    float* __restrict__ out, int n, int rows, int park_k,
                    int parts, uint32_t seed, int max_depth,
                    int rr_start_depth, const float* __restrict__ uniforms,
                    int* __restrict__ counts_out,
                    const float* __restrict__ hit_tiles,
                    int* __restrict__ group_items) {
  constexpr int window = K3_WINDOW;
  constexpr bool kShared = R::F == HIT_F;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t table_bar;
  __shared__ int warp_sum[WARPS];
  __shared__ int next_item;
  __shared__ uint16_t group_order[SLOTS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout lay =
      layout(g.n_tri, g.n_sph, g.n_bnd, g.n_tiles, kShared);
  const int slots = window * MAX_PARTS;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + lay.keys);
  float* acc_out = reinterpret_cast<float*>(smem + lay.acc);  // [3][slots]
  uint16_t* vals = reinterpret_cast<uint16_t*>(smem + lay.vals);
  uint8_t* lives = smem + lay.lives;
  uint8_t* live = smem + lay.live;

  FullScene sc = g;
  if constexpr (kShared) {
    float* s_hit = reinterpret_cast<float*>(smem + lay.hit);
    float* s_sph = reinterpret_cast<float*>(smem + lay.sph);
    float* s_bnd = reinterpret_cast<float*>(smem + lay.bnd);
    float* s_tiles = reinterpret_cast<float*>(smem + lay.tiles);
    if (tid == 0)
      stage_bulk(s_hit, g.hit, static_cast<uint32_t>(g.n_tri * HIT_F * 4),
                 &table_bar);
    for (int i = tid; i < g.n_sph * SPH_F; i += K3_THREADS)
      s_sph[i] = g.sph[i];
    for (int i = tid; i < g.n_bnd * 4; i += K3_THREADS) s_bnd[i] = g.bnd[i];
    for (int i = tid; i < g.n_tiles * TILE_F; i += K3_THREADS)
      s_tiles[i] = g.tiles[i];
    sc.hit = s_hit;
    sc.sph = s_sph;
    sc.bnd = s_bnd;
    sc.tiles = s_tiles;
  }
  __syncthreads();
  bool table_ready = !kShared;

  const size_t N = static_cast<size_t>(n);
  const int jax_rows = park_k ? V3_BUF_BASE + park_k * BUF_ROWS : V2_ROWS;
  const size_t u_stride = static_cast<size_t>(parts) * N;
  const int n_chunks = (n + window - 1) / window;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int base = chunk * window;
    if (tid == 0) next_item = 0;
    // ---- 1. load: pack the live (column, part) items in column order ----
    int total = 0;
    for (int c0 = 0; c0 < window; c0 += K3_THREADS) {
      const int cl = c0 + tid;
      const int col = base + cl;
      uint32_t mask = 0u;
      if (cl < window && col < n) {
        if (in[ROW_ALIVE * N + col] > 0.0f) mask = 1u;
        for (int j = 1; j < parts; ++j) {
          const float ps = in[(part_base(j) - BUF_O + BUF_STATE) * N + col];
          if (ps > 0.5f && ps < 1.5f) mask |= 1u << j;
        }
      }
      if (cl < window) live[cl] = static_cast<uint8_t>(mask);
      const int cnt = __popc(mask);
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      int pos = total + incl - cnt;
      for (int w = 0; w < WARPS; ++w) {
        const int v = warp_sum[w];
        if (w < warp) pos += v;
        total += v;
      }
      for (int j = 0; j < parts; ++j) {
        if (!((mask >> j) & 1u)) continue;
        const int b = part_base(j);
        float o[3], d[3];
        for (int k = 0; k < 3; ++k) {
          o[k] = in[(b + k) * N + col];
          d[k] = in[(b + 3 + k) * N + col];
        }
        keys[pos] = entry_key<R>(sc, o, d);
        vals[pos] = static_cast<uint16_t>((j << 14) | cl);
        ++pos;
      }
      __syncthreads();  // warp_sum is read before the next round writes it
    }

    // ---- 2. sort the chunk's items by key (bitonic, padded to 2^k) ----
    if (K3_SORT && total > 1 && g.n_tiles > 0) {
      int len = 32;
      while (len < total) len <<= 1;
      for (int i = total + tid; i < len; i += K3_THREADS) keys[i] = SORT_PAD;
      __syncthreads();
      for (int k = 2; k <= len; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = tid; i < len; i += K3_THREADS) {
            const int ixj = i ^ j;
            if (ixj > i) {
              const uint32_t a = keys[i], b = keys[ixj];
              if ((a > b) == ((i & k) == 0)) {
                keys[i] = b;
                keys[ixj] = a;
                const uint16_t t = vals[i];
                vals[i] = vals[ixj];
                vals[ixj] = t;
              }
            }
          }
          __syncthreads();
        }
      }
    }
    // the groups of 32 sorted items, in the order warps take them: by the
    // number of tiles the group's rays enter, most first, so that the
    // chunk's last groups are short (a counting sort by warp 0)
    const int groups = (total + 31) / 32;
    if (!kGroup && K3_GROUP_ORDER && tid < 32) {
      int start[33];
      for (int c = 0; c <= 32; ++c) start[c] = 0;
      for (int g = 0; g < groups; ++g) {
        const int i = g * 32 + lane;
        const uint32_t k = __reduce_or_sync(0xffffffffu,
                                            i < total ? keys[i] : 0u);
        if (lane == 0) ++start[32 - __popc(k)];
      }
      if (lane == 0) {
        int at = 0;
        for (int c = 0; c <= 32; ++c) {
          const int cnt = start[c];
          start[c] = at;
          at += cnt;
        }
      }
      for (int g = 0; g < groups; ++g) {
        const int i = g * 32 + lane;
        const uint32_t k = __reduce_or_sync(0xffffffffu,
                                            i < total ? keys[i] : 0u);
        if (lane == 0) group_order[start[32 - __popc(k)]++] = g;
      }
    }
    if (!table_ready) {
      wait_bulk(&table_bar);
      table_ready = true;
    }
    __syncthreads();

    const Chunk ch{N,         base,           jax_rows, u_stride, seed,
                   max_depth, rr_start_depth, uniforms, acc_out,  lives};
    if constexpr (kGroup) {
      trace_split(sc, in, out, ch, keys, vals, total, warp_sum, &next_item,
                     hit_tiles, group_items);
    } else {
      // ---- 3. trace every item: a warp takes the next group of 32 until
      // none are left, so warps that drew cheap groups take more ----
      for (;;) {
        int q = 0;
        if (lane == 0) q = atomicAdd(&next_item, 1);
        q = __shfl_sync(0xffffffffu, q, 0);
        if (q >= groups) break;
        const int i = (K3_GROUP_ORDER ? group_order[q] : q) * 32 + lane;
        if (i >= total) continue;
        resolve_item(in, out, ch, vals[i],
                     [&](const float o[3], const float d[3], float prev,
                         Hit& h) { isect_full<R>(sc, o, d, prev, true, h); });
      }
    }
    __syncthreads();

    // ---- 4. per column: acc in part order, done, and the other rows ----
    for (int cl = tid; cl < window; cl += K3_THREADS) {
      const int col = base + cl;
      if (col >= n) continue;
      const uint32_t mask = live[cl];
      float acc[3];
      for (int k = 0; k < 3; ++k) acc[k] = in[(ROW_ACC + k) * N + col];
      float done = in[V2_ROW_DONE * N + col];
      for (int j = 0; j < parts; ++j) {
        if (!((mask >> j) & 1u)) continue;
        const int slot = j * window + cl;
        for (int k = 0; k < 3; ++k)
          acc[k] = j == 0 ? acc_out[k * slots + slot]
                          : acc[k] + acc_out[k * slots + slot];
        if (!lives[slot]) done += 1.0f;
      }
      for (int r = 0; r < rows; ++r) {
        float val;
        if (r >= ROW_ACC && r < ROW_ACC + 3) {
          val = acc[r - ROW_ACC];
        } else if (r == V2_ROW_DONE) {
          val = done;
        } else if (r < V2_ROW_DONE) {  // the active path's rows
          if (mask & 1u) continue;  // its item wrote them
          const bool thr_row = r >= ROW_THR && r < ROW_THR + 3;
          val = (thr_row || r == ROW_ALIVE) ? 0.0f
                : r == ROW_PREV            ? -1.0f
                                           : in[r * N + col];
        } else {
          const int j = r >= V3_BUF_BASE && r < jax_rows
                            ? (r - V3_BUF_BASE) / BUF_ROWS + 1
                            : 0;
          if (j && j < parts && ((mask >> j) & 1u)) continue;
          val = in[r * N + col];
        }
        out[r * N + col] = val;
      }
      counts_out[col] = __popc(mask);
    }
    __syncthreads();  // the next chunk overwrites the shared arrays
  }
  if (!table_ready) wait_bulk(&table_bar);  // no copy outlives its block
}

using ResolveKernel = void (*)(FullScene, const float*, float*, int, int,
                               int, int, uint32_t, int, int, const float*,
                               int*, const float*, int*);

// The build for a scene: the group split where the tiles outnumber the
// key (on the read-only path), else the one-lane trace, whose key sees
// every tile, with rows from shared or device memory
ResolveKernel kernel_for(bool shared, int n_tiles) {
  if (n_tiles > KEY_TILES) return resolve_pool_kernel<GlobalRows, true>;
  return shared ? resolve_pool_kernel<SharedRows, false>
                : resolve_pool_kernel<GlobalRows, false>;
}

cudaError_t configure(ResolveKernel fn, size_t smem, int* blocks_per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                    K3_THREADS, smem);
  if (e == cudaSuccess && *blocks_per_sm < 1) e = cudaErrorInvalidConfiguration;
  return e;
}

// Whether the compact table, the small tables and the chunk's arrays fit in
// the shared memory one block may have on this card
bool table_fits(int n_sph, int n_bnd, int n_tri, int n_tiles) {
  int device = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, resolve_pool_kernel<SharedRows, false>) !=
          cudaSuccess)
    return false;
  const Layout lay = layout(n_tri, n_sph, n_bnd, n_tiles, true);
  return lay.bytes + static_cast<int>(fa.sharedSizeBytes) <= optin;
}

}  // namespace

// The launch configuration for a scene: out[0] the dynamic shared memory a
// block takes (bytes), out[1] resident blocks per SM, out[2] 1 where the
// compact table is staged in shared memory (else its rows are read from
// device memory: the scene's tables and the chunk's arrays do not fit in a
// block's shared memory, or `has_hit` is 0), out[3] the pool columns a
// chunk, out[4] the lanes that trace an item whose line enters a tile
// (K3_GROUP where the tiles outnumber the key, else 1). Returns a CUDA
// error code (cudaErrorInvalidConfiguration: no block fits on an SM).
extern "C" int pt_resolve_pool_config(int n_sph, int n_bnd, int n_tri,
                                      int n_tiles, int has_hit, int* out) {
  const bool shared = K3_SHARED_TABLE && has_hit && n_tiles <= KEY_TILES &&
                      table_fits(n_sph, n_bnd, n_tri, n_tiles);
  const Layout lay = layout(n_tri, n_sph, n_bnd, n_tiles, shared);
  int blocks = 0;
  const cudaError_t e =
      configure(kernel_for(shared, n_tiles), lay.bytes, &blocks);
  out[0] = lay.bytes;
  out[1] = blocks;
  out[2] = shared ? 1 : 0;
  out[3] = K3_WINDOW;
  out[4] = n_tiles > KEY_TILES ? K3_GROUP : 1;
  return static_cast<int>(e);
}

// Launch on `stream`. pool_in and pool_out are distinct [rows, n] float32
// matrices in the port's layout for park_k; parts - 1 <= park_k buffers are
// resolved. hit is KernelScene.hit ([n_tri, 20], 16-byte aligned) or NULL
// for the read-only path. uniforms is NULL for the counter generator, else
// [4, parts*n]. hit_tiles is KernelScene.hit_tiles ([n_tiles, 20, 64]),
// which the group split reads its tiles' rows from on the read-only path
// (NULL only for a scene of up to KEY_TILES tiles). group_items, NULL or
// one int32, gets the live items traced by a group of lanes (the scene's
// tiles outnumber the key, and the item's line enters one). Returns
// cudaGetLastError(), or the error that refused the configuration.
extern "C" int pt_resolve_pool(const float* sph, int n_sph, const float* bnd,
                               int n_bnd, const float* tri, int n_tri,
                               const float* hit, const float* hit_tiles,
                               const float* tiles,
                               int n_tiles, int tile_base,
                               const float* pool_in, float* pool_out, int n,
                               int park_k, int parts, uint32_t seed,
                               int max_depth, int rr_start_depth,
                               const float* uniforms, int* counts,
                               int* group_items, void* stream) {
  if (n <= 0) return 0;
  const FullScene sc{sph,   n_sph,   bnd,       n_bnd, tri,
                     n_tri, tiles,   n_tiles,   tile_base, hit};
  if (!full_scene_ok(sc) || park_k < 0 || park_k > MAX_PARK_K || parts < 1 ||
      parts > park_k + 1 || pool_in == pool_out ||
      (hit != nullptr && (reinterpret_cast<uintptr_t>(hit) & 15u)) ||
      (n_tiles > KEY_TILES && hit_tiles == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int cfg[5];
  const cudaError_t e = static_cast<cudaError_t>(pt_resolve_pool_config(
      n_sph, n_bnd, n_tri, n_tiles, hit != nullptr, cfg));
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_chunks = (n + K3_WINDOW - 1) / K3_WINDOW;
  const int grid = n_chunks < cfg[1] * sms ? n_chunks : cfg[1] * sms;
  const int rows =
      (park_k ? V3_BUF_BASE + park_k * BUF_ROWS : V2_ROWS) + 1 + park_k;
  kernel_for(cfg[2] != 0, n_tiles)<<<grid, K3_THREADS, cfg[0],
                                     static_cast<cudaStream_t>(stream)>>>(
      sc, pool_in, pool_out, n, rows, park_k, parts, seed, max_depth,
      rr_start_depth, uniforms, counts, hit_tiles, group_items);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
