// K5, K6 and K7: stepped path tracing, for Hopper (sm_90a).
//
// Replaces three TPU kernels. Two trace the interactive preview's camera
// rays, `steps` bounces per call, over a state that rides device memory
// between calls (K9, trace_pallas_sorted, is K6 with a sort of the rays in
// torch between calls):
//  - K5 pt_trace_stepped_static: path_tracer_tpu/ops/pallas/trace_v2.py
//    trace_pallas_v2 (body _make_kernel_v2), over the baked scene of at most
//    128 primitives. Plain torch version:
//    path_tracer_tpu_torch/ops/kernels/trace_v2.py:trace_stepped_plain.
//  - K6 pt_trace_stepped_prim: path_tracer_tpu/ops/pallas/trace_kernel.py
//    trace_pallas (body _make_kernel with regen=None, per_lane_depth=False),
//    over the table-driven scene of isect_full.cuh. Plain torch version:
//    path_tracer_tpu_torch/ops/kernels/trace_kernel.py:trace_stepped_plain.
// The third gives one full-scene bounce to rays whose depths differ (the
// portal schedulers' resolve of frozen paths):
//  - K7 pt_trace_resolve: path_tracer_tpu/ops/pallas/trace_kernel.py
//    trace_pallas_resolve (body _make_kernel with per_lane_depth=True, one
//    step): K6's body for one step, the depth read per ray and written back,
//    a dead ray's thr and prev cleaned. Plain torch version:
//    trace_kernel.py:trace_resolve_plain.
//
// What one call of K5 or K6 computes, per ray i: up to n_steps bounces at
// segment depths depth0, depth0 + 1, ..: closest hit (K5 the baked scan of
// K1, K6 the full-scene intersector of K3 and K4), then Russian roulette,
// emission and BSDF sampling (common.cuh shade) with the unconditional
// max-depth cut. The ray's state rows (ops/kernels/trace_kernel.py ROW_*:
// origin, direction, throughput, radiance, alive, departed triangle) are
// read once into registers and written back once, so calls with steps <
// max_depth chain as the JAX calls do. counts[i] gains one for every step
// that ray i starts alive.
//
// The camera entry (a camera given): the call starts the rays itself. Ray i
// is sample sample_idx[i] of pixel pixel_idx[i], made as the preview's
// render/raygen.py camera_rays makes it (preview_ray: the two raygen
// uniforms at depth 0, slots 4 and 5, and generate_rays' arithmetic), traced
// from depth 0; every state row and counts[i] are written, as a call on
// those rays would leave them, so later calls chain on. Its plain version
// is camera_rays followed by the plain trace.
//
// The JAX kernel skips a block whose lanes are all dead (trace_kernel.py
// _make_kernel's all-dead block skip). Here a ray dead on entry is not
// traced and not written, which is that skip ray by ray. INVARIANT (as in
// the JAX kernel): a ray keeps the prev and thr it had at death; a step
// that ran over a dead lane would have reset prev to -1 and thr to 0. Dead
// rays never come back to life in a stepped trace, so nothing reads them,
// and comparisons of the state rows hold only for live rays.
//
// Random numbers: the counter generator keyed by (seed, pixel_idx[i],
// sample_idx[i], depth, slot 0-3), the draws K1 makes for the same sample,
// or an injected table uniforms[(depth * 4 + slot) * n + i] (the JAX
// layout [max_depth * 4, n]). Every draw and row uses the ray's index i,
// never the thread's, so a ray computes the same on any thread: built with
// --fmad=false, K5 and K6 equal their plain versions bit for bit.
//
// What bounds them on this card: per-thread FP32 work and divergence. A ray
// moves 14 state floats in and out per call and does hundreds of flops per
// segment.
//
// K5's design. The parent kernel ran one thread a ray in blocks of 128,
// scanned the scene with common.cuh's prim_scan and ran at 48 registers, 10
// blocks an SM. A warp of 32 consecutive rays runs until its longest path
// ends: on the cornell preview frame 77% of its lane-steps do work
// (scripts/k5_coherence.py). Here, still one thread a ray:
//  - K1's split scan (k1_scan.cuh scan_split over trace_v2.k1_split_table:
//    no kind test, the exact fast root, the reciprocal without a range
//    check where trace_v2.k1_rcp_safe allows it) and K1's hit table for
//    shading, both staged into each block's shared memory; every lane of a
//    warp reads the same row, a broadcast;
//  - blocks of K5_THREADS (256), K5_MIN_BLOCKS (4) resident an SM asked of
//    ptxas (64 registers, no spills).
// Measured on the H100 (scripts/ablate_k5.py, PERF.md): 0.142 -> 0.123 ms
// on the 2-spp cornell frame. Lost and deleted: a persistent grid whose
// lanes take a new ray from a counter as soon as theirs stops (0.148 ms;
// the model's 0.779-0.859 of lane-steps against 0.774, but by reading the
// code each step then runs the raygen and the stores for a few lanes),
// packing each block's live rays to its first threads before each step
// through shared memory (0.128-0.156 ms; 0.924-0.980 of lane-steps), warps
// that take 32-ray groups from a counter (0.128 ms), other block sizes and
// register bounds.
//
// K6's design. The parent kernel ran one thread a ray for the whole call,
// so a warp ran until its longest path (6 to 12 bounces on mesh) ended,
// read its rows through the read-only cache, and lanes that walked
// different tiles made the warp execute the union of their rows: on the
// mesh preview frame 7% of the triangle rows executed were needed by a lane
// and 77% of lane-steps did work (scripts/k6_coherence.py). Here:
//  (a) the compact hit table (KernelScene.hit, 67,200 bytes for mesh) and
//      the small tables are staged into each resident block's dynamic
//      shared memory once (stage_scene: a TMA bulk copy on an mbarrier that
//      the block waits on before its first scan) and the scan reads them
//      there (SharedRows). A scene whose tables exceed the budget the
//      wrapper states (trace_kernel.K6_SHARED_BUDGET) reads its rows through
//      the read-only path (GlobalRows), chosen from the table's size before
//      the launch, never on failure;
//  (c) the production schedule (K6_SORT 1): a grid of the resident blocks
//      (2 of 256 threads an SM) takes chunks of up to K6_WINDOW (1,024)
//      consecutive rays (chunk_window: smaller when a frame has fewer
//      chunks than the card has blocks). Before each step a block packs the chunk's live
//      rays with their tile-entry keys (entry_key: the tiles the ray's line
//      enters) and bitonic-sorts them in shared memory, so a warp's 32 rays
//      enter the same tiles: 38% of the rows executed are needed. The warps
//      then take groups of 32 sorted rays, those whose keys hold the most
//      tiles first, read their state, give each one bounce and write it
//      back; the chunk's state stays in L2 between steps. A ray's index
//      travels with it: its draws and rows use it.
//  (b) the alternative schedule (K6_SORT 0): a persistent grid whose warps
//      keep one ray a lane for the whole call and, once K6_REFILL_MIN of a
//      warp's lanes stopped, write their rays out and take as many new ones
//      from a global counter (scratch the wrapper zeroes) with one warp-
//      aggregated atomicAdd. It lifts lane-steps doing work from 77% to 79%
//      only: paths are 6 to 12 bounces long, so little tail is left.
// Measured on the H100 (scripts/ablate_k6.py, PERF.md): the chunk sort with
// the shared table and the group order 1.70 ms at the preview frame,
// without the group order 1.96 ms, the refill kernel 3.1 ms, the parent
// 4.05-4.12 ms.
//
// K7's design. The parent ran one thread a lane, dead lanes included (a
// third of them at both of its routes' shapes), read its rows through the
// read-only path and made each warp run the union of its lanes' tiles: 31%
// (v1 front) and 18% (glue) of the rows executed were needed
// (scripts/k4_coherence.py resolve_model). Unlike K4's camera rays, 94% and
// 84% of K7's live rays enter a tile: they are rays the portal froze in
// front of the mesh. Here:
//  - a persistent grid of one block of 1,024 threads an SM, looping over
//    chunks of 1,024 consecutive lanes; the compact hit table staged in
//    shared memory (stage_scene), or the read-only path above the wrapper's
//    budget (trace_kernel.K7_SHARED_BUDGET), chosen before the launch;
//  - the owner of a dead lane cleans it (thr 0, prev -1, depth and count
//    rows), coalesced with its warp; a live lane files its ray: a tile query
//    if its line enters a tile, else a lane query;
//  - the tile queries are bitonic-sorted by their tile-entry key, led by the
//    number of tiles it holds (most first, so warps take the longest tasks
//    first); a warp then traces four of them at once, each by a group of
//    K7_GROUP (8) lanes that split the base set and each tile's 64 rows
//    (scan_group); the lane queries go 32 to a warp (scan_lane). The row
//    tests take K1's exact fast root and reciprocal (k1_scan.cuh FastOps),
//    and the scans stop at the last real sphere row (the wrapper passes
//    KernelScene.sph_rows: mesh's 8 rows are all padding);
//  - each owner reads its winner's surface (isect_surface), shades and
//    writes its lane's rows once. A ray's index is its lane, so its draws
//    and rows do not depend on the thread that traced it.
// Measured (scripts/ablate_k7.py, PERF.md): groups of 32 lanes a ray (K4's
// split) and one lane a ray after the sort were slower at the glue shape,
// 4 or 16 lanes and chunks of 512 lanes slower at both.

#include "isect_full.cuh"
#include "k1_scan.cuh"

using namespace pt;

namespace {

// K6's design choices, fixed at build time; scripts/ablate_k6.py builds the
// kernel with others (-D...) to time each part
#ifndef K6_THREADS
#define K6_THREADS 256  // threads a block
#endif
#ifndef K6_MIN_BLOCKS
#define K6_MIN_BLOCKS 1  // resident blocks an SM the registers must allow
#endif
#ifndef K6_REFILL_MIN
#define K6_REFILL_MIN 4  // stopped lanes of a warp that make it take new rays
#endif
#ifndef K6_PERSISTENT
#define K6_PERSISTENT 1  // 0: one thread a ray, a block per K6_THREADS rays
#endif
#ifndef K6_SHARED_TABLE
#define K6_SHARED_TABLE 1  // 0: every scene reads its rows from device memory
#endif
#ifndef K6_SORT
// 1: a block takes chunks of K6_WINDOW rays and, before each step, packs
// the chunk's live rays and sorts them by tile-entry key (K3's chunk sort,
// step by step); its warps trace the sorted rays, one bounce each, through
// the state in device memory. 0: the persistent refill kernel
#define K6_SORT 1
#endif
#ifndef K6_WINDOW
#define K6_WINDOW 1024  // the most rays a chunk under K6_SORT (a power of two)
#endif
#ifndef K6_SORT_BY_KEY
#define K6_SORT_BY_KEY 1  // 0: K6_SORT packs the live rays without sorting
#endif
#ifndef K6_GROUP_ORDER
// 1: under K6_SORT, warps take the groups of 32 sorted rays whose keys
// hold the most tiles first (K3's group order), so a step's last groups
// are short
#define K6_GROUP_ORDER 1
#endif
static_assert(K6_THREADS % 32 == 0 && K6_THREADS <= 1024, "K6_THREADS");
static_assert(K6_WINDOW >= 128 && K6_WINDOW <= 8192 &&
                  (K6_WINDOW & (K6_WINDOW - 1)) == 0,
              "K6_WINDOW: a power of two, 128 .. 8192");
constexpr int MIN_WINDOW = 128;
static_assert(K6_REFILL_MIN >= 1 && K6_REFILL_MIN <= 32,
              "K6_REFILL_MIN: 1 .. 32");

constexpr int K5_THREADS = 256;  // K5's threads a block
constexpr int K5_MIN_BLOCKS = 4;  // its resident blocks an SM asked of ptxas

constexpr unsigned FULL = 0xffffffffu;

// Row offsets of the state [STATE_ROWS, n] (trace_kernel.py ROW_*)
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13;
// K7's two more rows (trace_kernel.py RESOLVE_ROWS)
constexpr int ROW_DEPTH = 14, ROW_COUNT = 15;

struct Ray {
  float o[3], d[3], thr[3], acc[3];
  bool alive;
  float prev;
};

__device__ __forceinline__ Ray load_ray(const float* st, int n, int i) {
  Ray r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = st[(ROW_O + k) * n + i];
    r.d[k] = st[(ROW_D + k) * n + i];
    r.thr[k] = st[(ROW_THR + k) * n + i];
    r.acc[k] = st[(ROW_ACC + k) * n + i];
  }
  r.alive = st[ROW_ALIVE * n + i] > 0.0f;
  r.prev = st[ROW_PREV * n + i];
  return r;
}

__device__ __forceinline__ void store_ray(float* st, int n, int i,
                                          const Ray& r) {
  for (int k = 0; k < 3; ++k) {
    st[(ROW_O + k) * n + i] = r.o[k];
    st[(ROW_D + k) * n + i] = r.d[k];
    st[(ROW_THR + k) * n + i] = r.thr[k];
    st[(ROW_ACC + k) * n + i] = r.acc[k];
  }
  st[ROW_ALIVE * n + i] = r.alive ? 1.0f : 0.0f;
  st[ROW_PREV * n + i] = r.prev;
}

// The preview's camera (render/raygen.py camera_arrays): sensor origin, the
// two sensor vectors, the lens center, and the image size
struct PreviewCam {
  float so[3], su[3], sv[3], lc[3];
  int width, height;
};

// cam_host: 12 host floats (so, su, sv, lc), or NULL: no camera
PreviewCam make_preview_cam(const float* cam_host, int width, int height) {
  PreviewCam cam{};
  for (int k = 0; k < 3 && cam_host != nullptr; ++k) {
    cam.so[k] = cam_host[k];
    cam.su[k] = cam_host[3 + k];
    cam.sv[k] = cam_host[6 + k];
    cam.lc[k] = cam_host[9 + k];
  }
  cam.width = width;
  cam.height = height;
  return cam;
}

// A fresh ray of sample s of pixel pix (both >= 0) under the path key: the
// preview's camera_rays, in generate_rays' operation order. It divides by
// W and H where K1's camera_ray (common.cuh) multiplies by 1/W and 1/H, a
// different rounding.
__device__ __forceinline__ void preview_ray(const PreviewCam& cam, int pix,
                                            int s, uint32_t key, Ray& r) {
  const int row = pix / cam.width;
  const float y = static_cast<float>(cam.height - 1 - row);
  const float x = static_cast<float>(pix - row * cam.width);
  const float ysub = static_cast<float>((s >> 1) & 1);
  const float xsub = static_cast<float>(s & 1);
  const float xf = tent(to_uniform(mix32(key, 4u)));  // depth 0, slot 4
  const float yf = tent(to_uniform(mix32(key, 5u)));  // depth 0, slot 5
  const float sx =
      (x + 0.5f * (0.5f + xsub + xf)) / static_cast<float>(cam.width) - 0.5f;
  const float sy =
      (y + 0.5f * (0.5f + ysub + yf)) / static_cast<float>(cam.height) - 0.5f;
  float dd[3];
  for (int k = 0; k < 3; ++k)
    dd[k] = cam.lc[k] - (cam.so[k] + cam.su[k] * sx + cam.sv[k] * sy);
  const float dl = rsqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
  for (int k = 0; k < 3; ++k) {
    r.o[k] = cam.lc[k];
    r.d[k] = dd[k] * dl;
    r.thr[k] = 1.0f;
    r.acc[k] = 0.0f;
  }
  r.alive = true;
  r.prev = -1.0f;
}

__device__ __forceinline__ uint32_t ray_key(uint32_t seed,
                                            const int* pixel_idx,
                                            const int* sample_idx, int i) {
  return mix32(pixel_key(seed, pixel_idx[i]),
               static_cast<uint32_t>(sample_idx[i]));
}

// Shading uniform `slot` of segment `depth`: the table row depth * 4 + slot,
// or the counter generator under the path key
__device__ __forceinline__ float step_uniform(const float* __restrict__ table,
                                              int n, int i, uint32_t key,
                                              int depth, int slot) {
  if (table != nullptr)
    return table[static_cast<size_t>(depth * 4 + slot) * n + i];
  return to_uniform(mix32(key, static_cast<uint32_t>(depth) * 8u +
                                   static_cast<uint32_t>(slot)));
}

// One bounce after the hit is known: shading, then the state update of the
// JAX kernels' step body (o, d move only if the path lives on; thr is zeroed
// on death; prev becomes the hit triangle, -1 for a sphere or a miss)
__device__ __forceinline__ void bounce(Ray& r, bool found,
                                       const float point[3],
                                       const float nrm[3], const float* color,
                                       const float* emis, float rtype,
                                       float new_prev, const float u[4],
                                       int new_depth, int max_depth,
                                       int rr_start_depth) {
  bool alive_new = false;
  if (found) {
    float dn[3], thr_new[3];
    alive_new = shade(r.d, nrm, color, emis, rtype, r.thr, r.acc, u[0], u[1],
                      u[2], u[3], new_depth, max_depth, rr_start_depth, dn,
                      thr_new);
    if (alive_new) {
      for (int k = 0; k < 3; ++k) {
        r.o[k] = point[k];
        r.d[k] = dn[k];
        r.thr[k] = thr_new[k];
      }
    }
  }
  if (!alive_new)
    for (int k = 0; k < 3; ++k) r.thr[k] = 0.0f;
  r.prev = new_prev;
  r.alive = alive_new;
}

// What a stepped call is given, besides the scene
struct StepArgs {
  PreviewCam cam;  // the camera entry's
  const int* pixel_idx;
  const int* sample_idx;
  int n;
  uint32_t seed;
  int depth0, n_steps, max_depth, rr_start_depth;
  const float* uniforms;
  float* state;
  int* counts;
  int* next;  // K6's ray counter, zero at launch
  int window;  // K6_SORT's rays a chunk (chunk_window)
};

// Ray i at the start of a call: made by the camera entry, else read from
// the state. Returns whether it is alive, and its path key if so.
template <bool kCamera>
__device__ __forceinline__ bool start_ray(const StepArgs& a, int i, Ray& r,
                                          uint32_t& key) {
  if constexpr (kCamera) {
    key = ray_key(a.seed, a.pixel_idx, a.sample_idx, i);
    preview_ray(a.cam, a.pixel_idx[i], a.sample_idx[i], key, r);
    return true;
  } else {
    r = load_ray(a.state, a.n, i);
    if (r.alive) key = ray_key(a.seed, a.pixel_idx, a.sample_idx, i);
    return r.alive;
  }
}

// Ray i at the end of a call, after `steps` steps
template <bool kCamera>
__device__ __forceinline__ void finish_ray(const StepArgs& a, int i,
                                           const Ray& r, int steps) {
  store_ray(a.state, a.n, i, r);
  a.counts[i] = kCamera ? steps : a.counts[i] + steps;
}

// K5's scene: K1's split table [n_prims, SPLIT_F] (n_sph sphere rows first,
// 16-byte aligned), the gates [n_gates, GATE_F] and K1's hit table
// [n_prims, HIT_F]; rcp_safe: trace_v2.k1_rcp_safe
struct StaticScene {
  const float* split;
  const float* gates;
  const float* hit;
  int n_prims, n_sph, n_gates, rcp_safe;
};

// Dynamic shared memory K5 takes a block (floats): the split table (first,
// so that its rows are 16-byte aligned), the gates, the hit table
inline int static_smem_floats(int n_prims, int n_gates) {
  return n_prims * k1::SPLIT_F + n_gates * GATE_F + n_prims * k1::HIT_F;
}

// K5: one thread a ray, the scene in the block's shared memory; a ray dead
// on entry is not traced and not written
template <bool kCamera>
__global__ void __launch_bounds__(K5_THREADS, K5_MIN_BLOCKS)
trace_stepped_static_kernel(const StaticScene g, const StepArgs a) {
  extern __shared__ float4 static_smem[];
  float* split = reinterpret_cast<float*>(static_smem);
  float* gates = split + g.n_prims * k1::SPLIT_F;
  float* hits = gates + g.n_gates * GATE_F;
  for (int k = threadIdx.x; k < g.n_prims * k1::SPLIT_F; k += K5_THREADS)
    split[k] = g.split[k];
  for (int k = threadIdx.x; k < g.n_gates * GATE_F; k += K5_THREADS)
    gates[k] = g.gates[k];
  for (int k = threadIdx.x; k < g.n_prims * k1::HIT_F; k += K5_THREADS)
    hits[k] = g.hit[k];
  __syncthreads();

  const int i = blockIdx.x * K5_THREADS + threadIdx.x;
  Ray r;
  uint32_t key = 0u;
  if (i >= a.n || !start_ray<kCamera>(a, i, r, key)) return;
  int steps = 0;
  for (int s = 0; s < a.n_steps && r.alive; ++s) {
    ++steps;
    const int depth = a.depth0 + s;
    float u[4];
    for (int k = 0; k < 4; ++k)
      u[k] = step_uniform(a.uniforms, a.n, i, key, depth, k);
    float tmin;
    const int best =
        g.rcp_safe ? k1::scan_split<true>(split, g.n_sph, g.n_prims, gates,
                                          r.o, r.d, r.prev, tmin)
                   : k1::scan_split<false>(split, g.n_sph, g.n_prims, gates,
                                           r.o, r.d, r.prev, tmin);
    float point[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f};
    const float* h = hits + (best >= 0 ? best : 0) * k1::HIT_F;
    if (best >= 0) k1::hit_surface(h, r.o, r.d, tmin, point, nrm);
    bounce(r, best >= 0, point, nrm, h + k1::H_COLOR, h + k1::H_EMIS,
           h[k1::H_RTYPE], best >= 0 ? h[k1::H_PREVID] : -1.0f, u, depth + 1,
           a.max_depth, a.rr_start_depth);
  }
  finish_ray<kCamera>(a, i, r, steps);
}

// K6: a lane's ray, its index, path key and the steps it took in this call
struct Lane {
  Ray r;
  int i;
  uint32_t key;
  int steps;
};

template <class R, bool kCamera>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
trace_stepped_prim_kernel(const FullScene g, const StepArgs a) {
  constexpr bool kShared = R::F == HIT_F;
  extern __shared__ __align__(16) unsigned char table_smem[];
  __shared__ uint64_t table_bar;
  FullScene sc = g;
  if constexpr (kShared) sc = stage_scene(g, table_smem, &table_bar);
  __syncthreads();  // the only barrier: after it, warps go their own way
  bool table_ready = !kShared;

  const int lane = threadIdx.x & 31;
  const int wave = gridDim.x * K6_THREADS;
  // A lane holds a ray that runs (has), or one that stopped and waits to be
  // written out with its warp's next refill, so that one divergent branch
  // stores and loads for all the lanes it refills (pending)
  Lane l;
  bool has = false, pending = false;
  const int first = blockIdx.x * K6_THREADS + threadIdx.x;
  if (first < a.n) {
    l.i = first;
    l.steps = 0;
    has = start_ray<kCamera>(a, first, l.r, l.key);
  }
  bool more = K6_PERSISTENT && wave < a.n;  // warp-uniform
  while (true) {
    const unsigned idle = __ballot_sync(FULL, !has);
    if (pending && !more) {  // no refill will come
      finish_ray<kCamera>(a, l.i, l.r, l.steps);
      pending = false;
    }
    if (more && __popc(idle) >= K6_REFILL_MIN) {
      const int k = __popc(idle);
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(a.next, k);
      base = wave + __shfl_sync(FULL, base, leader);
      if (base + k >= a.n) more = false;
      if (!has) {
        if (pending) {
          finish_ray<kCamera>(a, l.i, l.r, l.steps);
          pending = false;
        }
        const int i = base + __popc(idle & ((1u << lane) - 1u));
        if (i < a.n) {
          l.i = i;
          l.steps = 0;
          has = start_ray<kCamera>(a, i, l.r, l.key);
        }
      }
      continue;  // rays dead on entry leave their lanes idle: refill again
    }
    if (__ballot_sync(FULL, has) == 0) {
      if (!more) break;
      continue;
    }
    if (!table_ready) {
      wait_bulk(&table_bar);
      table_ready = true;
    }
    if (has) {
      const int depth = a.depth0 + l.steps;
      ++l.steps;
      float u[4];
      for (int k = 0; k < 4; ++k)
        u[k] = step_uniform(a.uniforms, a.n, l.i, l.key, depth, k);
      Hit h;
      isect_full<R>(sc, l.r.o, l.r.d, l.r.prev, true, h);
      bounce(l.r, h.found, h.point, h.nrm, h.color, h.emis, h.rtype,
             h.new_prev, u, depth + 1, a.max_depth, a.rr_start_depth);
      if (!l.r.alive || l.steps == a.n_steps) {
        has = false;
        pending = true;
      }
    }
  }
  if (!table_ready) wait_bulk(&table_bar);  // no copy outlives its block
}

// K6 under K6_SORT: chunks of a.window consecutive rays, a block a chunk
// at a time. Before each step the block packs the chunk's live rays (a
// warp scan and a block scan, in ray order) with their tile-entry keys and
// bitonic-sorts them by key in shared memory; then each warp takes the next
// group of 32 sorted rays until none is left, reads their state, gives each
// one bounce and writes it back. A ray's arithmetic is the refill kernel's,
// so the result does not depend on the schedule.
template <class R, bool kCamera>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
trace_stepped_prim_sorted_kernel(const FullScene g, const StepArgs a) {
  constexpr bool kShared = R::F == HIT_F;
  constexpr int kWarps = K6_THREADS / 32;
  extern __shared__ __align__(16) unsigned char table_smem[];
  __shared__ uint64_t table_bar;
  __shared__ uint32_t keys[K6_WINDOW];
  __shared__ uint16_t vals[K6_WINDOW];  // the ray's place in its chunk
  __shared__ int warp_sum[kWarps];
  __shared__ int next_group;
  __shared__ uint16_t group_order[K6_GROUP_ORDER ? K6_WINDOW / 32 : 1];
  FullScene sc = g;
  if constexpr (kShared) sc = stage_scene(g, table_smem, &table_bar);
  __syncthreads();
  bool table_ready = !kShared;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int window = a.window;
  const int n_chunks = (a.n + window - 1) / window;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int base = chunk * window;
    for (int s = 0; s < a.n_steps; ++s) {
      const bool fresh = kCamera && s == 0;  // the camera entry's rays
      // ---- pack: the chunk's live rays in ray order, with their keys ----
      if (tid == 0) next_group = 0;
      int total = 0;
      for (int c0 = 0; c0 < window; c0 += K6_THREADS) {
        const int cl = c0 + tid;
        const int i = base + cl;
        Ray r;
        uint32_t key = 0u;
        bool live = false;
        if (cl < window && i < a.n) {
          if (fresh) {
            live = start_ray<true>(a, i, r, key);
          } else if (a.state[ROW_ALIVE * a.n + i] > 0.0f) {
            live = true;
            for (int k = 0; k < 3; ++k) {
              r.o[k] = a.state[(ROW_O + k) * a.n + i];
              r.d[k] = a.state[(ROW_D + k) * a.n + i];
            }
          }
        }
        int incl = live ? 1 : 0;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += v;
        }
        if (lane == 31) warp_sum[warp] = incl;
        __syncthreads();
        int pos = total + incl - (live ? 1 : 0);
        for (int w = 0; w < kWarps; ++w) {
          const int v = warp_sum[w];
          if (w < warp) pos += v;
          total += v;
        }
        if (live) {
          keys[pos] = entry_key<R>(sc, r.o, r.d);
          vals[pos] = static_cast<uint16_t>(cl);
        }
        __syncthreads();  // warp_sum is read before the next round writes it
      }
      if (total == 0) break;  // block-uniform: the chunk's rays are all dead
      // ---- sort the live rays by key (bitonic, padded to 2^k) ----
      if (K6_SORT_BY_KEY && sc.n_tiles > 0 && total > 1) {
        int len = 32;
        while (len < total) len <<= 1;
        for (int i = total + tid; i < len; i += K6_THREADS) keys[i] = SORT_PAD;
        __syncthreads();
        for (int k = 2; k <= len; k <<= 1) {
          for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < len; i += K6_THREADS) {
              const int ixj = i ^ j;
              if (ixj > i) {
                const uint32_t x = keys[i], y = keys[ixj];
                if ((x > y) == ((i & k) == 0)) {
                  keys[i] = y;
                  keys[ixj] = x;
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
      if (!table_ready) {
        wait_bulk(&table_bar);
        table_ready = true;
      }
      // ---- trace: a warp takes the next group of 32 sorted rays ----
      const int groups = (total + 31) / 32;
      if (K6_GROUP_ORDER && warp == 0) {  // a counting sort by key tiles
        int start = 0;  // lane c counts the groups of 32 - c tiles (31: 0-1)
        for (int q = 0; q < groups; ++q) {
          const int it = q * 32 + lane;
          const int c = min(32 - __popc(__reduce_or_sync(
                                     FULL, it < total ? keys[it] : 0u)), 31);
          if (lane == c) start += 1;
        }
        int incl = start;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += v;
        }
        int at = incl - start;
        for (int q = 0; q < groups; ++q) {
          const int it = q * 32 + lane;
          const int c = min(32 - __popc(__reduce_or_sync(
                                     FULL, it < total ? keys[it] : 0u)), 31);
          if (lane == c) group_order[at++] = static_cast<uint16_t>(q);
        }
        __syncwarp();
      }
      if (K6_GROUP_ORDER) __syncthreads();
      for (;;) {
        int q = 0;
        if (lane == 0) q = atomicAdd(&next_group, 1);
        q = __shfl_sync(FULL, q, 0);
        if (q >= groups) break;
        const int it = (K6_GROUP_ORDER ? group_order[q] : q) * 32 + lane;
        if (it >= total) continue;
        const int i = base + vals[it];
        Ray r;
        uint32_t key = 0u;
        if (fresh) {
          start_ray<true>(a, i, r, key);
        } else {
          r = load_ray(a.state, a.n, i);
          key = ray_key(a.seed, a.pixel_idx, a.sample_idx, i);
        }
        const int depth = a.depth0 + s;
        float u[4];
        for (int k = 0; k < 4; ++k)
          u[k] = step_uniform(a.uniforms, a.n, i, key, depth, k);
        Hit h;
        isect_full<R>(sc, r.o, r.d, r.prev, true, h);
        bounce(r, h.found, h.point, h.nrm, h.color, h.emis, h.rtype,
               h.new_prev, u, depth + 1, a.max_depth, a.rr_start_depth);
        store_ray(a.state, a.n, i, r);
        a.counts[i] = fresh ? 1 : a.counts[i] + 1;
      }
      __syncthreads();  // the next step reads the rays this one wrote
    }
  }
  if (!table_ready) wait_bulk(&table_bar);  // no copy outlives its block
}

// ---- K7: one bounce at each ray's own depth ----

constexpr int K7_THREADS = 1024;  // threads a block, and lanes a chunk
constexpr int K7_GROUP = 8;  // lanes that trace a ray whose line enters a tile

struct ResolveArgs {
  const float* in;  // [16, n]: the state rows, depth
  float* out;       // [16, n]: the state rows, depth, count
  const int* pixel_idx;
  const int* sample_idx;
  int n;
  uint32_t seed;
  int max_depth, rr_start_depth;
  const float* uniforms;  // [4, n] or NULL
};

// Where a block's queries sit after its tables (bytes from the start of its
// dynamic shared memory): per thread, its lane's (origin, departed
// triangle) and (direction, 0), the winner's code and distance in their .w
// once traced; the chunk's tile queries (rays whose line enters a tile) and
// lane queries (the rest), by owner; the tile queries' sort keys.
struct ResolveLayout {
  int q, tile_q, lane_q, keys, bytes;
};

__host__ __device__ inline ResolveLayout resolve_layout(int table_bytes) {
  ResolveLayout l;
  l.q = align16(table_bytes);
  l.tile_q = l.q + K7_THREADS * 32;
  l.lane_q = l.tile_q + K7_THREADS * 2;
  l.keys = align16(l.lane_q + K7_THREADS * 2);
  l.bytes = l.keys + K7_THREADS * 4;
  return l;
}

// A dead lane, cleaned as the JAX kernel's step cleans a dead lane of a live
// block: thr 0, prev -1, alive 0; depth += alive (its row value); count =
// alive; the other rows pass through
__device__ __forceinline__ void clean_lane(const ResolveArgs& a, size_t N,
                                           int i, float alive_f) {
  for (int k = 0; k < 3; ++k) {
    a.out[(ROW_O + k) * N + i] = a.in[(ROW_O + k) * N + i];
    a.out[(ROW_D + k) * N + i] = a.in[(ROW_D + k) * N + i];
    a.out[(ROW_THR + k) * N + i] = 0.0f;
    a.out[(ROW_ACC + k) * N + i] = a.in[(ROW_ACC + k) * N + i];
  }
  a.out[ROW_ALIVE * N + i] = 0.0f;
  a.out[ROW_PREV * N + i] = -1.0f;
  a.out[ROW_DEPTH * N + i] = a.in[ROW_DEPTH * N + i] + alive_f;
  a.out[ROW_COUNT * N + i] = alive_f;
}

// K7 (see the file's head): a persistent grid of one block of K7_THREADS an
// SM, each block looping over chunks of K7_THREADS consecutive lanes. Thread
// t owns lane t of the chunk: it cleans the lane if it is dead, or files its
// query; the block's warps trace the queries; the owner reads its winner's
// surface, shades and writes the lane's rows.
template <class R>
__global__ void __launch_bounds__(K7_THREADS, 1)
trace_resolve_kernel(const FullScene g, const ResolveArgs a) {
  constexpr bool kShared = R::F == HIT_F;
  constexpr int kPer = 32 / K7_GROUP;  // tile queries a warp task
  extern __shared__ __align__(16) unsigned char k7_smem[];
  __shared__ uint64_t table_bar;
  __shared__ int n_tile[2], n_lane[2], next_task[2];  // by the chunk's parity
  const int tid = threadIdx.x, lane = tid & 31;
  FullScene sc = g;
  int table_bytes = 0;
  if constexpr (kShared) {
    sc = stage_scene(g, k7_smem, &table_bar);
    table_bytes = scene_layout(g.n_tri, g.n_sph, g.n_bnd, g.n_tiles).bytes;
  }
  if (tid < 2) n_tile[tid] = n_lane[tid] = next_task[tid] = 0;
  __syncthreads();
  bool table_ready = !kShared;
  const ResolveLayout rl = resolve_layout(table_bytes);
  float4* q = reinterpret_cast<float4*>(k7_smem + rl.q);  // 2 a thread
  uint16_t* tile_q = reinterpret_cast<uint16_t*>(k7_smem + rl.tile_q);
  uint16_t* lane_q = reinterpret_cast<uint16_t*>(k7_smem + rl.lane_q);
  uint32_t* keys = reinterpret_cast<uint32_t*>(k7_smem + rl.keys);
  const size_t N = static_cast<size_t>(a.n);
  const int n_chunks = (a.n + K7_THREADS - 1) / K7_THREADS;
  const unsigned below = (1u << lane) - 1u;

  int p = 0;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x, p ^= 1) {
    const int i = chunk * K7_THREADS + tid;
    // ---- each owner: clean a dead lane, or file a live lane's query ----
    float alive_f = 0.0f;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    if (i < a.n) {
      alive_f = a.in[ROW_ALIVE * N + i];
      if (alive_f > 0.0f) {
        for (int k = 0; k < 3; ++k) {
          o[k] = a.in[(ROW_O + k) * N + i];
          d[k] = a.in[(ROW_D + k) * N + i];
        }
        q[2 * tid] = make_float4(o[0], o[1], o[2], a.in[ROW_PREV * N + i]);
        q[2 * tid + 1] = make_float4(d[0], d[1], d[2], 0.0f);
      } else {
        clean_lane(a, N, i, alive_f);
      }
    }
    const bool live = i < a.n && alive_f > 0.0f;
    const bool enters = live && enters_a_tile<R>(sc, o, d);
    const unsigned mt = __ballot_sync(FULL, enters);
    const unsigned ml = __ballot_sync(FULL, live && !enters);
    int bt = 0, bl = 0;
    if (lane == 0) {
      if (mt) bt = atomicAdd(&n_tile[p], __popc(mt));
      if (ml) bl = atomicAdd(&n_lane[p], __popc(ml));
    }
    bt = __shfl_sync(FULL, bt, 0);
    bl = __shfl_sync(FULL, bl, 0);
    if (enters) {  // sort key: the tiles the key holds, most first, then it
      const int at = bt + __popc(mt & below);
      const uint32_t key = entry_key<R>(sc, o, d);
      tile_q[at] = static_cast<uint16_t>(tid);
      keys[at] = (static_cast<uint32_t>(31 - __popc(key)) << 27) |
                 (key & 0x07ffffffu);
    }
    if (live && !enters)
      lane_q[bl + __popc(ml & below)] = static_cast<uint16_t>(tid);
    __syncthreads();
    const int tiles_n = n_tile[p], lanes_n = n_lane[p];
    // the next chunk's counters: every thread read them before this
    // chunk's barrier above, and takes them up after the one below
    if (tid == 0) n_tile[p ^ 1] = n_lane[p ^ 1] = next_task[p ^ 1] = 0;
    if (!table_ready && tiles_n + lanes_n > 0) {
      wait_bulk(&table_bar);
      table_ready = true;
    }
    if (tiles_n > 1) {  // the tile queries by sort key (bitonic, 2^k)
      int len = 32;
      while (len < tiles_n) len <<= 1;
      for (int j = tiles_n + tid; j < len; j += K7_THREADS) keys[j] = SORT_PAD;
      __syncthreads();
      for (int k = 2; k <= len; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int x = tid; x < len; x += K7_THREADS) {
            const int y = x ^ j;
            if (y > x) {
              const uint32_t kx = keys[x], ky = keys[y];
              if ((kx > ky) == ((x & k) == 0)) {
                keys[x] = ky;
                keys[y] = kx;
                const uint16_t t = tile_q[x];
                tile_q[x] = tile_q[y];
                tile_q[y] = t;
              }
            }
          }
          __syncthreads();
        }
      }
    }
    // ---- trace: warps take kPer tile queries at a time (K7_GROUP lanes
    // each), those of most tiles first, then the lane queries 32 at a
    // time ----
    const int tile_tasks = (tiles_n + kPer - 1) / kPer;
    const int tasks = tile_tasks + (lanes_n + 31) / 32;
    for (;;) {
      int task = 0;
      if (lane == 0) task = atomicAdd(&next_task[p], 1);
      task = __shfl_sync(FULL, task, 0);
      if (task >= tasks) break;
      if (task < tile_tasks) {
        const int at = task * kPer + lane / K7_GROUP;
        const bool has = at < tiles_n;
        const int j = tile_q[has ? at : task * kPer];
        const float4 op = q[2 * j], dr = q[2 * j + 1];
        const float ro[3] = {op.x, op.y, op.z}, rd[3] = {dr.x, dr.y, dr.z};
        int code;
        const float t = scan_group<K7_GROUP, R, k1::FastOps>(
            sc, ro, rd, op.w, has, lane, code);
        __syncwarp();  // every lane has read its ray before one writes
        if (has && (lane & (K7_GROUP - 1)) == 0) {
          q[2 * j].w = __int_as_float(code);
          q[2 * j + 1].w = t;
        }
      } else if (const int at = (task - tile_tasks) * 32 + lane; at < lanes_n) {
        const int j = lane_q[at];
        const float4 op = q[2 * j], dr = q[2 * j + 1];
        const float ro[3] = {op.x, op.y, op.z}, rd[3] = {dr.x, dr.y, dr.z};
        int code;
        const float t = scan_lane<R, k1::FastOps>(sc, ro, rd, op.w, code);
        q[2 * j].w = __int_as_float(code);
        q[2 * j + 1].w = t;
      }
    }
    __syncthreads();
    // ---- each owner of a live lane: its winner's surface, one bounce ----
    if (live) {
      const float4 op = q[2 * tid], dr = q[2 * tid + 1];
      Ray r;
      r.o[0] = op.x, r.o[1] = op.y, r.o[2] = op.z;
      r.d[0] = dr.x, r.d[1] = dr.y, r.d[2] = dr.z;
      for (int k = 0; k < 3; ++k) {
        r.thr[k] = a.in[(ROW_THR + k) * N + i];
        r.acc[k] = a.in[(ROW_ACC + k) * N + i];
      }
      r.alive = true;
      r.prev = -1.0f;  // bounce sets it
      const float depth = a.in[ROW_DEPTH * N + i];
      const uint32_t key = mix32(pixel_key(a.seed, a.pixel_idx[i]),
                                 static_cast<uint32_t>(a.sample_idx[i]));
      const int dep = static_cast<int>(depth);
      float u[4];
      for (int k = 0; k < 4; ++k) u[k] = draw(a.uniforms, a.n, i, key, dep, k);
      Hit h;
      isect_surface<R>(sc, r.o, r.d, dr.w, __float_as_int(op.w), h);
      bounce(r, h.found, h.point, h.nrm, h.color, h.emis, h.rtype, h.new_prev,
             u, static_cast<int>(depth + 1.0f), a.max_depth, a.rr_start_depth);
      store_ray(a.out, a.n, i, r);
      a.out[ROW_DEPTH * N + i] = depth + alive_f;
      a.out[ROW_COUNT * N + i] = alive_f;
    }
  }
  if (!table_ready) wait_bulk(&table_bar);  // no copy outlives its block
}

using ResolveKernel = void (*)(const FullScene, const ResolveArgs);

ResolveKernel resolve_kernel_for(bool shared) {
  return shared ? trace_resolve_kernel<SharedRows>
                : trace_resolve_kernel<GlobalRows>;
}

// K7's launch configuration: out[0] the dynamic shared memory a block takes
// (bytes), out[1] resident blocks per SM, out[2] threads a block, out[3]
// SMs, out[4] registers a thread, out[5] local (spill) bytes a thread,
// out[6] the shared memory a block may opt in to (bytes), out[7] the static
// shared memory a block takes (bytes), out[8] K7_GROUP
cudaError_t resolve_config(const FullScene& sc, bool shared, int* out) {
  const ResolveKernel fn = resolve_kernel_for(shared);
  const int table =
      shared ? scene_layout(sc.n_tri, sc.n_sph, sc.n_bnd, sc.n_tiles).bytes
             : 0;
  const int smem = resolve_layout(table).bytes;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[6], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, K7_THREADS,
                                                      smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  out[0] = smem;
  out[2] = K7_THREADS;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[7] = static_cast<int>(fa.sharedSizeBytes);
  out[8] = K7_GROUP;
  return out[1] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Checks of a stepped call's arguments; a camera entry starts at depth 0
bool stepped_args_ok(const StepArgs& a, bool camera) {
  return a.n > 0 && a.depth0 >= 0 && a.n_steps > 0 && a.max_depth > 0 &&
         (!camera || (a.depth0 == 0 && a.cam.width > 0 && a.cam.height > 0));
}

StepArgs step_args(const float* cam, int width, int height,
                   const int* pixel_idx, const int* sample_idx, int n,
                   uint32_t seed, int depth0, int n_steps, int max_depth,
                   int rr_start_depth, const float* uniforms, float* state,
                   int* counts, int* next) {
  return StepArgs{make_preview_cam(cam, width, height),
                  pixel_idx, sample_idx, n, seed, depth0, n_steps, max_depth,
                  rr_start_depth, uniforms, state, counts, next, K6_WINDOW};
}

// K6_SORT's rays a chunk for n rays on `resident` blocks: the smallest power
// of two down from K6_WINDOW (to MIN_WINDOW) that takes no more waves of the
// resident blocks than K6_WINDOW itself. A chunk of half the rays takes
// about four fifths of the time (PERF.md), so a frame of fewer chunks than
// blocks runs in smaller chunks on more of them.
int chunk_window(int n, int resident) {
  const auto waves = [&](int w) {
    return ((n + w - 1) / w + resident - 1) / resident;
  };
  int w = K6_WINDOW;
  while (w > MIN_WINDOW && waves(w / 2) <= waves(K6_WINDOW)) w /= 2;
  return w;
}

// K6's kernel for a table path and entry
using PrimKernel = void (*)(const FullScene, const StepArgs);

PrimKernel prim_kernel_for(bool shared, bool camera) {
#if K6_SORT
  if (shared)
    return camera ? trace_stepped_prim_sorted_kernel<SharedRows, true>
                  : trace_stepped_prim_sorted_kernel<SharedRows, false>;
  return camera ? trace_stepped_prim_sorted_kernel<GlobalRows, true>
                : trace_stepped_prim_sorted_kernel<GlobalRows, false>;
#else
  if (shared)
    return camera ? trace_stepped_prim_kernel<SharedRows, true>
                  : trace_stepped_prim_kernel<SharedRows, false>;
  return camera ? trace_stepped_prim_kernel<GlobalRows, true>
                : trace_stepped_prim_kernel<GlobalRows, false>;
#endif
}

// K6's launch configuration for a table path and entry on the current card:
// out[0] the dynamic shared memory a block takes (bytes), out[1] resident
// blocks per SM, out[2] threads a block, out[3] SMs, out[4] registers a
// thread, out[5] local (spill) bytes a thread, out[6] K6_REFILL_MIN, out[7]
// K6_PERSISTENT, out[8] the shared memory a block may opt in to (bytes),
// out[9] K6_SORT, out[10] K6_WINDOW (the most rays a chunk), out[11] the
// static shared memory a block takes (bytes)
cudaError_t prim_config(const FullScene& sc, bool shared, bool camera,
                        int* out) {
  const PrimKernel fn = prim_kernel_for(shared, camera);
  const int smem =
      shared ? scene_layout(sc.n_tri, sc.n_sph, sc.n_bnd, sc.n_tiles).bytes : 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[8], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, K6_THREADS,
                                                      smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  out[0] = smem;
  out[2] = K6_THREADS;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[6] = K6_REFILL_MIN;
  out[7] = K6_PERSISTENT;
  out[9] = K6_SORT;
  out[10] = K6_WINDOW;
  out[11] = static_cast<int>(fa.sharedSizeBytes);
  return out[1] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

FullScene full_scene(const float* sph, int n_sph, const float* bnd, int n_bnd,
                     const float* tri, int n_tri, const float* hit,
                     const float* tiles, int n_tiles, int tile_base) {
  return FullScene{sph, n_sph, bnd, n_bnd, tri, n_tri, tiles, n_tiles,
                   tile_base, hit};
}

}  // namespace

// K5's launch configuration for the camera entry (camera 1) or given rays
// and a scene of n_prims rows and n_gates gates: out[0] the dynamic shared
// memory a block takes (bytes), out[1] resident blocks per SM, out[2]
// threads a block, out[3] SMs, out[4] registers a thread, out[5] local
// (spill) bytes a thread, out[6] the blocks an SM asked of ptxas. Returns
// a CUDA error code (cudaErrorInvalidConfiguration: no block fits on an
// SM).
extern "C" int pt_trace_stepped_static_config(int n_prims, int n_gates,
                                              int camera, int* out) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_gates < 0 ||
      n_gates > MAX_PRIMS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = camera ? trace_stepped_static_kernel<true>
                         : trace_stepped_static_kernel<false>;
  const int smem =
      static_smem_floats(n_prims, n_gates) * static_cast<int>(sizeof(float));
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, K5_THREADS,
                                                      smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = smem;
  out[2] = K5_THREADS;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[6] = K5_MIN_BLOCKS;
  return static_cast<int>(out[1] < 1 ? cudaErrorInvalidConfiguration
                                     : cudaSuccess);
}

// K5 on `stream`: one call of n_steps bounces over the state [14, n]
// (updated in place) and counts [n] (added to); with a camera (cam: 12 host
// floats so, su, sv, lc, and the image's width and height; NULL: none) the
// call is the camera entry, which starts the rays at depth0 0 and writes
// every state row and the counts. split, hit: SceneConsts.split ([n_prims,
// 20], n_sph sphere rows first, 16-byte aligned) and SceneConsts.hit
// ([n_prims, 13]); rcp_safe: SceneConsts.rcp_safe. uniforms is NULL for the
// counter generator, else the whole [max_depth * 4, n] table. Returns
// cudaGetLastError() after the launch.
extern "C" int pt_trace_stepped_static(
    const float* split, int n_prims, int n_sph, int rcp_safe,
    const float* gates, int n_gates, const float* hit, const float* cam,
    int width, int height, const int* pixel_idx, const int* sample_idx,
    int n, uint32_t seed, int depth0, int n_steps, int max_depth,
    int rr_start_depth, const float* uniforms, float* state, int* counts,
    void* stream) {
  if (n <= 0) return 0;
  const StepArgs a =
      step_args(cam, width, height, pixel_idx, sample_idx, n, seed, depth0,
                n_steps, max_depth, rr_start_depth, uniforms, state, counts,
                nullptr);
  if (!stepped_args_ok(a, cam != nullptr) || n_prims <= 0 ||
      n_prims > MAX_PRIMS || n_gates < 0 || n_gates > MAX_PRIMS ||
      n_sph < 0 || n_sph > n_prims || split == nullptr || hit == nullptr ||
      (reinterpret_cast<uintptr_t>(split) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  const StaticScene sc{split, gates, hit, n_prims, n_sph, n_gates, rcp_safe};
  const size_t smem =
      static_cast<size_t>(static_smem_floats(n_prims, n_gates)) * sizeof(float);
  const int blocks = (n + K5_THREADS - 1) / K5_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cam != nullptr)
    trace_stepped_static_kernel<true><<<blocks, K5_THREADS, smem, st>>>(sc, a);
  else
    trace_stepped_static_kernel<false><<<blocks, K5_THREADS, smem, st>>>(sc, a);
  return static_cast<int>(cudaGetLastError());
}

// K6's launch configuration (prim_config's out[0..11]) for a scene of these
// table sizes: shared 1 for the table in shared memory, camera 1 for the
// camera entry. Returns a CUDA error code (cudaErrorInvalidConfiguration:
// no block fits on an SM).
extern "C" int pt_trace_stepped_prim_config(int n_sph, int n_bnd, int n_tri,
                                            int n_tiles, int shared,
                                            int camera, int* out) {
  const FullScene sc = full_scene(nullptr, n_sph, nullptr, n_bnd, nullptr,
                                  n_tri, nullptr, nullptr, n_tiles, 0);
  return static_cast<int>(prim_config(sc, shared != 0 && K6_SHARED_TABLE,
                                      camera != 0, out));
}

// Whether K6 runs the chunk sort (K6_SORT), whose launch takes no ray
// counter
extern "C" {
int pt_trace_stepped_prim_sort = K6_SORT;
}

// K6 on `stream`: as pt_trace_stepped_static over the table-driven scene.
// hit is KernelScene.hit ([n_tri, 20], 16-byte aligned), whose rows the
// scan reads from shared memory, or NULL for the read-only path. next: one
// int on the device, zero at launch (the refill kernel's ray counter; NULL
// under K6_SORT).
extern "C" int pt_trace_stepped_prim(
    const float* sph, int n_sph, const float* bnd, int n_bnd,
    const float* tri, int n_tri, const float* hit, const float* tiles,
    int n_tiles, int tile_base, const float* cam, int width, int height,
    const int* pixel_idx, const int* sample_idx, int n, uint32_t seed,
    int depth0, int n_steps, int max_depth, int rr_start_depth,
    const float* uniforms, float* state, int* counts, int* next,
    void* stream) {
  if (n <= 0) return 0;
  const FullScene sc = full_scene(sph, n_sph, bnd, n_bnd, tri, n_tri, hit,
                                  tiles, n_tiles, tile_base);
  StepArgs a = step_args(cam, width, height, pixel_idx, sample_idx, n, seed,
                         depth0, n_steps, max_depth, rr_start_depth, uniforms,
                         state, counts, next);
  const bool shared = hit != nullptr && K6_SHARED_TABLE;
  if (!stepped_args_ok(a, cam != nullptr) || !full_scene_ok(sc) ||
      (!K6_SORT && next == nullptr) ||
      (shared && (reinterpret_cast<uintptr_t>(hit) & 15u)))
    return static_cast<int>(cudaErrorInvalidValue);
  int cfg[12];
  const cudaError_t e = prim_config(sc, shared, cam != nullptr, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int resident = cfg[1] * cfg[3];
  a.window = chunk_window(n, resident);
  const int blocks = K6_SORT ? (n + a.window - 1) / a.window
                             : (n + K6_THREADS - 1) / K6_THREADS;
  const int grid =
      (K6_PERSISTENT || K6_SORT) && blocks > resident ? resident : blocks;
  const PrimKernel kernel = prim_kernel_for(shared, cam != nullptr);
  kernel<<<grid, K6_THREADS, cfg[0], static_cast<cudaStream_t>(stream)>>>(sc,
                                                                          a);
  return static_cast<int>(cudaGetLastError());
}

// K7's launch configuration (resolve_config's out[0..8]) for a scene of
// these table sizes, shared 1 for the table in shared memory. Returns a
// CUDA error code (cudaErrorInvalidConfiguration: no block fits on an SM).
extern "C" int pt_trace_resolve_config(int n_sph, int n_bnd, int n_tri,
                                       int n_tiles, int shared, int* out) {
  const FullScene sc = full_scene(nullptr, n_sph, nullptr, n_bnd, nullptr,
                                  n_tri, nullptr, nullptr, n_tiles, 0);
  return static_cast<int>(resolve_config(sc, shared != 0, out));
}

// K7 on `stream`: one bounce of every ray of `in` [16, n] at its own depth
// into `out` [16, n] (distinct buffers). hit is KernelScene.hit ([n_tri,
// 20], 16-byte aligned), whose rows the scans read from shared memory, or
// NULL for the read-only path. uniforms is NULL for the counter generator,
// else [4, n].
extern "C" int pt_trace_resolve(
    const float* sph, int n_sph, const float* bnd, int n_bnd,
    const float* tri, int n_tri, const float* hit, const float* tiles,
    int n_tiles, int tile_base, const float* in, float* out,
    const int* pixel_idx, const int* sample_idx, int n, uint32_t seed,
    int max_depth, int rr_start_depth, const float* uniforms, void* stream) {
  if (n <= 0) return 0;
  const FullScene sc = full_scene(sph, n_sph, bnd, n_bnd, tri, n_tri, hit,
                                  tiles, n_tiles, tile_base);
  const bool shared = hit != nullptr;
  if (!full_scene_ok(sc) || max_depth <= 0 || in == out ||
      (shared && (reinterpret_cast<uintptr_t>(hit) & 15u)))
    return static_cast<int>(cudaErrorInvalidValue);
  int cfg[9];
  const cudaError_t e = resolve_config(sc, shared, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  const ResolveArgs a{in,  out,  pixel_idx, sample_idx,     n,
                      seed, max_depth, rr_start_depth, uniforms};
  const int chunks = (n + K7_THREADS - 1) / K7_THREADS;
  const int resident = cfg[1] * cfg[3];
  resolve_kernel_for(shared)<<<chunks < resident ? chunks : resident,
                               K7_THREADS, cfg[0],
                               static_cast<cudaStream_t>(stream)>>>(sc, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
