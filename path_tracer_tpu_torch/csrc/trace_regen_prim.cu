// K4: regenerative path tracing over the full table-driven scene, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas/trace_kernel.py:
// trace_pallas_regen_prim (kernel body _make_kernel(..., regen=)), the
// JAX package's route for triangle-heavy scenes without the portal
// (its `pallasr:` mode). The plain torch version of this file is
// path_tracer_tpu_torch/ops/kernels/trace_kernel.py:trace_regen_prim_plain.
//
// What it computes: K1's regenerative loop (trace_regen.cu) with the
// full-scene intersector of isect_full.cuh in place of the baked scan.
// Item i owns pixel pixel_idx[i] and traces `quota` full samples (global
// indices sample_base ..), restarting the moment its path dies.
//
// What bounds it on this card: the longest serial chain of row tests in a
// step, not the rows. A segment tests the base set and each Morton tile of
// 64 rows its ray enters closer than its best hit, in order; most rays
// enter none, a few pass 5 to 13 tiles. One thread a pixel (the commit
// before this design, PERF.md) made every warp run the union of its lanes'
// tiles; sorting a block's rays by the tiles they enter cut the rows 5.9x
// and the time 1.5%, because the few long rays then share a warp that
// walks their tiles in series while the block waits for it. On a scene
// whose rows are read from device memory (panda_arm: 2,090 tiles), about
// half of K4 is the tested tiles' rows, streamed from L2 at ~5.5 TB/s,
// ~4.9 KB a tile (PERF.md).
//
// The design (scripts/ablate_k4.py; the choices it was picked from are
// timed in PERF.md):
//  - a persistent grid, one block of 1,024 threads an SM (64 registers);
//    the compact hit table and the small tables staged into the block's
//    shared memory (stage_scene), or, for a scene whose tables exceed the
//    wrapper's budget, the rows read through the read-only path
//    (GlobalRows), chosen before the launch. On GlobalRows a warp query
//    reads each tested tile's rows from KernelScene.hit_tiles, the tiles'
//    compact rows field by field (passed in Args beside the run boxes),
//    so that the 32 lanes' load of one field of 32 consecutive rows is one
//    128-byte line; read from the 32-float rows of KernelScene.tri, one a
//    lane, it was 32 lines (1,216 sectors a tile, 96% of K4's time on
//    panda_arm, and K4 7.4x as long there, PERF.md). The base set's rows,
//    the lane queries' and the winner's surface stay on tri;
//  - each thread owns an item, its path in registers; once the item has
//    finished its quota the thread writes it out and takes the next from a
//    counter (scratch the wrapper zeroes), so every step is full;
//  - each step every owner writes its ray (origin, direction, departed
//    triangle) to shared memory and files it by whether its line enters a
//    tile's AABB: a warp query from the front of a list, a lane query from
//    its back. Warps take tasks from a counter: a warp query whole
//    (scan_warp: the base set's and each tile's 64 rows split over the 32
//    lanes, a reduction a tile, the tiles in order, each culled by the
//    bound so far, so its chain is 2 rows a tile), then the lane queries
//    32 at a time (scan_lane: the spheres and the base set, which is all a
//    ray that enters no tile tests). The winner (distance, row or sphere)
//    goes back to the owner's slot; each owner reads the winner's surface
//    (isect_surface) and shades;
//  - a level of boxes above the tiles, one a run of TILE_GROUP (32)
//    (KernelScene.tile_groups, read through __ldg, passed in Args and not
//    in FullScene, so the other kernels compile as before): the filing
//    tests a run's tiles only where the line enters its box
//    (enters_a_tile_grouped), and a warp query slab-tests the boxes 32 at a
//    time, then the tiles of each run whose box it enters closer than its
//    bound (scan_warp). On panda_arm (2,090 tiles, 66 runs) a ray's filing
//    falls from up to 2,090 slab tests to ~66 and a query's slab
//    iterations from 66 to ~3 and the runs it opens; the tiles whose rows
//    are tested, and so every result, are those of a flat scan of every
//    tile's box. A scene of one run (mesh, 13 tiles) pays one box test
//    more a ray;
//  - the row tests take K1's exact fast paths for the root and reciprocal
//    (FastOps).
//
// Counters (work, optional: four uint64 on the device that the caller
// owns and zeroes): work[0] the warp queries (segments whose line enters a
// tile), work[1] the tiles whose rows those queries tested (entered closer
// than the best hit so far), work[2] the runs of tiles whose slabs they
// tested (those whose box the line enters closer than the bound at the
// run's first tile), work[3] the sphere and bounding-sphere rows the
// scans tested. Each warp keeps its counts of work[0..2] in registers and
// adds them once, as it leaves: the plain version's work["query"],
// work["tiles"] and work["groups"]. Every scan, a warp's or a lane's,
// tests all n_sph + n_bnd rows (scan_spheres), so thread 0 adds a step's
// scans (its queries, warp and lane) times that trip count to a shared
// total, and adds the total once as the block leaves: the plain version's
// work["sph"], with no register added to a kernel at its 64.
//
// Random numbers: the counter generator keyed by (seed, pixel, sample,
// depth, slot), as in K1, or an injected per-item table uniforms[6, n].
// Every draw and output uses the item's index, never the thread's, and
// every scan gives isect_full's result, so an item computes the same on
// any thread and in either scan: built with --fmad=false it equals the
// plain version bit for bit.

#include "isect_full.cuh"
#include "k1_scan.cuh"

using namespace pt;

namespace {

constexpr int K4_THREADS = 1024;  // threads a block, one block an SM
constexpr unsigned FULL = 0xffffffffu;

using k1::FastOps;  // the row tests' root and reciprocal, exact

struct Args {
  Cam cam;
  const int* pixel_idx;
  int n;
  uint32_t seed;
  int sample_base, quota, max_depth, rr_start_depth;
  const float* uniforms;
  float* rad;
  int* segs;
  int* done;
  int* next;  // the refill counter, zero at launch
  const float* groups;  // [ceil(n_tiles / TILE_GROUP), 6] run boxes
  const float* hit_tiles;  // [n_tiles, HIT_F, TRI_TILE] (GlobalRows) or NULL
  unsigned long long* work;  // [queries, tiles, groups, spheres] or NULL
};

// An item's path, in its owner's registers
struct Path {
  int i;  // the item
  float px, py;
  uint32_t pkey, key;
  float o[3], d[3], thr[3], acc[3];
  float prev;
  bool alive;
  int depth, done, segs;
};

__device__ __forceinline__ void start_item(const Args& a, int i, Path& p) {
  p.i = i;
  const int pix = a.pixel_idx[i];
  pixel_xy(a.cam, pix, p.px, p.py);
  p.pkey = pixel_key(a.seed, pix);
  for (int k = 0; k < 3; ++k) p.acc[k] = 0.0f;
  p.alive = false;
  p.depth = p.done = p.segs = 0;
}

// A fresh camera ray for the item's next sample, if its path died
__device__ __forceinline__ void regenerate(const Args& a, Path& p) {
  if (p.alive) return;
  const int s = a.sample_base + p.done;
  p.key = mix32(p.pkey, static_cast<uint32_t>(s));
  p.depth = 0;
  camera_ray(a.cam, p.px, p.py, s, draw(a.uniforms, a.n, p.i, p.key, 0, 4),
             draw(a.uniforms, a.n, p.i, p.key, 0, 5), p.d);
  for (int k = 0; k < 3; ++k) {
    p.o[k] = a.cam.lc[k];
    p.thr[k] = 1.0f;
  }
  p.prev = -1.0f;
  p.alive = true;
}

// One segment's shading from its hit; returns whether the item finished
// its quota (its outputs are then written)
__device__ __forceinline__ bool finish_segment(const Args& a, const Hit& h,
                                               Path& p) {
  ++p.segs;
  const float u_rr = draw(a.uniforms, a.n, p.i, p.key, p.depth, 0);
  const float u1 = draw(a.uniforms, a.n, p.i, p.key, p.depth, 1);
  const float u2 = draw(a.uniforms, a.n, p.i, p.key, p.depth, 2);
  const float u_br = draw(a.uniforms, a.n, p.i, p.key, p.depth, 3);
  const int new_depth = p.depth + 1;
  bool alive_new = false;
  if (h.found) {
    float dn[3], thr_new[3];
    alive_new = shade(p.d, h.nrm, h.color, h.emis, h.rtype, p.thr, p.acc,
                      u_rr, u1, u2, u_br, new_depth, a.max_depth,
                      a.rr_start_depth, dn, thr_new);
    if (alive_new) {
      for (int k = 0; k < 3; ++k) {
        p.o[k] = h.point[k];
        p.d[k] = dn[k];
        p.thr[k] = thr_new[k];
      }
      p.prev = h.new_prev;
    }
  }
  p.depth = new_depth;
  if (alive_new) return false;
  p.alive = false;
  p.prev = -1.0f;  // as regenerate sets it: the old one is dead meanwhile
  if (++p.done < a.quota) return false;
  for (int k = 0; k < 3; ++k) a.rad[p.i * 3 + k] = p.acc[k];
  a.segs[p.i] = p.segs;
  a.done[p.i] = p.done;
  return true;
}

// The next item for a thread that has none: the first wave by thread, the
// rest from the counter, or none
__device__ __forceinline__ bool next_item(const Args& a, bool first,
                                          bool& more, Path& p) {
  const int wave = gridDim.x * K4_THREADS;
  if (first) {
    const int i = blockIdx.x * K4_THREADS + threadIdx.x;
    more = wave < a.n;
    if (i >= a.n) return false;
    start_item(a, i, p);
    return true;
  }
  if (!more) return false;
  const int i = wave + atomicAdd(a.next, 1);
  if (i >= a.n) {
    more = false;
    return false;
  }
  start_item(a, i, p);
  return true;
}

// Where a block's queries sit after its tables: per thread, (origin,
// departed triangle) and (direction, distance), the winner's code in place
// of the departed triangle once traced; then the step's list of owners,
// the warp queries from the front, the lane queries from the back.
struct QueryLayout {
  int q, owners, bytes;
};

__host__ __device__ inline QueryLayout query_layout(int table_bytes) {
  QueryLayout l;
  l.q = align16(table_bytes);
  l.owners = l.q + K4_THREADS * 32;
  l.bytes = align16(l.owners + K4_THREADS * 2);
  return l;
}

template <class R>
__global__ void __launch_bounds__(K4_THREADS, 1)
trace_regen_prim_kernel(const FullScene g, const Args a) {
  constexpr bool kShared = R::F == HIT_F;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t table_bar;
  __shared__ int n_warp[2], n_lane[2];  // a step's queries, by parity
  __shared__ int next_task;
  __shared__ unsigned long long sphere_rows;  // thread 0's, for work[3]
  const int tid = threadIdx.x, lane = tid & 31;
  FullScene sc = g;
  int table_bytes = 0;
  if constexpr (kShared) {
    sc = stage_scene(g, smem, &table_bar);
    table_bytes = scene_layout(g.n_tri, g.n_sph, g.n_bnd, g.n_tiles).bytes;
  }
  if (tid < 2) n_warp[tid] = n_lane[tid] = 0;
  if (tid == 0) sphere_rows = 0;
  __syncthreads();
  if constexpr (kShared) wait_bulk(&table_bar);
  const QueryLayout ql = query_layout(table_bytes);
  float4* q = reinterpret_cast<float4*>(smem + ql.q);  // 2 a thread
  uint16_t* owners = reinterpret_cast<uint16_t*>(smem + ql.owners);

  Path p;
  bool more = false;
  bool has = next_item(a, true, more, p);
  int parity = 0;
  // this warp's, the same in every lane
  unsigned queries = 0, tiles = 0, opened = 0;
  for (;;) {
    // ---- each owner: a new item if it has none, a fresh camera ray if its
    // path died, its query, filed ----
    if (!has) has = next_item(a, false, more, p);
    if (has) {
      regenerate(a, p);
      q[2 * tid] = make_float4(p.o[0], p.o[1], p.o[2], p.prev);
      q[2 * tid + 1] = make_float4(p.d[0], p.d[1], p.d[2], 0.0f);
      const uint16_t self = static_cast<uint16_t>(tid);
      if (enters_a_tile_grouped<R>(sc, a.groups, p.o, p.d))
        owners[atomicAdd(&n_warp[parity], 1)] = self;
      else
        owners[K4_THREADS - 1 - atomicAdd(&n_lane[parity], 1)] = self;
    }
    if (tid == 0) next_task = 0;
    __syncthreads();
    const int warp_q = n_warp[parity], lane_q = n_lane[parity];
    if (warp_q + lane_q == 0) break;  // block-uniform: no item is left
    if (tid == 0) {
      n_warp[parity ^ 1] = n_lane[parity ^ 1] = 0;  // read before
      sphere_rows += static_cast<unsigned long long>(warp_q + lane_q) *
                     static_cast<unsigned>(g.n_sph + g.n_bnd);
    }
    parity ^= 1;
    // ---- trace: warps take the warp queries one at a time, then the lane
    // queries 32 at a time ----
    const int tasks = warp_q + (lane_q + 31) / 32;
    for (;;) {
      int task = 0;
      if (lane == 0) task = atomicAdd(&next_task, 1);
      task = __shfl_sync(FULL, task, 0);
      if (task >= tasks) break;
      if (task < warp_q) {
        const int j = owners[task];
        const float4 op = q[2 * j], dr = q[2 * j + 1];
        const float o[3] = {op.x, op.y, op.z}, d[3] = {dr.x, dr.y, dr.z};
        int code;
        const float t = scan_warp<R, FastOps>(sc, a.groups, a.hit_tiles, o, d,
                                              op.w, lane, code, tiles, opened);
        ++queries;
        if (lane == 0) {
          q[2 * j].w = __int_as_float(code);
          q[2 * j + 1].w = t;
        }
      } else if (const int at = (task - warp_q) * 32 + lane; at < lane_q) {
        const int j = owners[K4_THREADS - 1 - at];
        const float4 op = q[2 * j], dr = q[2 * j + 1];
        const float o[3] = {op.x, op.y, op.z}, d[3] = {dr.x, dr.y, dr.z};
        int code;
        const float t = scan_lane<R, FastOps>(sc, o, d, op.w, code);
        q[2 * j].w = __int_as_float(code);
        q[2 * j + 1].w = t;
      }
    }
    __syncthreads();
    // ---- each owner: its winner's surface, shading ----
    if (has) {
      const float4 op = q[2 * tid], dr = q[2 * tid + 1];
      // the ray back from shared memory: its registers were free meanwhile
      p.o[0] = op.x, p.o[1] = op.y, p.o[2] = op.z;
      p.d[0] = dr.x, p.d[1] = dr.y, p.d[2] = dr.z;
      Hit h;
      isect_surface<R>(sc, p.o, p.d, dr.w, __float_as_int(op.w), h);
      if (finish_segment(a, h, p)) has = false;
    }
  }
  if (a.work != nullptr && lane == 0 && queries != 0) {
    atomicAdd(a.work, static_cast<unsigned long long>(queries));
    atomicAdd(a.work + 1, static_cast<unsigned long long>(tiles));
    atomicAdd(a.work + 2, static_cast<unsigned long long>(opened));
  }
  if (a.work != nullptr && tid == 0 && sphere_rows != 0)
    atomicAdd(a.work + 3, sphere_rows);
}

using Kernel = void (*)(const FullScene, const Args);

Kernel kernel_for(bool shared) {
  return shared ? trace_regen_prim_kernel<SharedRows>
                : trace_regen_prim_kernel<GlobalRows>;
}

// The launch configuration: out[0] the dynamic shared memory a block takes
// (bytes), out[1] resident blocks per SM, out[2] threads a block, out[3]
// SMs, out[4] registers a thread, out[5] local (spill) bytes a thread,
// out[6] the shared memory a block may opt in to (bytes), out[7] the static
// shared memory a block takes (bytes)
cudaError_t config(const FullScene& sc, bool shared, int* out) {
  const Kernel fn = kernel_for(shared);
  const int table =
      shared ? scene_layout(sc.n_tri, sc.n_sph, sc.n_bnd, sc.n_tiles).bytes
             : 0;
  const int smem = query_layout(table).bytes;
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, K4_THREADS,
                                                      smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  out[0] = smem;
  out[2] = K4_THREADS;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[7] = static_cast<int>(fa.sharedSizeBytes);
  return out[1] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// K4's launch configuration (config's out[0..7]) for a scene of these
// table sizes, shared 1 for the table in shared memory. Returns a CUDA
// error code (cudaErrorInvalidConfiguration: no block fits on an SM).
extern "C" int pt_trace_regen_prim_config(int n_sph, int n_bnd, int n_tri,
                                          int n_tiles, int shared, int* out) {
  const FullScene sc{nullptr, n_sph, nullptr, n_bnd, nullptr, n_tri,
                     nullptr, n_tiles, 0};
  return static_cast<int>(config(sc, shared != 0, out));
}

// Launch on `stream`; cam_host points to 14 host floats (CameraConsts.params).
// hit is KernelScene.hit ([n_tri, 20], 16-byte aligned), whose rows the scan
// reads from shared memory, or NULL for the read-only path. groups is
// KernelScene.tile_groups ([ceil(n_tiles / 32), 6]; NULL with no tile).
// hit_tiles is KernelScene.hit_tiles ([n_tiles, 20, 64]), whose rows the
// read-only path's warp queries test; NULL with no tile or with hit.
// uniforms is NULL for the counter generator. next: one int on the device,
// zero at launch. work: NULL, or four uint64 on the device that the
// launch adds its warp queries, their tested tiles, the runs of tiles
// they opened and the sphere rows its scans tested to. Returns
// cudaGetLastError().
extern "C" int pt_trace_regen_prim(
    const float* sph, int n_sph, const float* bnd, int n_bnd,
    const float* tri, int n_tri, const float* hit, const float* tiles,
    int n_tiles, int tile_base, const float* groups, const float* hit_tiles,
    const float* cam_host, int width, int height, const int* pixel_idx, int n,
    uint32_t seed, int sample_base, int quota, int max_depth,
    int rr_start_depth, const float* uniforms, float* rad, int* segs,
    int* done, int* next, unsigned long long* work, void* stream) {
  if (n <= 0) return 0;
  const FullScene sc{sph, n_sph, bnd, n_bnd, tri, n_tri, tiles, n_tiles,
                     tile_base, hit};
  const bool shared = hit != nullptr;
  if (!full_scene_ok(sc) || width <= 0 || quota < 0 || next == nullptr ||
      (shared && (reinterpret_cast<uintptr_t>(hit) & 15u)) ||
      (n_tiles > 0 &&
       (groups == nullptr || (!shared && hit_tiles == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quota == 0) {  // no segment: every item's outputs are zero
    cudaMemsetAsync(rad, 0, sizeof(float) * 3 * n, st);
    cudaMemsetAsync(segs, 0, sizeof(int) * n, st);
    cudaMemsetAsync(done, 0, sizeof(int) * n, st);
    return static_cast<int>(cudaGetLastError());
  }
  int cfg[8];
  const cudaError_t e = config(sc, shared, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{make_cam(cam_host, width, height), pixel_idx, n, seed,
               sample_base, quota, max_depth, rr_start_depth, uniforms, rad,
               segs, done, next, groups, hit_tiles, work};
  const int blocks = (n + K4_THREADS - 1) / K4_THREADS;
  const int grid = blocks < cfg[1] * cfg[3] ? blocks : cfg[1] * cfg[3];
  kernel_for(shared)<<<grid, K4_THREADS, cfg[0], st>>>(sc, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
