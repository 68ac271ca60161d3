// K5, K6 and K7: stepped path tracing of given rays, for Hopper (sm_90a).
//
// Replaces three TPU kernels. Two trace camera rays made outside the kernel,
// `steps` bounces per call, over a state that rides device memory between
// calls (the interactive preview's kernels; K9, trace_pallas_sorted, is K6
// with a sort of the rays in torch between calls):
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
// What one call computes: thread i owns ray i and runs up to n_steps
// bounces at segment depths depth0, depth0 + 1, ..: closest hit (K5 the
// baked scan of K1, K6 the full-scene intersector of K3 and K4), then
// Russian roulette, emission and BSDF sampling (common.cuh shade) with the
// unconditional max-depth cut. The ray's state rows (ops/kernels/
// trace_kernel.py ROW_*: origin, direction, throughput, radiance, alive,
// departed triangle) are read once into registers and written back once, so
// calls with steps < max_depth chain as the JAX calls do. counts[i] gains
// one for every step that ray i starts alive.
//
// The JAX kernel skips a block whose lanes are all dead (trace_kernel.py
// _make_kernel's all-dead block skip). Here a dead thread leaves its loop
// at once, which is that skip lane by lane. INVARIANT (as in the JAX
// kernel): a ray keeps the prev and thr it had at death; a step that ran
// over a dead lane would have reset prev to -1 and thr to 0. Dead rays
// never come back to life in a stepped trace, so nothing reads them, and
// comparisons of the state rows hold only for live rays.
//
// Random numbers: the counter generator keyed by (seed, pixel_idx[i],
// sample_idx[i], depth, slot 0-3), the draws K1 makes for the same sample,
// or an injected table uniforms[(depth * 4 + slot) * n + i] (the JAX
// layout [max_depth * 4, n]).
//
// What bounds it on this card: per-thread FP32 work and divergence, as for
// K1 and K4. A ray moves 14 state floats in and out per call and does
// hundreds of flops per segment; one thread per ray keeps the path in
// registers between its steps, K5 copies its scene into shared memory per
// block (every lane of a warp reads the same primitive: a broadcast), and
// K6 reads its tables through the read-only cache and culls tiles per lane.
// Built with --fmad=false both equal their plain versions bit for bit.

#include "isect_full.cuh"

using namespace pt;

namespace {

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

__global__ void __launch_bounds__(THREADS)
trace_stepped_static_kernel(const float* __restrict__ prims_g, int n_prims,
                            const float* __restrict__ gates_g, int n_gates,
                            const int* __restrict__ pixel_idx,
                            const int* __restrict__ sample_idx, int n,
                            uint32_t seed, int depth0, int n_steps,
                            int max_depth, int rr_start_depth,
                            const float* __restrict__ uniforms,
                            float* __restrict__ state,
                            int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* prims = smem;
  float* gates = smem + n_prims * PRIM_F;
  for (int k = threadIdx.x; k < n_prims * PRIM_F; k += blockDim.x)
    prims[k] = prims_g[k];
  for (int k = threadIdx.x; k < n_gates * GATE_F; k += blockDim.x)
    gates[k] = gates_g[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(state, n, i);
  if (!r.alive) return;  // dead: nothing to trace and nothing to write
  const uint32_t key = mix32(pixel_key(seed, pixel_idx[i]),
                             static_cast<uint32_t>(sample_idx[i]));
  int steps = 0;
  for (int s = 0; s < n_steps && r.alive; ++s) {
    ++steps;
    const int depth = depth0 + s;
    float u[4];
    for (int k = 0; k < 4; ++k)
      u[k] = step_uniform(uniforms, n, i, key, depth, k);
    float tmin;
    const int best = prim_scan(prims, n_prims, gates, r.o, r.d,
                               static_cast<int>(r.prev), tmin);
    float point[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f};
    const float* row = prims + (best >= 0 ? best : 0) * PRIM_F;
    if (best >= 0) prim_surface(row, r.o, r.d, tmin, point, nrm);
    bounce(r, best >= 0, point, nrm, row + COL_COLOR, row + COL_EMIS,
           row[COL_RTYPE], best >= 0 ? row[COL_PREVID] : -1.0f, u, depth + 1,
           max_depth, rr_start_depth);
  }
  store_ray(state, n, i, r);
  counts[i] += steps;
}

__global__ void __launch_bounds__(THREADS)
trace_stepped_prim_kernel(FullScene sc, const int* __restrict__ pixel_idx,
                          const int* __restrict__ sample_idx, int n,
                          uint32_t seed, int depth0, int n_steps,
                          int max_depth, int rr_start_depth,
                          const float* __restrict__ uniforms,
                          float* __restrict__ state,
                          int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(state, n, i);
  if (!r.alive) return;
  const uint32_t key = mix32(pixel_key(seed, pixel_idx[i]),
                             static_cast<uint32_t>(sample_idx[i]));
  int steps = 0;
  for (int s = 0; s < n_steps && r.alive; ++s) {
    ++steps;
    const int depth = depth0 + s;
    float u[4];
    for (int k = 0; k < 4; ++k)
      u[k] = step_uniform(uniforms, n, i, key, depth, k);
    Hit h;
    isect_full(sc, r.o, r.d, r.prev, true, h);
    bounce(r, h.found, h.point, h.nrm, h.color, h.emis, h.rtype, h.new_prev,
           u, depth + 1, max_depth, rr_start_depth);
  }
  store_ray(state, n, i, r);
  counts[i] += steps;
}

// K7: one bounce at each ray's own depth. `in` and `out` are [16, n]: the
// state rows, the depth row (bounces completed, exact in float32) and, in
// `out`, the count row (1 where the ray was alive on entry). A dead ray is
// cleaned as the JAX kernel's step cleans a dead lane of a live block: thr
// 0, prev -1; its other rows pass through.
__global__ void __launch_bounds__(THREADS)
trace_resolve_kernel(FullScene sc, const float* __restrict__ in,
                     float* __restrict__ out,
                     const int* __restrict__ pixel_idx,
                     const int* __restrict__ sample_idx, int n, uint32_t seed,
                     int max_depth, int rr_start_depth,
                     const float* __restrict__ uniforms) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(in, n, i);
  const float alive_f = in[ROW_ALIVE * n + i];
  const float depth = in[ROW_DEPTH * n + i];
  if (r.alive) {
    const uint32_t key = mix32(pixel_key(seed, pixel_idx[i]),
                               static_cast<uint32_t>(sample_idx[i]));
    const int dep = static_cast<int>(depth);
    float u[4];
    for (int k = 0; k < 4; ++k) u[k] = draw(uniforms, n, i, key, dep, k);
    Hit h;
    isect_full(sc, r.o, r.d, r.prev, true, h);
    bounce(r, h.found, h.point, h.nrm, h.color, h.emis, h.rtype, h.new_prev,
           u, static_cast<int>(depth + 1.0f), max_depth, rr_start_depth);
  } else {
    for (int k = 0; k < 3; ++k) r.thr[k] = 0.0f;
    r.prev = -1.0f;
  }
  store_ray(out, n, i, r);
  // the JAX kernel adds the alive row itself (1.0 or 0.0)
  out[ROW_DEPTH * n + i] = depth + alive_f;
  out[ROW_COUNT * n + i] = alive_f;
}

bool stepped_args_ok(int n, int depth0, int n_steps, int max_depth) {
  return n > 0 && depth0 >= 0 && n_steps > 0 && max_depth > 0;
}

}  // namespace

// K5 on `stream`: one call of n_steps bounces over the state [14, n]
// (updated in place) and counts [n] (added to). uniforms is NULL for the
// counter generator, else the whole [max_depth * 4, n] table. Returns
// cudaGetLastError() after the launch.
extern "C" int pt_trace_stepped_static(
    const float* prims, int n_prims, const float* gates, int n_gates,
    const int* pixel_idx, const int* sample_idx, int n, uint32_t seed,
    int depth0, int n_steps, int max_depth, int rr_start_depth,
    const float* uniforms, float* state, int* counts, void* stream) {
  if (n <= 0) return 0;
  if (!stepped_args_ok(n, depth0, n_steps, max_depth) || n_prims <= 0 ||
      n_prims > MAX_PRIMS || n_gates < 0 || n_gates > MAX_PRIMS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(n_prims * PRIM_F + n_gates * GATE_F) * sizeof(float);
  const int blocks = (n + THREADS - 1) / THREADS;
  trace_stepped_static_kernel<<<blocks, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      prims, n_prims, gates, n_gates, pixel_idx, sample_idx, n, seed, depth0,
      n_steps, max_depth, rr_start_depth, uniforms, state, counts);
  return static_cast<int>(cudaGetLastError());
}

// K6 on `stream`: as pt_trace_stepped_static over the table-driven scene.
extern "C" int pt_trace_stepped_prim(
    const float* sph, int n_sph, const float* bnd, int n_bnd,
    const float* tri, int n_tri, const float* tiles, int n_tiles,
    int tile_base, const int* pixel_idx, const int* sample_idx, int n,
    uint32_t seed, int depth0, int n_steps, int max_depth, int rr_start_depth,
    const float* uniforms, float* state, int* counts, void* stream) {
  if (n <= 0) return 0;
  const FullScene sc{sph, n_sph, bnd, n_bnd, tri, n_tri, tiles, n_tiles,
                     tile_base};
  if (!stepped_args_ok(n, depth0, n_steps, max_depth) || !full_scene_ok(sc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + THREADS - 1) / THREADS;
  trace_stepped_prim_kernel<<<blocks, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sc, pixel_idx, sample_idx, n, seed, depth0, n_steps, max_depth,
      rr_start_depth, uniforms, state, counts);
  return static_cast<int>(cudaGetLastError());
}

// K7 on `stream`: one bounce of every ray of `in` [16, n] at its own depth
// into `out` [16, n] (distinct buffers). uniforms is NULL for the counter
// generator, else [4, n].
extern "C" int pt_trace_resolve(
    const float* sph, int n_sph, const float* bnd, int n_bnd,
    const float* tri, int n_tri, const float* tiles, int n_tiles,
    int tile_base, const float* in, float* out, const int* pixel_idx,
    const int* sample_idx, int n, uint32_t seed, int max_depth,
    int rr_start_depth, const float* uniforms, void* stream) {
  if (n <= 0) return 0;
  const FullScene sc{sph, n_sph, bnd, n_bnd, tri, n_tri, tiles, n_tiles,
                     tile_base};
  if (!full_scene_ok(sc) || max_depth <= 0 || in == out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + THREADS - 1) / THREADS;
  trace_resolve_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      sc, in, out, pixel_idx, sample_idx, n, seed, max_depth, rr_start_depth,
      uniforms);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
