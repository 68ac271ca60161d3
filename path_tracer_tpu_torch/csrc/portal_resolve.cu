// K3: the portal scheduler's pool resolve for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas/portal.py:
// trace_pallas_resolve_pool (kernel body _make_kernel_resolve_pool). The
// plain torch version of this file is path_tracer_tpu_torch/ops/kernels/
// portal.py:trace_resolve_pool_plain.
//
// What it computes: one full-scene bounce (isect_full.cuh, the intersector
// K4 uses too) for the active path and the frozen paths of the first
// parts-1 park buffers of each pool column, with the bookkeeping in the
// kernel: part 0 bumps done where its path ended; part j >= 1 bounces only a
// frozen buffer (BUF_STATE 1) with a zero acc, adds that acc to the slot's
// acc, bumps done where the path ended and sets BUF_STATE to 2 (ready) or 0.
// Empty and ready buffers pass through.
//
// Design: one thread per pool column, looping over the parts in order. The
// JAX kernel runs a grid of (column block, part) with the part fastest and
// read-modify-writes the slot's acc and done rows across parts; here the
// loop is inside the thread, so those rows are plain registers and need no
// atomics, and the sum order is the JAX kernel's part order. A dead active
// path is not traced; its scratch is cleaned (thr 0, prev -1) as the JAX
// bounce does in any block with a live lane.
//
// What bounds it on this card: the full-scene intersector's FP32 work for
// each live part (the base set plus the Morton tiles the ray can enter
// closer than its best hit), and divergence between lanes with different
// numbers of live parts and candidate tiles. Each column is read once and
// written once, coalesced across the warp.
//
// Random numbers: the counter generator keyed by (seed, pixel, the part's
// own sample row, depth, slot), or injected uniforms[4, parts*n] in the
// JAX package's part-major layout. Built with --fmad=false it equals the
// plain version bit for bit.

#include "isect_full.cuh"

using namespace pt;

namespace {

// pool rows: ops/kernels/portal.py
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13, ROW_DEPTH = 14, V2_ROW_DONE = 15, V2_ROW_PIX = 16,
              V2_ROWS = 18, V3_BUF_BASE = 19, BUF_O = 0, BUF_D = 3,
              BUF_THR = 6, BUF_PREV = 9, BUF_DEPTH = 10, BUF_STATE = 11,
              BUF_ROWS = 12, MAX_PARK_K = 3;

// One bounce of a live path. Returns whether it lives on; o, d, thr, acc,
// prev and depth are updated in place.
__device__ __forceinline__ bool bounce(const FullScene& sc, float o[3],
                                       float d[3], float thr[3], float acc[3],
                                       float& prev, float& depth,
                                       const float u[4], int max_depth,
                                       int rr_start_depth) {
  Hit h;
  isect_full(sc, o, d, prev, true, h);
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

__global__ void __launch_bounds__(THREADS)
resolve_pool_kernel(FullScene sc, const float* __restrict__ in,
                    float* __restrict__ out, int n, int rows, int park_k,
                    int parts, uint32_t seed, int max_depth,
                    int rr_start_depth, const float* __restrict__ uniforms,
                    int* __restrict__ counts_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = static_cast<size_t>(n);
  auto at = [&](int r) { return in[r * N + i]; };
  auto put = [&](int r, float v) { out[r * N + i] = v; };
  const int jax_rows = park_k ? V3_BUF_BASE + park_k * BUF_ROWS : V2_ROWS;
  const uint32_t pkey = pixel_key(seed, static_cast<int>(at(V2_ROW_PIX)));
  const size_t u_stride = static_cast<size_t>(parts) * N;

  auto uniforms4 = [&](int part, float sample, float depth, float u[4]) {
    const uint32_t key =
        mix32(pkey, static_cast<uint32_t>(static_cast<int>(sample)));
    for (int k = 0; k < 4; ++k)
      u[k] = uniforms != nullptr
                 ? uniforms[k * u_stride + static_cast<size_t>(part) * N + i]
                 : draw(nullptr, 0, 0, key, static_cast<int>(depth), k);
  };

  for (int r = 0; r < rows; ++r) put(r, at(r));  // rows no part writes

  // part 0: the active path
  float o[3], d[3], thr[3], acc[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = at(ROW_O + k);
    d[k] = at(ROW_D + k);
    thr[k] = at(ROW_THR + k);
    acc[k] = at(ROW_ACC + k);
  }
  float prev = at(ROW_PREV), depth = at(ROW_DEPTH);
  float done = at(V2_ROW_DONE);
  int counts = 0;
  bool alive = false;
  if (at(ROW_ALIVE) > 0.0f) {
    float u[4];
    uniforms4(0, at(jax_rows), depth, u);
    alive = bounce(sc, o, d, thr, acc, prev, depth, u, max_depth,
                   rr_start_depth);
    counts += 1;
    if (!alive) done += 1.0f;
  } else {
    for (int k = 0; k < 3; ++k) thr[k] = 0.0f;
    prev = -1.0f;
  }
  for (int k = 0; k < 3; ++k) {
    put(ROW_O + k, o[k]);
    put(ROW_D + k, d[k]);
    put(ROW_THR + k, thr[k]);
  }
  put(ROW_ALIVE, alive ? 1.0f : 0.0f);
  put(ROW_PREV, prev);
  put(ROW_DEPTH, depth);

  // parts 1..: frozen parked paths, acc summed into the slot in part order
  for (int j = 1; j < parts; ++j) {
    const int b = V3_BUF_BASE + (j - 1) * BUF_ROWS;
    const float ps = at(b + BUF_STATE);
    if (!(ps > 0.5f && ps < 1.5f)) continue;
    float bo[3], bd[3], bthr[3], bacc[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) {
      bo[k] = at(b + BUF_O + k);
      bd[k] = at(b + BUF_D + k);
      bthr[k] = at(b + BUF_THR + k);
    }
    float bprev = at(b + BUF_PREV), bdepth = at(b + BUF_DEPTH);
    float u[4];
    uniforms4(j, at(jax_rows + j), bdepth, u);
    const bool balive = bounce(sc, bo, bd, bthr, bacc, bprev, bdepth, u,
                               max_depth, rr_start_depth);
    counts += 1;
    for (int k = 0; k < 3; ++k) {
      put(b + BUF_O + k, bo[k]);
      put(b + BUF_D + k, bd[k]);
      put(b + BUF_THR + k, bthr[k]);
      acc[k] = acc[k] + bacc[k];
    }
    put(b + BUF_PREV, bprev);
    put(b + BUF_DEPTH, bdepth);
    put(b + BUF_STATE, balive ? 2.0f : 0.0f);
    if (!balive) done += 1.0f;
  }
  for (int k = 0; k < 3; ++k) put(ROW_ACC + k, acc[k]);
  put(V2_ROW_DONE, done);
  counts_out[i] = counts;
}

}  // namespace

// Launch on `stream`. pool_in and pool_out are distinct [rows, n] float32
// matrices in the port's layout for park_k; parts - 1 <= park_k buffers are
// resolved. uniforms is NULL for the counter generator, else [4, parts*n].
// Returns cudaGetLastError().
extern "C" int pt_resolve_pool(const float* sph, int n_sph, const float* bnd,
                               int n_bnd, const float* tri, int n_tri,
                               const float* tiles, int n_tiles, int tile_base,
                               const float* pool_in, float* pool_out, int n,
                               int park_k, int parts, uint32_t seed,
                               int max_depth, int rr_start_depth,
                               const float* uniforms, int* counts,
                               void* stream) {
  if (n <= 0) return 0;
  const FullScene sc{sph, n_sph, bnd, n_bnd, tri, n_tri, tiles, n_tiles,
                     tile_base};
  if (!full_scene_ok(sc) || park_k < 0 || park_k > MAX_PARK_K || parts < 1 ||
      parts > park_k + 1 || pool_in == pool_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows =
      (park_k ? V3_BUF_BASE + park_k * BUF_ROWS : V2_ROWS) + 1 + park_k;
  const int blocks = (n + THREADS - 1) / THREADS;
  resolve_pool_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      sc, pool_in, pool_out, n, rows, park_k, parts, seed, max_depth,
      rr_start_depth, uniforms, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
