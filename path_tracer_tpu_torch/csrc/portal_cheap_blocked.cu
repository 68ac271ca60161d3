// K8: the v1 portal scheduler's cheap kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas/portal.py:
// trace_cheap_blocked (kernel body _make_kernel_cheap). The plain torch
// version of this file is path_tracer_tpu_torch/ops/kernels/portal.py:
// trace_cheap_blocked_plain.
//
// What it computes: one thread per lane of the v1 pool [17, n] (the JAX
// package's 16 rows and the port's sample row). Up to max_depth steps, each
// lane advances its path through the cheap scene (everything but the heavy
// mesh: at most 128 baked primitives, K1's scan). A segment whose ray could
// reach the heavy mesh's padded AABB no further than its cheap hit freezes
// (ties freeze) and keeps its state; a processed segment is shaded and
// counted, and depth grows by one. The pix and sample rows pass through.
//
// The freeze depends on the block, as in the JAX kernel: a step runs its
// body only if some lane of the block is alive and its ray misses the AABB
// (the slab test alone, without the tie test against the cheap hit). So a
// lane whose slab is hit beyond its cheap hit stops early when no lane of
// its block may run. One CUDA block is one such group of lanes: the vote is
// __syncthreads_or once a step, every thread (those past n too) stays in
// the loop until the vote is 0, and then the whole block leaves it. The
// group is the block size, not the JAX kernel's 2048 lanes; a lane that
// stops earlier here is resolved by K7 against the full scene, whose
// closest hit is the same cheap hit, and its draws are keyed by depth, so
// the image does not change.
//
// What bounds it on this card: per-thread FP32 work (the slab test, the scan
// of a few cheap primitives, shading) and the block's longest runnable lane.
// The pool column is read once and written once (coalesced: thread i
// touches element i of each row); the path lives in registers and the
// cheap scene in shared memory, as in K1 and K2.
//
// Random numbers: the counter generator keyed by (seed, pixel, the path's
// sample row, depth, slot), or an injected per-lane table uniforms[4, n]
// used at every step. Built with --fmad=false it equals the plain version
// bit for bit.

#include "common.cuh"

using namespace pt;

namespace {

// v1 pool rows: ops/kernels/portal.py ROW_* and V1_ROW_SAMPLE
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13, ROW_DEPTH = 14, ROW_PIX = 15, ROW_SAMPLE = 16;

struct Box {
  float lo[3], hi[3];
};

__global__ void cheap_blocked_kernel(const float* __restrict__ prims_g,
                                     int n_prims,
                                     const float* __restrict__ gates_g,
                                     int n_gates, Box box,
                                     const float* __restrict__ in,
                                     float* __restrict__ out, int n,
                                     uint32_t seed, int max_depth,
                                     int rr_start_depth,
                                     const float* __restrict__ uniforms,
                                     int* __restrict__ counts_out) {
  extern __shared__ float smem[];
  float* prims = smem;
  float* gates = smem + n_prims * PRIM_F;
  for (int k = threadIdx.x; k < n_prims * PRIM_F; k += blockDim.x)
    prims[k] = prims_g[k];
  for (int k = threadIdx.x; k < n_gates * GATE_F; k += blockDim.x)
    gates[k] = gates_g[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < n;  // threads past n only vote
  const size_t N = static_cast<size_t>(n);
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
  float thr[3] = {0.0f, 0.0f, 0.0f}, acc[3] = {0.0f, 0.0f, 0.0f};
  float alive = 0.0f, prev = -1.0f, depth = 0.0f, pix = -1.0f, sample = 0.0f;
  if (lane) {
    for (int k = 0; k < 3; ++k) {
      o[k] = in[(ROW_O + k) * N + i];
      d[k] = in[(ROW_D + k) * N + i];
      thr[k] = in[(ROW_THR + k) * N + i];
      acc[k] = in[(ROW_ACC + k) * N + i];
    }
    alive = in[ROW_ALIVE * N + i];
    prev = in[ROW_PREV * N + i];
    depth = in[ROW_DEPTH * N + i];
    pix = in[ROW_PIX * N + i];
    sample = in[ROW_SAMPLE * N + i];
  }
  const uint32_t key = mix32(pixel_key(seed, static_cast<int>(pix)),
                             static_cast<uint32_t>(static_cast<int>(sample)));
  int counts = 0;

  for (int step = 0; step < max_depth; ++step) {
    const bool live = alive > 0.0f;
    // the portal: padded AABB slab test of the heavy mesh
    float t_en = 0.0f, t_ex = BIG;
    for (int k = 0; k < 3; ++k) {
      const float inv = 1.0f / (fabsf(d[k]) < TINY ? TINY : d[k]);
      const float ta = (box.lo[k] - o[k]) * inv;
      const float tb = (box.hi[k] - o[k]) * inv;
      t_en = fmaxf(t_en, fminf(ta, tb));
      t_ex = fminf(t_ex, fmaxf(ta, tb));
    }
    const bool hit_box = t_ex >= t_en && t_ex > 0.0f && live;
    // the block's vote: does any lane run free of the portal?
    if (!__syncthreads_or(live && !hit_box)) break;

    float tmin = BIG;  // a dead lane scans nothing: it is only cleaned
    const int best = live ? prim_scan(prims, n_prims, gates, o, d,
                                      static_cast<int>(prev), tmin)
                          : -1;
    const bool needs = hit_box && t_en <= tmin;  // ties freeze
    const bool proc = live && !needs;
    counts += proc ? 1 : 0;

    const bool found = best >= 0 && proc;
    bool alive_new = false;
    float point[3], dn[3], thr_new[3];
    float new_prev = -1.0f;
    if (found) {
      const int dep = static_cast<int>(depth);
      const float* r = prims + best * PRIM_F;
      float nrm[3];
      prim_surface(r, o, d, tmin, point, nrm);
      alive_new = shade(d, nrm, r + COL_COLOR, r + COL_EMIS, r[COL_RTYPE],
                        thr, acc, draw(uniforms, n, i, key, dep, 0),
                        draw(uniforms, n, i, key, dep, 1),
                        draw(uniforms, n, i, key, dep, 2),
                        draw(uniforms, n, i, key, dep, 3),
                        static_cast<int>(depth + 1.0f), max_depth,
                        rr_start_depth, dn, thr_new);
      new_prev = r[COL_PREVID];
    }
    if (alive_new) {
      for (int k = 0; k < 3; ++k) {
        o[k] = point[k];
        d[k] = dn[k];
      }
    }
    if (!needs) {  // a frozen path keeps its state; a dead one is cleaned
      for (int k = 0; k < 3; ++k) thr[k] = alive_new ? thr_new[k] : 0.0f;
      prev = new_prev;
      alive = alive_new ? 1.0f : 0.0f;
    }
    if (proc) depth += 1.0f;
  }

  if (!lane) return;
  for (int k = 0; k < 3; ++k) {
    out[(ROW_O + k) * N + i] = o[k];
    out[(ROW_D + k) * N + i] = d[k];
    out[(ROW_THR + k) * N + i] = thr[k];
    out[(ROW_ACC + k) * N + i] = acc[k];
  }
  out[ROW_ALIVE * N + i] = alive;
  out[ROW_PREV * N + i] = prev;
  out[ROW_DEPTH * N + i] = depth;
  out[ROW_PIX * N + i] = pix;
  out[ROW_SAMPLE * N + i] = sample;
  counts_out[i] = counts;
}

}  // namespace

// Launch on `stream` with `group` threads a block (the lanes that vote
// together; a multiple of 32, at most 1024). aabb_host: 6 host floats (lo,
// hi). pool_in and pool_out are distinct [17, n] float32 matrices. uniforms
// is NULL for the counter generator, else [4, n]. Returns
// cudaGetLastError().
extern "C" int pt_cheap_blocked(const float* prims, int n_prims,
                                const float* gates, int n_gates,
                                const float* aabb_host, const float* pool_in,
                                float* pool_out, int n, int group,
                                uint32_t seed, int max_depth,
                                int rr_start_depth, const float* uniforms,
                                int* counts, void* stream) {
  if (n <= 0) return 0;
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_gates < 0 ||
      n_gates > MAX_PRIMS || group < 32 || group > 1024 || group % 32 ||
      max_depth < 0 || pool_in == pool_out)
    return static_cast<int>(cudaErrorInvalidValue);
  Box box;
  for (int k = 0; k < 3; ++k) {
    box.lo[k] = aabb_host[k];
    box.hi[k] = aabb_host[3 + k];
  }
  const size_t smem =
      static_cast<size_t>(n_prims * PRIM_F + n_gates * GATE_F) * sizeof(float);
  const int blocks = (n + group - 1) / group;
  cheap_blocked_kernel<<<blocks, group, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      prims, n_prims, gates, n_gates, box, pool_in, pool_out, n, seed,
      max_depth, rr_start_depth, uniforms, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
