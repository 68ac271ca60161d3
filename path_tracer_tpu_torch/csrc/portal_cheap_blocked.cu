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
// mesh: at most 128 baked primitives). A segment whose ray could reach the
// heavy mesh's padded AABB no further than its cheap hit freezes (ties
// freeze) and keeps its state; a processed segment is shaded and counted,
// and depth grows by one. The pix and sample rows pass through.
//
// The freeze depends on the group of lanes, as in the JAX kernel: a step
// runs its body only if some lane of the group is alive and its ray misses
// the AABB (the slab test alone, without the tie test against the cheap
// hit). So a lane whose slab is hit beyond its cheap hit stops early when no
// lane of its group may run; K7 then resolves it against the full scene,
// whose closest hit is the same cheap hit, under the same depth-keyed draws,
// so the image does not change. A group is `group` consecutive lanes (the
// JAX kernel's block is 2048): a warp voting with __any_sync for 32, else a
// block of `group` threads voting with __syncthreads_or; every thread (those
// past n too) stays in the loop until the vote is 0, and then the whole
// group leaves it.
//
// What bounds it on this card: per-thread FP32 work (the slab test, the scan
// of a few cheap primitives, shading) and a group's longest runnable lane.
// The pool column is read once and written once (coalesced: thread i
// touches element i of each row); the path lives in registers. The design:
//  - the cheap scene scanned as K1 scans it (k1_scan.cuh scan_split: the
//    split table, spheres then triangles and quads with no kind test, the
//    exact fast root and reciprocal; the hit row read from the hit table),
//    staged into shared memory;
//  - the slab test's reciprocal by the exact fast path with no range check
//    (rcp_in_range: a direction's |component| is at most 1, and TINY keeps
//    it at 1e-30 or more);
//  - a persistent grid: the resident blocks stage the cheap scene once
//    each and take groups from a counter (scratch the wrapper zeroes) until
//    none is left, where the parent launched a block a group;
//  - the port's group (portal.BLOCKED_GROUP) is 32, a warp, whose vote
//    takes no barrier.
// Measured (scripts/ablate_k8.py, PERF.md): 0.41 -> 0.34 ms on a fresh
// 1,048,576-lane mesh pool; the group changes neither the v1 render's
// cycles nor its image, 128 costs 3%; ptxas gives the warp's kernel 77
// registers for one block an SM, and asking it for 12 or 16 blocks (42, 32
// registers) is slower. A lane runs ~10 steps, and a group runs until its
// last free lane stops.
//
// Random numbers: the counter generator keyed by (seed, pixel, the path's
// sample row, depth, slot), or an injected per-lane table uniforms[4, n]
// used at every step. Built with --fmad=false it equals the plain version
// bit for bit.

#include "k1_scan.cuh"

using namespace pt;

namespace {

// v1 pool rows: ops/kernels/portal.py ROW_* and V1_ROW_SAMPLE
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13, ROW_DEPTH = 14, ROW_PIX = 15, ROW_SAMPLE = 16;
constexpr int WARP_BLOCK = 128;  // threads a block when a warp is a group
constexpr unsigned FULL = 0xffffffffu;

struct Box {
  float lo[3], hi[3];
};

struct Args {
  const float* gates;
  int n_gates;
  const float* hit;    // SceneConsts.hit [n_prims, 13]
  const float* split;  // SceneConsts.split [n_prims, 20], n_sph spheres first
  int n_sph, n_prims, rcp_safe;
  Box box;
  const float* in;
  float* out;
  int n, group;
  uint32_t seed;
  int max_depth, rr_start_depth;
  const float* uniforms;
  int* counts;
  int* next;  // the group counter, zero at launch
};

// Dynamic shared memory a block takes (floats): the split table (first, so
// that its rows are 16-byte aligned), the gates, the hit table
inline int smem_floats(int n_prims, int n_gates) {
  return n_prims * k1::SPLIT_F + n_gates * GATE_F + n_prims * k1::HIT_F;
}

// Lane i (threads past n only vote) through its group's steps
template <bool kWarp>
__device__ __forceinline__ void run_lane(const Args& a, const float* split,
                                         const float* gates,
                                         const float* hits, int i) {
  const bool lane = i < a.n;
  const size_t N = static_cast<size_t>(a.n);
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
  float thr[3] = {0.0f, 0.0f, 0.0f}, acc[3] = {0.0f, 0.0f, 0.0f};
  float alive = 0.0f, prev = -1.0f, depth = 0.0f, pix = -1.0f, sample = 0.0f;
  if (lane) {
    for (int k = 0; k < 3; ++k) {
      o[k] = a.in[(ROW_O + k) * N + i];
      d[k] = a.in[(ROW_D + k) * N + i];
      thr[k] = a.in[(ROW_THR + k) * N + i];
      acc[k] = a.in[(ROW_ACC + k) * N + i];
    }
    alive = a.in[ROW_ALIVE * N + i];
    prev = a.in[ROW_PREV * N + i];
    depth = a.in[ROW_DEPTH * N + i];
    pix = a.in[ROW_PIX * N + i];
    sample = a.in[ROW_SAMPLE * N + i];
  }
  const uint32_t key = mix32(pixel_key(a.seed, static_cast<int>(pix)),
                             static_cast<uint32_t>(static_cast<int>(sample)));
  int counts = 0;

  for (int step = 0; step < a.max_depth; ++step) {
    const bool live = alive > 0.0f;
    // the portal: padded AABB slab test of the heavy mesh
    float t_en = 0.0f, t_ex = BIG;
    for (int k = 0; k < 3; ++k) {
      const float inv = k1::rcp_in_range(fabsf(d[k]) < TINY ? TINY : d[k]);
      const float ta = (a.box.lo[k] - o[k]) * inv;
      const float tb = (a.box.hi[k] - o[k]) * inv;
      t_en = fmaxf(t_en, fminf(ta, tb));
      t_ex = fminf(t_ex, fmaxf(ta, tb));
    }
    const bool hit_box = t_ex >= t_en && t_ex > 0.0f && live;
    // the group's vote: does any lane run free of the portal?
    const bool free_lane = live && !hit_box;
    if (kWarp ? !__any_sync(FULL, free_lane) : !__syncthreads_or(free_lane))
      break;

    float tmin = BIG;  // a dead lane scans nothing: it is only cleaned
    int best = -1;
    if (live)
      best = a.rcp_safe ? k1::scan_split<true>(split, a.n_sph, a.n_prims,
                                               gates, o, d, prev, tmin)
                        : k1::scan_split<false>(split, a.n_sph, a.n_prims,
                                                gates, o, d, prev, tmin);
    const bool needs = hit_box && t_en <= tmin;  // ties freeze
    const bool proc = live && !needs;
    counts += proc ? 1 : 0;

    bool alive_new = false;
    float point[3], dn[3], thr_new[3];
    float new_prev = -1.0f;
    if (best >= 0 && proc) {
      const int dep = static_cast<int>(depth);
      const float* h = hits + best * k1::HIT_F;
      float nrm[3];
      k1::hit_surface(h, o, d, tmin, point, nrm);
      alive_new = shade(d, nrm, h + k1::H_COLOR, h + k1::H_EMIS,
                        h[k1::H_RTYPE], thr, acc,
                        draw(a.uniforms, a.n, i, key, dep, 0),
                        draw(a.uniforms, a.n, i, key, dep, 1),
                        draw(a.uniforms, a.n, i, key, dep, 2),
                        draw(a.uniforms, a.n, i, key, dep, 3),
                        static_cast<int>(depth + 1.0f), a.max_depth,
                        a.rr_start_depth, dn, thr_new);
      new_prev = h[k1::H_PREVID];
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
    a.out[(ROW_O + k) * N + i] = o[k];
    a.out[(ROW_D + k) * N + i] = d[k];
    a.out[(ROW_THR + k) * N + i] = thr[k];
    a.out[(ROW_ACC + k) * N + i] = acc[k];
  }
  a.out[ROW_ALIVE * N + i] = alive;
  a.out[ROW_PREV * N + i] = prev;
  a.out[ROW_DEPTH * N + i] = depth;
  a.out[ROW_PIX * N + i] = pix;
  a.out[ROW_SAMPLE * N + i] = sample;
  a.counts[i] = counts;
}

// The persistent grid: each block stages the cheap scene once, then its
// groups (a warp each under kWarp, else the whole block) take the groups of
// lanes in turn, the first by position, the rest from the counter.
template <bool kWarp>
__global__ void __launch_bounds__(kWarp ? WARP_BLOCK : 1024, 1)
cheap_blocked_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* split = reinterpret_cast<float*>(smem4);
  float* gates = split + a.n_prims * k1::SPLIT_F;
  float* hits = gates + a.n_gates * GATE_F;
  __shared__ int next_group;
  for (int k = threadIdx.x; k < a.n_prims * k1::SPLIT_F; k += blockDim.x)
    split[k] = a.split[k];
  for (int k = threadIdx.x; k < a.n_gates * GATE_F; k += blockDim.x)
    gates[k] = a.gates[k];
  for (int k = threadIdx.x; k < a.n_prims * k1::HIT_F; k += blockDim.x)
    hits[k] = a.hit[k];
  __syncthreads();

  const int per_block = kWarp ? blockDim.x / 32 : 1;  // groups at once
  const int slot = kWarp ? threadIdx.x & 31 : threadIdx.x;
  const int wave = gridDim.x * per_block;
  const int n_groups = (a.n + a.group - 1) / a.group;
  int g = blockIdx.x * per_block + (kWarp ? threadIdx.x >> 5 : 0);
  while (g < n_groups) {
    run_lane<kWarp>(a, split, gates, hits, g * a.group + slot);
    if (kWarp) {
      int x = 0;
      if (slot == 0) x = atomicAdd(a.next, 1);
      g = wave + __shfl_sync(FULL, x, 0);
    } else {
      if (threadIdx.x == 0) next_group = atomicAdd(a.next, 1);
      __syncthreads();
      g = wave + next_group;
      __syncthreads();  // read before the next group's thread 0 writes it
    }
  }
}

using Kernel = void (*)(const Args);

// The kernel and its block for a group, and its launch configuration:
// out[0] the dynamic shared memory a block takes (bytes), out[1] resident
// blocks per SM, out[2] threads a block, out[3] SMs, out[4] registers a
// thread, out[5] local (spill) bytes a thread
cudaError_t config(int n_prims, int n_gates, int group, Kernel& fn,
                   int* out) {
  const bool warp = group == 32;
  fn = warp ? cheap_blocked_kernel<true> : cheap_blocked_kernel<false>;
  out[0] = smem_floats(n_prims, n_gates) * static_cast<int>(sizeof(float));
  out[2] = warp ? WARP_BLOCK : group;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, out[2],
                                                      out[0]);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  return out[1] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

bool group_ok(int group) { return group >= 32 && group <= 1024 && !(group % 32); }

}  // namespace

// K8's launch configuration (config's out[0..5]) for a cheap scene of
// n_prims rows and n_gates gates at a vote group. Returns a CUDA error code
// (cudaErrorInvalidConfiguration: no block fits on an SM).
extern "C" int pt_cheap_blocked_config(int n_prims, int n_gates, int group,
                                       int* out) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_gates < 0 ||
      n_gates > MAX_PRIMS || !group_ok(group))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel fn;
  return static_cast<int>(config(n_prims, n_gates, group, fn, out));
}

// Launch on `stream` with lanes voting in groups of `group` (a multiple of
// 32, at most 1024). gates: the bounding gates [n_gates, GATE_F]; hit and
// split: SceneConsts.hit ([n_prims, 13]) and SceneConsts.split ([n_prims,
// 20], 16-byte aligned) with n_sph sphere rows first; rcp_safe:
// SceneConsts.rcp_safe. aabb_host: 6 host floats (lo, hi). pool_in and
// pool_out are distinct [17, n] float32 matrices. uniforms is NULL for the
// counter generator, else [4, n]. next: one int on the device, zero at
// launch. Returns cudaGetLastError(), or the error that refused the
// configuration.
extern "C" int pt_cheap_blocked(const float* gates, int n_gates,
                                const float* hit, const float* split,
                                int n_sph, int n_prims, int rcp_safe,
                                const float* aabb_host, const float* pool_in,
                                float* pool_out, int n, int group,
                                uint32_t seed, int max_depth,
                                int rr_start_depth, const float* uniforms,
                                int* counts, int* next, void* stream) {
  if (n <= 0) return 0;
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_gates < 0 ||
      n_gates > MAX_PRIMS || n_sph < 0 || n_sph > n_prims || hit == nullptr ||
      split == nullptr || (reinterpret_cast<uintptr_t>(split) & 15u) ||
      !group_ok(group) || max_depth < 0 || pool_in == pool_out ||
      next == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{gates, n_gates, hit,     split,   n_sph, n_prims,
         rcp_safe, Box{},  pool_in, pool_out, n,    group,
         seed,  max_depth, rr_start_depth, uniforms, counts, next};
  for (int k = 0; k < 3; ++k) {
    a.box.lo[k] = aabb_host[k];
    a.box.hi[k] = aabb_host[3 + k];
  }
  Kernel fn;
  int cfg[6];
  const cudaError_t e = config(n_prims, n_gates, group, fn, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_block = group == 32 ? cfg[2] / 32 : 1;  // groups at once
  const int n_groups = (n + group - 1) / group;
  const int blocks = (n_groups + per_block - 1) / per_block;
  const int resident = cfg[1] * cfg[3];
  fn<<<blocks < resident ? blocks : resident, cfg[2], cfg[0],
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
