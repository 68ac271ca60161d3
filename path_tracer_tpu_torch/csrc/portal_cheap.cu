// K2: the portal scheduler's cheap kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas/portal.py:
// trace_cheap_regen (kernel body _make_kernel_cheap_regen). The plain torch
// version of this file is path_tracer_tpu_torch/ops/kernels/portal.py:
// trace_cheap_regen_plain, which states the contract step by step.
//
// What it computes: one thread per pool slot (one column of the pixel-pinned
// pool [rows, n]). The slot advances its active path through the cheap
// scene (everything but the heavy mesh: at most 128 baked primitives, K1's
// scan), regenerating in-kernel while its quota row allows; a segment whose
// ray could reach the heavy mesh's padded AABB no further than its cheap hit
// freezes (ties freeze). With park_k > 0 a frozen path parks in the slot's
// first empty buffer and the slot goes on with its next sample; dead slots
// first re-activate resolved (ready) buffers, lowest first.
//
// Why one thread per slot is faithful: nothing crosses slots inside a call,
// and a slot that cannot advance (its path and all its buffers frozen, or
// dead with nothing to start) is a fixed point until the next resolve. The
// JAX kernel steps a block of 2048 slots until none can advance or the step
// budget runs out; here each slot takes min(step budget, its own steps) and
// stops, cleaning a dead path's scratch (thr 0, prev -1, depth 0) as the
// next JAX step would. n_steps is the budget, already rounded up by the
// wrapper to the JAX kernel's 8-step check granule.
//
// What bounds it on this card: per-thread FP32 work (the scan of a few
// cheap primitives, shading, the slab test) and divergence between slots
// that freeze early and slots that run the whole budget. The pool column is
// read once and written once (coalesced: thread i touches element i of each
// row); state lives in registers for the whole call, the park depth is a
// template parameter so the buffers stay in registers too, and the cheap
// scene sits in shared memory as in K1.
//
// Random numbers: the counter generator keyed by (seed, pixel, the path's
// own sample row, depth, slot), or an injected per-slot table uniforms[6, n]
// used at every step. Built with --fmad=false it equals the plain version
// bit for bit.

#include "common.cuh"

using namespace pt;

namespace {

// pool rows: ops/kernels/portal.py
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13, ROW_DEPTH = 14, V2_ROW_DONE = 15, V2_ROW_PIX = 16,
              V2_ROW_QUOTA = 17, V2_ROWS = 18, V3_ROW_STARTED = 18,
              V3_BUF_BASE = 19, BUF_O = 0, BUF_D = 3, BUF_THR = 6,
              BUF_PREV = 9, BUF_DEPTH = 10, BUF_STATE = 11, BUF_ROWS = 12;

struct Box {
  float lo[3], hi[3];
};

struct Path {
  float o[3], d[3], thr[3];
  float prev, depth, sample;
};

struct Parked {
  Path p;
  float ps;  // 0 empty, 1 frozen, 2 ready
};

template <int PK>
__global__ void __launch_bounds__(THREADS)
cheap_regen_kernel(const float* __restrict__ prims_g, int n_prims,
                   const float* __restrict__ gates_g, int n_gates, Cam cam,
                   Box box, const float* __restrict__ in,
                   float* __restrict__ out, int n, uint32_t seed,
                   int sample_base, int n_steps, int max_depth,
                   int rr_start_depth, const float* __restrict__ uniforms,
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
  if (i >= n) return;
  const size_t N = static_cast<size_t>(n);
  constexpr int JAX_ROWS = PK ? V3_BUF_BASE + PK * BUF_ROWS : V2_ROWS;
  auto at = [&](int r) { return in[r * N + i]; };

  Path a;
  float acc[3];
  for (int k = 0; k < 3; ++k) {
    a.o[k] = at(ROW_O + k);
    a.d[k] = at(ROW_D + k);
    a.thr[k] = at(ROW_THR + k);
    acc[k] = at(ROW_ACC + k);
  }
  a.prev = at(ROW_PREV);
  a.depth = at(ROW_DEPTH);
  a.sample = at(JAX_ROWS);
  float alive = at(ROW_ALIVE);
  float done = at(V2_ROW_DONE);
  const float qrow = at(V2_ROW_QUOTA);
  float started = PK ? at(V3_ROW_STARTED) : 0.0f;
  Parked buf[PK > 0 ? PK : 1];
#pragma unroll
  for (int j = 0; j < PK; ++j) {
    const int b = V3_BUF_BASE + j * BUF_ROWS;
    for (int k = 0; k < 3; ++k) {
      buf[j].p.o[k] = at(b + BUF_O + k);
      buf[j].p.d[k] = at(b + BUF_D + k);
      buf[j].p.thr[k] = at(b + BUF_THR + k);
    }
    buf[j].p.prev = at(b + BUF_PREV);
    buf[j].p.depth = at(b + BUF_DEPTH);
    buf[j].p.sample = at(JAX_ROWS + 1 + j);
    buf[j].ps = at(b + BUF_STATE);
  }

  const int pix = static_cast<int>(at(V2_ROW_PIX));
  float px, py;
  pixel_xy(cam, pix, px, py);
  const uint32_t pkey = pixel_key(seed, pix);
  int counts = 0;
  bool frozen = false;

  for (int step = 0; step < n_steps; ++step) {
    bool can_start = (PK ? started : done) < qrow;
#pragma unroll
    for (int j = 0; j < PK; ++j) can_start = can_start || buf[j].ps > 1.5f;
    const bool runnable = alive > 0.0f ? !frozen : can_start;
    if (!runnable) {
      if (!(alive > 0.0f)) {  // the scratch cleanup of the next JAX step
        for (int k = 0; k < 3; ++k) a.thr[k] = 0.0f;
        a.prev = -1.0f;
        a.depth = 0.0f;
      }
      break;
    }

    if (PK) {  // re-activate a ready parked path, lowest j first
      bool vacant = alive <= 0.0f;
#pragma unroll
      for (int j = 0; j < PK; ++j) {
        if (vacant && buf[j].ps > 1.5f) {
          a = buf[j].p;
          alive = 1.0f;
          buf[j].ps = 0.0f;
          vacant = false;
        }
      }
    }
    const float issued = PK ? started : done;
    if (alive <= 0.0f && issued < qrow) {  // regenerate
      const float s_new = static_cast<float>(sample_base) + issued;
      const int s = static_cast<int>(s_new);
      const uint32_t key = mix32(pkey, static_cast<uint32_t>(s));
      camera_ray(cam, px, py, s, draw(uniforms, n, i, key, 0, 4),
                 draw(uniforms, n, i, key, 0, 5), a.d);
      for (int k = 0; k < 3; ++k) {
        a.o[k] = cam.lc[k];
        a.thr[k] = 1.0f;
      }
      a.prev = -1.0f;
      a.depth = 0.0f;
      a.sample = s_new;
      alive = 1.0f;
      if (PK) started += 1.0f;
    }

    const bool live = alive > 0.0f;
    // the portal: padded AABB slab test of the heavy mesh
    float t_en = 0.0f, t_ex = BIG;
    for (int k = 0; k < 3; ++k) {
      const float inv = 1.0f / (fabsf(a.d[k]) < TINY ? TINY : a.d[k]);
      const float ta = (box.lo[k] - a.o[k]) * inv;
      const float tb = (box.hi[k] - a.o[k]) * inv;
      t_en = fmaxf(t_en, fminf(ta, tb));
      t_ex = fminf(t_ex, fmaxf(ta, tb));
    }
    const bool hit_box = t_ex >= t_en && t_ex > 0.0f && live;
    float tmin;
    const int best = prim_scan(prims, n_prims, gates, a.o, a.d,
                               static_cast<int>(a.prev), tmin);
    const bool needs = hit_box && t_en <= tmin;  // ties freeze
    const bool proc = live && !needs;
    counts += proc ? 1 : 0;

    const bool found = best >= 0 && proc;
    const float new_depth = a.depth + 1.0f;
    bool alive_new = false;
    float point[3], dn[3], thr_new[3];
    float new_prev = -1.0f;
    if (found) {
      const uint32_t key = mix32(pkey, static_cast<uint32_t>(
                                           static_cast<int>(a.sample)));
      const int dep = static_cast<int>(a.depth);
      const float* r = prims + best * PRIM_F;
      float nrm[3];
      prim_surface(r, a.o, a.d, tmin, point, nrm);
      alive_new = shade(a.d, nrm, r + COL_COLOR, r + COL_EMIS, r[COL_RTYPE],
                        a.thr, acc, draw(uniforms, n, i, key, dep, 0),
                        draw(uniforms, n, i, key, dep, 1),
                        draw(uniforms, n, i, key, dep, 2),
                        draw(uniforms, n, i, key, dep, 3),
                        static_cast<int>(new_depth), max_depth,
                        rr_start_depth, dn, thr_new);
      new_prev = r[COL_PREVID];
    }
    if (proc && !alive_new) done += 1.0f;
    if (alive_new) {
      for (int k = 0; k < 3; ++k) {
        a.o[k] = point[k];
        a.d[k] = dn[k];
      }
    }
    if (!needs) {  // a frozen path keeps its state
      for (int k = 0; k < 3; ++k) a.thr[k] = alive_new ? thr_new[k] : 0.0f;
      a.prev = new_prev;
      alive = alive_new ? 1.0f : 0.0f;
      a.depth = alive_new ? new_depth : 0.0f;
    }

    bool stalled = needs;
    if (PK) {  // park a frozen path in the first empty buffer
      bool to_park = needs && live;
#pragma unroll
      for (int j = 0; j < PK; ++j) {
        if (to_park && buf[j].ps < 0.5f) {
          buf[j].p = a;
          buf[j].ps = 1.0f;
          to_park = false;
        }
      }
      if (needs && live && !to_park) alive = 0.0f;
      stalled = to_park;
    }
    frozen = live && stalled;
  }

  auto put = [&](int r, float v) { out[r * N + i] = v; };
  for (int k = 0; k < 3; ++k) {
    put(ROW_O + k, a.o[k]);
    put(ROW_D + k, a.d[k]);
    put(ROW_THR + k, a.thr[k]);
    put(ROW_ACC + k, acc[k]);
  }
  put(ROW_ALIVE, alive);
  put(ROW_PREV, a.prev);
  put(ROW_DEPTH, a.depth);
  put(V2_ROW_DONE, done);
  put(V2_ROW_PIX, at(V2_ROW_PIX));
  put(V2_ROW_QUOTA, qrow);
  put(JAX_ROWS, a.sample);
  if (PK) put(V3_ROW_STARTED, started);
#pragma unroll
  for (int j = 0; j < PK; ++j) {
    const int b = V3_BUF_BASE + j * BUF_ROWS;
    for (int k = 0; k < 3; ++k) {
      put(b + BUF_O + k, buf[j].p.o[k]);
      put(b + BUF_D + k, buf[j].p.d[k]);
      put(b + BUF_THR + k, buf[j].p.thr[k]);
    }
    put(b + BUF_PREV, buf[j].p.prev);
    put(b + BUF_DEPTH, buf[j].p.depth);
    put(b + BUF_STATE, buf[j].ps);
    put(JAX_ROWS + 1 + j, buf[j].p.sample);
  }
  counts_out[i] = counts;
}

template <int PK>
void launch(const float* prims, int n_prims, const float* gates, int n_gates,
            const Cam& cam, const Box& box, const float* in, float* out,
            int n, uint32_t seed, int sample_base, int n_steps, int max_depth,
            int rr_start_depth, const float* uniforms, int* counts,
            cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(n_prims * PRIM_F + n_gates * GATE_F) * sizeof(float);
  const int blocks = (n + THREADS - 1) / THREADS;
  cheap_regen_kernel<PK><<<blocks, THREADS, smem, stream>>>(
      prims, n_prims, gates, n_gates, cam, box, in, out, n, seed, sample_base,
      n_steps, max_depth, rr_start_depth, uniforms, counts);
}

}  // namespace

// Launch on `stream`. cam_host: 14 host floats (CameraConsts.params);
// aabb_host: 6 host floats (lo, hi). pool_in and pool_out are distinct
// [rows, n] float32 matrices (rows = the port's layout for park_k).
// uniforms is NULL for the counter generator. Returns cudaGetLastError().
extern "C" int pt_cheap_regen(const float* prims, int n_prims,
                              const float* gates, int n_gates,
                              const float* cam_host, int width, int height,
                              const float* aabb_host, const float* pool_in,
                              float* pool_out, int n, int park_k,
                              uint32_t seed, int sample_base, int n_steps,
                              int max_depth, int rr_start_depth,
                              const float* uniforms, int* counts,
                              void* stream) {
  if (n <= 0) return 0;
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_gates < 0 ||
      n_gates > MAX_PRIMS || width <= 0 || n_steps < 0 || pool_in == pool_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cam cam = make_cam(cam_host, width, height);
  Box box;
  for (int k = 0; k < 3; ++k) {
    box.lo[k] = aabb_host[k];
    box.hi[k] = aabb_host[3 + k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (park_k) {
    case 0:
      launch<0>(prims, n_prims, gates, n_gates, cam, box, pool_in, pool_out, n,
                seed, sample_base, n_steps, max_depth, rr_start_depth,
                uniforms, counts, s);
      break;
    case 1:
      launch<1>(prims, n_prims, gates, n_gates, cam, box, pool_in, pool_out, n,
                seed, sample_base, n_steps, max_depth, rr_start_depth,
                uniforms, counts, s);
      break;
    case 2:
      launch<2>(prims, n_prims, gates, n_gates, cam, box, pool_in, pool_out, n,
                seed, sample_base, n_steps, max_depth, rr_start_depth,
                uniforms, counts, s);
      break;
    case 3:
      launch<3>(prims, n_prims, gates, n_gates, cam, box, pool_in, pool_out, n,
                seed, sample_base, n_steps, max_depth, rr_start_depth,
                uniforms, counts, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
