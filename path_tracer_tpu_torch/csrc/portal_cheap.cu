// K2: the portal scheduler's cheap kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas/portal.py:
// trace_cheap_regen (kernel body _make_kernel_cheap_regen). The plain torch
// version of this file is path_tracer_tpu_torch/ops/kernels/portal.py:
// trace_cheap_regen_plain, which states the contract step by step.
//
// What it computes, per pool slot (one column of the pixel-pinned pool
// [rows, n]): the slot advances its active path through the cheap scene
// (everything but the heavy mesh: at most 128 baked primitives, K1's scan),
// regenerating in-kernel while its quota row allows; a segment whose ray
// could reach the heavy mesh's padded AABB no further than its cheap hit
// freezes (ties freeze). With park_k > 0 a frozen path parks in the slot's
// first empty buffer and the slot goes on with its next sample; dead slots
// first re-activate resolved (ready) buffers, lowest first.
//
// Why any thread may run any slot: nothing crosses slots inside a call, and
// a slot that cannot advance (its path and all its buffers frozen, or dead
// with nothing to start) is a fixed point until the next resolve. The JAX
// kernel steps a block of 2048 slots until none can advance or the step
// budget runs out; here each slot takes min(step budget, its own steps) and
// stops, cleaning a dead path's scratch (thr 0, prev -1, depth 0) as the
// next JAX step would. n_steps is the budget, already rounded up by the
// wrapper to the JAX kernel's 8-step check granule. A slot's arithmetic
// does not depend on the lane that runs it, so a build with --fmad=false
// equals the plain version bit for bit.
//
// What bounds it on this card: per-thread FP32 work (the slab test, the scan
// of a few cheap primitives, shading, the counter draws) and, with one
// thread a slot, divergence: a quarter of the slots stop after one step
// (their path froze and found no empty buffer) while ~40% run the whole
// budget, so a warp of 32 consecutive slots ran as long as its slowest and
// ~40% of its lane-steps idled in the bulk cycles (scripts/k2_coherence.py,
// PERF.md).
//
// Design: a persistent grid (the card's SMs x the resident blocks an SM,
// from the occupancy query: 4 blocks of 128 threads at park depth 3, 116
// registers; one slot a thread when n is at most one wave). Each thread
// starts on slot = its global index; beyond that first wave, warps take
// slots from a global counter (scratch zeroed by the wrapper before each
// launch) with one warp-aggregated atomicAdd: the idle lanes get
// consecutive slot indices in lane order, so their loads and stores of the
// slots' 59 rows stay coalesced and Morton neighbours stay together. A lane
// whose slot stops idles, holding the slot, until K2_REFILL_MIN (4) lanes
// of its warp are idle; then those lanes write their slots out and load new
// ones in one divergent branch. Refilling at once keeps more lanes busy but
// pays a branch of 59 loads and stores for every stopped slot; a warp that
// refills only when all 32 lanes idle keeps the one-thread-a-slot schedule
// (scripts/ablate_k2.py times each). A taken slot that cannot advance at
// entry is written out with the next refill. The slot's state lives in
// registers, the park depth is a template parameter so the buffers stay in
// registers too (K2_BUFS puts them in the lane's column of shared
// memory), and the cheap scene sits in shared memory as in K1.
//
// Random numbers: the counter generator keyed by (seed, pixel, the path's
// own sample row, depth, slot), or an injected per-slot table uniforms[6, n]
// indexed by the slot, used at every step.

#include "common.cuh"

using namespace pt;

namespace {

// pool rows: ops/kernels/portal.py
constexpr int ROW_O = 0, ROW_D = 3, ROW_THR = 6, ROW_ACC = 9, ROW_ALIVE = 12,
              ROW_PREV = 13, ROW_DEPTH = 14, V2_ROW_DONE = 15, V2_ROW_PIX = 16,
              V2_ROW_QUOTA = 17, V2_ROWS = 18, V3_ROW_STARTED = 18,
              V3_BUF_BASE = 19, BUF_O = 0, BUF_D = 3, BUF_THR = 6,
              BUF_PREV = 9, BUF_DEPTH = 10, BUF_STATE = 11, BUF_ROWS = 12;

// The design's choices, fixed at build time; scripts/ablate_k2.py builds
// the kernel with others (-D...) to time each part
#ifndef K2_THREADS
#define K2_THREADS 128  // threads a block
#endif
#ifndef K2_MIN_BLOCKS
#define K2_MIN_BLOCKS 1  // resident blocks an SM the registers must allow
#endif
#ifndef K2_REFILL_MIN
#define K2_REFILL_MIN 4  // idle lanes of a warp that make it take new slots
#endif
#ifndef K2_BUFS
// where the parked paths live: 0 registers, 1 the lane's column of shared
// memory, 2 device memory (read at unpark, written at park; the launch
// first copies the pool to the output, so untouched rows need no copy)
#define K2_BUFS 0
#endif
#ifndef K2_OVERLAP_LOAD
#define K2_OVERLAP_LOAD 0  // 1: check a refilled slot after the others' step
#endif
static_assert(K2_THREADS % 32 == 0 && K2_THREADS <= 1024, "K2_THREADS");
static_assert(K2_REFILL_MIN >= 1 && K2_REFILL_MIN <= 32,
              "K2_REFILL_MIN: 1 .. 32");

constexpr unsigned FULL = 0xffffffffu;

struct Box {
  float lo[3], hi[3];
};

// A parked buffer's fields: the path (o, d, thr, prev, depth, sample) and
// its state (0 empty, 1 frozen, 2 ready)
constexpr int PF_O = 0, PF_D = 3, PF_THR = 6, PF_PREV = 9, PF_DEPTH = 10,
              PF_SAMPLE = 11, PF_STATE = 12, PF_N = 13;

// A lane's PK parked buffers (K2_BUFS): registers (every index is a
// constant after unrolling), the lane's column of a shared array
// [PK * PF_N][K2_THREADS], or only the states in registers
template <int PK, int WHERE>
struct Parked {
  float v[PK > 0 ? PK * PF_N : 1];
  __device__ __forceinline__ void bind(float*) {}
  __device__ __forceinline__ float& at(int j, int f) { return v[j * PF_N + f]; }
};

template <int PK>
struct Parked<PK, 1> {
  float* base;
  __device__ __forceinline__ void bind(float* p) { base = p; }
  __device__ __forceinline__ float& at(int j, int f) {
    return base[(j * PF_N + f) * K2_THREADS];
  }
};

template <int PK>
struct Parked<PK, 2> {
  float state[PK > 0 ? PK : 1];
  __device__ __forceinline__ void bind(float*) {}
  __device__ __forceinline__ float& at(int j, int) { return state[j]; }
};

struct Path {
  float o[3], d[3], thr[3];
  float prev, depth, sample;
};

template <int PK>
struct Slot {
  Path a;
  float acc[3];
  float alive, done, qrow, started, pix_f;
  Parked<PK, K2_BUFS> buf;
  float px, py;
  uint32_t pkey;
  int idx, counts, steps;
  bool frozen;
};

struct Params {
  const float* prims_g;
  int n_prims;
  const float* gates_g;
  int n_gates;
  Cam cam;
  Box box;
  const float* in;
  float* out;
  int n;
  uint32_t seed;
  int sample_base, n_steps, max_depth, rr_start_depth;
  const float* uniforms;
  int* counts_out;
  int* next;  // the slot counter beyond the first wave (zeroed scratch)
};

template <int PK>
__host__ __device__ constexpr int jax_rows() {
  return PK ? V3_BUF_BASE + PK * BUF_ROWS : V2_ROWS;
}

template <int PK>
__device__ __forceinline__ void load_slot(Slot<PK>& s, const Params& p,
                                          int i) {
  const size_t N = static_cast<size_t>(p.n);
  constexpr int JAX_ROWS = jax_rows<PK>();
  const float* __restrict__ in = p.in;
  auto at = [&](int r) { return in[r * N + i]; };
  s.idx = i;
  for (int k = 0; k < 3; ++k) {
    s.a.o[k] = at(ROW_O + k);
    s.a.d[k] = at(ROW_D + k);
    s.a.thr[k] = at(ROW_THR + k);
    s.acc[k] = at(ROW_ACC + k);
  }
  s.a.prev = at(ROW_PREV);
  s.a.depth = at(ROW_DEPTH);
  s.a.sample = at(JAX_ROWS);
  s.alive = at(ROW_ALIVE);
  s.done = at(V2_ROW_DONE);
  s.qrow = at(V2_ROW_QUOTA);
  s.started = PK ? at(V3_ROW_STARTED) : 0.0f;
  s.pix_f = at(V2_ROW_PIX);
#pragma unroll
  for (int j = 0; j < PK; ++j) {
    const int b = V3_BUF_BASE + j * BUF_ROWS;
    if constexpr (K2_BUFS != 2) {
      for (int k = 0; k < 3; ++k) {
        s.buf.at(j, PF_O + k) = at(b + BUF_O + k);
        s.buf.at(j, PF_D + k) = at(b + BUF_D + k);
        s.buf.at(j, PF_THR + k) = at(b + BUF_THR + k);
      }
      s.buf.at(j, PF_PREV) = at(b + BUF_PREV);
      s.buf.at(j, PF_DEPTH) = at(b + BUF_DEPTH);
      s.buf.at(j, PF_SAMPLE) = at(JAX_ROWS + 1 + j);
    }
    s.buf.at(j, PF_STATE) = at(b + BUF_STATE);
  }
  const int pix = static_cast<int>(s.pix_f);
  pixel_xy(p.cam, pix, s.px, s.py);
  s.pkey = pixel_key(p.seed, pix);
  s.counts = 0;
  s.steps = 0;
  s.frozen = false;
}

template <int PK>
__device__ __forceinline__ void store_slot(Slot<PK>& s, const Params& p) {
  const size_t N = static_cast<size_t>(p.n);
  constexpr int JAX_ROWS = jax_rows<PK>();
  const int i = s.idx;
  float* __restrict__ out = p.out;
  auto put = [&](int r, float v) { out[r * N + i] = v; };
  for (int k = 0; k < 3; ++k) {
    put(ROW_O + k, s.a.o[k]);
    put(ROW_D + k, s.a.d[k]);
    put(ROW_THR + k, s.a.thr[k]);
    put(ROW_ACC + k, s.acc[k]);
  }
  put(ROW_ALIVE, s.alive);
  put(ROW_PREV, s.a.prev);
  put(ROW_DEPTH, s.a.depth);
  put(V2_ROW_DONE, s.done);
  put(V2_ROW_PIX, s.pix_f);
  put(V2_ROW_QUOTA, s.qrow);
  put(JAX_ROWS, s.a.sample);
  if (PK) put(V3_ROW_STARTED, s.started);
#pragma unroll
  for (int j = 0; j < PK; ++j) {
    const int b = V3_BUF_BASE + j * BUF_ROWS;
    if constexpr (K2_BUFS != 2) {
      for (int k = 0; k < 3; ++k) {
        put(b + BUF_O + k, s.buf.at(j, PF_O + k));
        put(b + BUF_D + k, s.buf.at(j, PF_D + k));
        put(b + BUF_THR + k, s.buf.at(j, PF_THR + k));
      }
      put(b + BUF_PREV, s.buf.at(j, PF_PREV));
      put(b + BUF_DEPTH, s.buf.at(j, PF_DEPTH));
      put(JAX_ROWS + 1 + j, s.buf.at(j, PF_SAMPLE));
    }
    put(b + BUF_STATE, s.buf.at(j, PF_STATE));
  }
  p.counts_out[i] = s.counts;
}

// Whether the slot can take a step: a live path not frozen, or a dead one
// with a sample to start or a ready buffer to re-activate
template <int PK>
__device__ __forceinline__ bool runnable(Slot<PK>& s) {
  bool can_start = (PK ? s.started : s.done) < s.qrow;
#pragma unroll
  for (int j = 0; j < PK; ++j)
    can_start = can_start || s.buf.at(j, PF_STATE) > 1.5f;
  return s.alive > 0.0f ? !s.frozen : can_start;
}

// The scratch cleanup of the next JAX step, for a slot that stops dead
template <int PK>
__device__ __forceinline__ void clean_dead(Slot<PK>& s) {
  if (!(s.alive > 0.0f)) {
    for (int k = 0; k < 3; ++k) s.a.thr[k] = 0.0f;
    s.a.prev = -1.0f;
    s.a.depth = 0.0f;
  }
}

template <int PK>
__device__ __forceinline__ void park(Slot<PK>& s, const Params& p, int j) {
  if constexpr (K2_BUFS == 2) {  // straight to the output rows
    const size_t N = static_cast<size_t>(p.n);
    const int b = V3_BUF_BASE + j * BUF_ROWS, i = s.idx;
    float* __restrict__ out = p.out;
    for (int k = 0; k < 3; ++k) {
      out[(b + BUF_O + k) * N + i] = s.a.o[k];
      out[(b + BUF_D + k) * N + i] = s.a.d[k];
      out[(b + BUF_THR + k) * N + i] = s.a.thr[k];
    }
    out[(b + BUF_PREV) * N + i] = s.a.prev;
    out[(b + BUF_DEPTH) * N + i] = s.a.depth;
    out[(jax_rows<PK>() + 1 + j) * N + i] = s.a.sample;
  } else {
    for (int k = 0; k < 3; ++k) {
      s.buf.at(j, PF_O + k) = s.a.o[k];
      s.buf.at(j, PF_D + k) = s.a.d[k];
      s.buf.at(j, PF_THR + k) = s.a.thr[k];
    }
    s.buf.at(j, PF_PREV) = s.a.prev;
    s.buf.at(j, PF_DEPTH) = s.a.depth;
    s.buf.at(j, PF_SAMPLE) = s.a.sample;
  }
}

// A ready buffer was filled by the last resolve, never by this call (a park
// needs an empty buffer, and an unpark empties it for good), so with
// K2_BUFS 2 its path is the input's
template <int PK>
__device__ __forceinline__ void unpark(Slot<PK>& s, const Params& p, int j) {
  if constexpr (K2_BUFS == 2) {
    const size_t N = static_cast<size_t>(p.n);
    const int b = V3_BUF_BASE + j * BUF_ROWS, i = s.idx;
    const float* __restrict__ in = p.in;
    for (int k = 0; k < 3; ++k) {
      s.a.o[k] = in[(b + BUF_O + k) * N + i];
      s.a.d[k] = in[(b + BUF_D + k) * N + i];
      s.a.thr[k] = in[(b + BUF_THR + k) * N + i];
    }
    s.a.prev = in[(b + BUF_PREV) * N + i];
    s.a.depth = in[(b + BUF_DEPTH) * N + i];
    s.a.sample = in[(jax_rows<PK>() + 1 + j) * N + i];
  } else {
    for (int k = 0; k < 3; ++k) {
      s.a.o[k] = s.buf.at(j, PF_O + k);
      s.a.d[k] = s.buf.at(j, PF_D + k);
      s.a.thr[k] = s.buf.at(j, PF_THR + k);
    }
    s.a.prev = s.buf.at(j, PF_PREV);
    s.a.depth = s.buf.at(j, PF_DEPTH);
    s.a.sample = s.buf.at(j, PF_SAMPLE);
  }
}

// One step of a runnable slot: re-activate, regenerate, the portal test,
// the scan, shading, parking (trace_cheap_regen_plain's step)
template <int PK>
__device__ __forceinline__ void step(Slot<PK>& s, const Params& p,
                                     const float* prims, const float* gates) {
  const int i = s.idx;
  Path& a = s.a;
  if (PK) {  // re-activate a ready parked path, lowest j first
    bool vacant = s.alive <= 0.0f;
#pragma unroll
    for (int j = 0; j < PK; ++j) {
      if (vacant && s.buf.at(j, PF_STATE) > 1.5f) {
        unpark(s, p, j);
        s.alive = 1.0f;
        s.buf.at(j, PF_STATE) = 0.0f;
        vacant = false;
      }
    }
  }
  const float issued = PK ? s.started : s.done;
  if (s.alive <= 0.0f && issued < s.qrow) {  // regenerate
    const float s_new = static_cast<float>(p.sample_base) + issued;
    const int smp = static_cast<int>(s_new);
    const uint32_t key = mix32(s.pkey, static_cast<uint32_t>(smp));
    camera_ray(p.cam, s.px, s.py, smp, draw(p.uniforms, p.n, i, key, 0, 4),
               draw(p.uniforms, p.n, i, key, 0, 5), a.d);
    for (int k = 0; k < 3; ++k) {
      a.o[k] = p.cam.lc[k];
      a.thr[k] = 1.0f;
    }
    a.prev = -1.0f;
    a.depth = 0.0f;
    a.sample = s_new;
    s.alive = 1.0f;
    if (PK) s.started += 1.0f;
  }

  const bool live = s.alive > 0.0f;
  // the portal: padded AABB slab test of the heavy mesh
  float t_en = 0.0f, t_ex = BIG;
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / (fabsf(a.d[k]) < TINY ? TINY : a.d[k]);
    const float ta = (p.box.lo[k] - a.o[k]) * inv;
    const float tb = (p.box.hi[k] - a.o[k]) * inv;
    t_en = fmaxf(t_en, fminf(ta, tb));
    t_ex = fminf(t_ex, fmaxf(ta, tb));
  }
  const bool hit_box = t_ex >= t_en && t_ex > 0.0f && live;
  float tmin;
  const int best = prim_scan(prims, p.n_prims, gates, a.o, a.d,
                             static_cast<int>(a.prev), tmin);
  const bool needs = hit_box && t_en <= tmin;  // ties freeze
  const bool proc = live && !needs;
  s.counts += proc ? 1 : 0;

  const bool found = best >= 0 && proc;
  const float new_depth = a.depth + 1.0f;
  bool alive_new = false;
  float point[3], dn[3], thr_new[3];
  float new_prev = -1.0f;
  if (found) {
    const uint32_t key = mix32(s.pkey, static_cast<uint32_t>(
                                           static_cast<int>(a.sample)));
    const int dep = static_cast<int>(a.depth);
    const float* r = prims + best * PRIM_F;
    float nrm[3];
    prim_surface(r, a.o, a.d, tmin, point, nrm);
    alive_new = shade(a.d, nrm, r + COL_COLOR, r + COL_EMIS, r[COL_RTYPE],
                      a.thr, s.acc, draw(p.uniforms, p.n, i, key, dep, 0),
                      draw(p.uniforms, p.n, i, key, dep, 1),
                      draw(p.uniforms, p.n, i, key, dep, 2),
                      draw(p.uniforms, p.n, i, key, dep, 3),
                      static_cast<int>(new_depth), p.max_depth,
                      p.rr_start_depth, dn, thr_new);
    new_prev = r[COL_PREVID];
  }
  if (proc && !alive_new) s.done += 1.0f;
  if (alive_new) {
    for (int k = 0; k < 3; ++k) {
      a.o[k] = point[k];
      a.d[k] = dn[k];
    }
  }
  if (!needs) {  // a frozen path keeps its state
    for (int k = 0; k < 3; ++k) a.thr[k] = alive_new ? thr_new[k] : 0.0f;
    a.prev = new_prev;
    s.alive = alive_new ? 1.0f : 0.0f;
    a.depth = alive_new ? new_depth : 0.0f;
  }

  bool stalled = needs;
  if (PK) {  // park a frozen path in the first empty buffer
    bool to_park = needs && live;
#pragma unroll
    for (int j = 0; j < PK; ++j) {
      if (to_park && s.buf.at(j, PF_STATE) < 0.5f) {
        park(s, p, j);
        s.buf.at(j, PF_STATE) = 1.0f;
        to_park = false;
      }
    }
    if (needs && live && !to_park) s.alive = 0.0f;
    stalled = to_park;
  }
  s.frozen = live && stalled;
}

template <int PK>
__global__ void __launch_bounds__(K2_THREADS, K2_MIN_BLOCKS)
cheap_regen_kernel(const Params p) {
  extern __shared__ float smem[];
  float* prims = smem;
  float* gates = smem + p.n_prims * PRIM_F;
  for (int k = threadIdx.x; k < p.n_prims * PRIM_F; k += K2_THREADS)
    prims[k] = p.prims_g[k];
  for (int k = threadIdx.x; k < p.n_gates * GATE_F; k += K2_THREADS)
    gates[k] = p.gates_g[k];
  __syncthreads();  // the only barrier: after it, warps go their own way

  Slot<PK> s;
  s.buf.bind(gates + p.n_gates * GATE_F + threadIdx.x);
  const int lane = threadIdx.x & 31;
  const int wave = gridDim.x * K2_THREADS;
  // A lane holds a slot that runs (has), one just loaded and not checked
  // yet (fresh), or one that stopped and waits to be written out with its
  // warp's next refill, so that one divergent branch stores and loads for
  // all the lanes it refills (pending).
  bool has = false, fresh = false, pending = false;
  auto check = [&]() {  // a loaded slot's first check: does it take a step?
    fresh = false;
    if (p.n_steps > 0 && runnable(s)) {
      has = true;
    } else {
      if (p.n_steps > 0) clean_dead(s);
      pending = true;
    }
  };
  // The first wave: one slot a thread, as many as the grid has threads
  const int first = blockIdx.x * K2_THREADS + threadIdx.x;
  if (first < p.n) {
    load_slot(s, p, first);
    fresh = true;
  }
  bool more = wave < p.n;  // the counter may still hold slots (warp-uniform)
  while (true) {
    if (!K2_OVERLAP_LOAD && fresh) check();
    const unsigned idle = __ballot_sync(FULL, !has && !fresh);
    if (pending && !more) {  // no refill will come
      store_slot(s, p);
      pending = false;
    }
    if (more && __popc(idle) >= K2_REFILL_MIN) {
      const int k = __popc(idle);
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(p.next, k);
      base = wave + __shfl_sync(FULL, base, leader);
      if (base + k >= p.n) more = false;
      if (!has && !fresh) {
        if (pending) {
          store_slot(s, p);
          pending = false;
        }
        const int i = base + __popc(idle & ((1u << lane) - 1u));
        if (i < p.n) {
          load_slot(s, p, i);
          fresh = true;
        }
      }
      if (!K2_OVERLAP_LOAD) continue;  // check the new slots, refill again
    }
    if (__ballot_sync(FULL, has || fresh) == 0) {
      if (!more) break;
      continue;
    }
    if (has) {
      step(s, p, prims, gates);
      const bool budget = ++s.steps == p.n_steps;
      if (budget || !runnable(s)) {
        if (!budget) clean_dead(s);
        has = false;
        pending = true;
      }
    }
    // With K2_OVERLAP_LOAD a slot loaded by this iteration's refill is
    // checked after the other lanes' step, to hide its loads' latency, and
    // steps from the next iteration on (slower on an H100: PERF.md)
    if (K2_OVERLAP_LOAD && fresh) check();
  }
}

template <int PK>
size_t smem_bytes(int n_prims, int n_gates) {
  return static_cast<size_t>(n_prims * PRIM_F + n_gates * GATE_F +
                             (K2_BUFS == 1 ? PK * PF_N * K2_THREADS : 0)) *
         sizeof(float);
}

// Resident blocks per SM for a launch with `smem` bytes of dynamic shared
// memory; registers and local (spill) bytes a thread
template <int PK>
cudaError_t configure(size_t smem, int* out) {
  auto* fn = cheap_regen_kernel<PK>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, K2_THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  out[0] = static_cast<int>(smem);
  out[2] = K2_THREADS;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[6] = K2_REFILL_MIN;
  int device = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount,
                               device);
  if (e == cudaSuccess && out[1] < 1) e = cudaErrorInvalidConfiguration;
  return e;
}

cudaError_t config(int n_prims, int n_gates, int park_k, int* out) {
  switch (park_k) {
    case 0: return configure<0>(smem_bytes<0>(n_prims, n_gates), out);
    case 1: return configure<1>(smem_bytes<1>(n_prims, n_gates), out);
    case 2: return configure<2>(smem_bytes<2>(n_prims, n_gates), out);
    case 3: return configure<3>(smem_bytes<3>(n_prims, n_gates), out);
    default: return cudaErrorInvalidValue;
  }
}

template <int PK>
cudaError_t launch(const Params& p, const int* cfg, cudaStream_t stream) {
  if (K2_BUFS == 2) {  // every row the kernel does not write keeps its value
    const cudaError_t e = cudaMemcpyAsync(
        p.out, p.in,
        static_cast<size_t>(jax_rows<PK>() + 1 + PK) * p.n * sizeof(float),
        cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.n + K2_THREADS - 1) / K2_THREADS;
  const int resident = cfg[1] * cfg[3];
  cheap_regen_kernel<PK><<<blocks < resident ? blocks : resident, K2_THREADS,
                           cfg[0], stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The launch configuration on the current card: out[0] the dynamic shared
// memory a block takes (bytes), out[1] resident blocks per SM, out[2]
// threads a block, out[3] SMs, out[4] registers a thread, out[5] local
// (spill) bytes a thread, out[6] K2_REFILL_MIN. Returns a CUDA error code
// (cudaErrorInvalidConfiguration: no block fits on an SM).
extern "C" int pt_cheap_regen_config(int n_prims, int n_gates, int park_k,
                                     int* out) {
  return static_cast<int>(config(n_prims, n_gates, park_k, out));
}

// Launch on `stream`. cam_host: 14 host floats (CameraConsts.params);
// aabb_host: 6 host floats (lo, hi). pool_in and pool_out are distinct
// [rows, n] float32 matrices (rows = the port's layout for park_k).
// uniforms is NULL for the counter generator. next: one int on the device,
// zero at launch (the kernel's slot counter). Returns cudaGetLastError(),
// or the error that refused the configuration.
extern "C" int pt_cheap_regen(const float* prims, int n_prims,
                              const float* gates, int n_gates,
                              const float* cam_host, int width, int height,
                              const float* aabb_host, const float* pool_in,
                              float* pool_out, int n, int park_k,
                              uint32_t seed, int sample_base, int n_steps,
                              int max_depth, int rr_start_depth,
                              const float* uniforms, int* counts, int* next,
                              void* stream) {
  if (n <= 0) return 0;
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_gates < 0 ||
      n_gates > MAX_PRIMS || width <= 0 || n_steps < 0 ||
      pool_in == pool_out || next == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int cfg[7];
  const cudaError_t e = config(n_prims, n_gates, park_k, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  p.prims_g = prims;
  p.n_prims = n_prims;
  p.gates_g = gates;
  p.n_gates = n_gates;
  p.cam = make_cam(cam_host, width, height);
  for (int k = 0; k < 3; ++k) {
    p.box.lo[k] = aabb_host[k];
    p.box.hi[k] = aabb_host[3 + k];
  }
  p.in = pool_in;
  p.out = pool_out;
  p.n = n;
  p.seed = seed;
  p.sample_base = sample_base;
  p.n_steps = n_steps;
  p.max_depth = max_depth;
  p.rr_start_depth = rr_start_depth;
  p.uniforms = uniforms;
  p.counts_out = counts;
  p.next = next;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (park_k) {
    case 0: return static_cast<int>(launch<0>(p, cfg, s));
    case 1: return static_cast<int>(launch<1>(p, cfg, s));
    case 2: return static_cast<int>(launch<2>(p, cfg, s));
    default: return static_cast<int>(launch<3>(p, cfg, s));
  }
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
