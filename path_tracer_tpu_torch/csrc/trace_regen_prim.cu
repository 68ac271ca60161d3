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
// Thread i owns pixel pixel_idx[i] and traces `quota` full samples (global
// indices sample_base ..), restarting the moment its path dies.
//
// What bounds it on this card: per-thread FP32 work and divergence. A pixel
// reads 4 B and writes 20 B over hundreds of segments; each segment tests
// the base set and the Morton tiles its ray can enter closer than its best
// hit (tens to hundreds of triangles of ~40 flops). One thread per pixel
// keeps the path state in registers; the scene tables are read through the
// read-only cache (see isect_full.cuh for why not shared memory).
//
// Random numbers: the counter generator keyed by (seed, pixel, sample,
// depth, slot), as in K1, or an injected per-lane table uniforms[6, n].
// Built with --fmad=false it equals the plain version bit for bit.

#include "isect_full.cuh"

using namespace pt;

namespace {

__global__ void __launch_bounds__(THREADS)
trace_regen_prim_kernel(FullScene sc, Cam cam,
                        const int* __restrict__ pixel_idx, int n,
                        uint32_t seed, int sample_base, int quota,
                        int max_depth, int rr_start_depth,
                        const float* __restrict__ uniforms,
                        float* __restrict__ rad, int* __restrict__ segs_out,
                        int* __restrict__ done_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int pix = pixel_idx[i];
  float px, py;
  pixel_xy(cam, pix, px, py);
  const uint32_t pkey = pixel_key(seed, pix);

  float o[3] = {cam.lc[0], cam.lc[1], cam.lc[2]};
  float d[3] = {0.0f, 0.0f, 1.0f};
  float thr[3] = {0.0f, 0.0f, 0.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  bool alive = false;
  float prev = -1.0f;
  int depth = 0, done = 0, segs = 0;
  uint32_t key = 0u;

  while (done < quota) {
    const int s = sample_base + done;
    if (!alive) {  // regenerate: a fresh camera ray for sample s
      key = mix32(pkey, static_cast<uint32_t>(s));
      depth = 0;
      camera_ray(cam, px, py, s, draw(uniforms, n, i, key, 0, 4),
                 draw(uniforms, n, i, key, 0, 5), d);
      for (int k = 0; k < 3; ++k) {
        o[k] = cam.lc[k];
        thr[k] = 1.0f;
      }
      prev = -1.0f;
      alive = true;
    }
    ++segs;
    const float u_rr = draw(uniforms, n, i, key, depth, 0);
    const float u1 = draw(uniforms, n, i, key, depth, 1);
    const float u2 = draw(uniforms, n, i, key, depth, 2);
    const float u_br = draw(uniforms, n, i, key, depth, 3);

    Hit h;
    isect_full(sc, o, d, prev, true, h);
    const int new_depth = depth + 1;
    bool alive_new = false;
    if (h.found) {
      float dn[3], thr_new[3];
      alive_new = shade(d, h.nrm, h.color, h.emis, h.rtype, thr, acc, u_rr,
                        u1, u2, u_br, new_depth, max_depth, rr_start_depth,
                        dn, thr_new);
      if (alive_new) {
        for (int k = 0; k < 3; ++k) {
          o[k] = h.point[k];
          d[k] = dn[k];
          thr[k] = thr_new[k];
        }
        prev = h.new_prev;
      }
    }
    if (!alive_new) {
      ++done;
      alive = false;
    }
    depth = new_depth;
  }

  for (int k = 0; k < 3; ++k) rad[i * 3 + k] = acc[k];
  segs_out[i] = segs;
  done_out[i] = done;
}

}  // namespace

// Launch on `stream`; cam_host points to 14 host floats (CameraConsts.params).
// uniforms is NULL for the counter generator. Returns cudaGetLastError().
extern "C" int pt_trace_regen_prim(
    const float* sph, int n_sph, const float* bnd, int n_bnd,
    const float* tri, int n_tri, const float* tiles, int n_tiles,
    int tile_base, const float* cam_host, int width, int height,
    const int* pixel_idx, int n, uint32_t seed, int sample_base, int quota,
    int max_depth, int rr_start_depth, const float* uniforms, float* rad,
    int* segs, int* done, void* stream) {
  if (n <= 0) return 0;
  const FullScene sc{sph, n_sph, bnd, n_bnd, tri, n_tri, tiles, n_tiles,
                     tile_base};
  if (!full_scene_ok(sc) || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cam cam = make_cam(cam_host, width, height);
  const int blocks = (n + THREADS - 1) / THREADS;
  trace_regen_prim_kernel<<<blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      sc, cam, pixel_idx, n, seed, sample_base, quota, max_depth,
      rr_start_depth, uniforms, rad, segs, done);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
