// Device pieces shared by the port's kernels (K1 trace_regen.cu, K2
// portal_cheap.cu, K3 portal_resolve.cu, K4 trace_regen_prim.cu): float32
// constants as the JAX kernels round them, the counter-based generator, the
// camera ray, the baked-scene scan and the shading step. Each function
// repeats its plain torch version's operations in the same order, so that a
// build without FMA contraction (--fmad=false) equals it bit for bit:
//  - counter generator: path_tracer_tpu_torch/ops/rng.py;
//  - camera ray: ops/kernels/trace_kernel.py make_raygen;
//  - baked-scene scan: ops/kernels/trace_v2.py prim_scan (JAX
//    trace_v2.make_prim_scan);
//  - shading: ops/kernels/trace_kernel.py shade_phase (JAX
//    trace_kernel.shade_phase).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pt {

// float32 constants exactly as the JAX kernels round them
constexpr float EPS = 0x1.a36e2ep-14f;       // 1e-4: EPS_SPHERE/TRI_DET/TRI_T
constexpr float BIG = 0x1.c363ccp+127f;      // 3e38: miss sentinel
constexpr float TENTH = 0x1.99999ap-4f;      // 0.1
constexpr float TINY = 0x1.4484c0p-100f;     // 1e-30
constexpr float TWO_PI = 0x1.921fb6p+2f;     // 2 * float32(pi)
constexpr float R0 = 0x1.47ae14p-5f;         // ((1.5-1)/(1.5+1))^2
constexpr float ONE_MINUS_R0 = 0x1.eb851ep-1f;
constexpr float INV_IOR = 0x1.555556p-1f;    // 1/1.5
constexpr float IOR = 1.5f;

constexpr int THREADS = 128;

// ---- camera: sensor origin, su, sv, lens center, 1/W, 1/H ----
struct Cam {
  float so[3], su[3], sv[3], lc[3];
  float inv_w, inv_h;
  int width, height;
};

// cam_host: 14 host floats in CameraConsts.params order
inline Cam make_cam(const float* cam_host, int width, int height) {
  Cam cam;
  for (int k = 0; k < 3; ++k) {
    cam.so[k] = cam_host[k];
    cam.su[k] = cam_host[3 + k];
    cam.sv[k] = cam_host[6 + k];
    cam.lc[k] = cam_host[9 + k];
  }
  cam.inv_w = cam_host[12];
  cam.inv_h = cam_host[13];
  cam.width = width;
  cam.height = height;
  return cam;
}

// ---- counter-based generator, keyed by (seed, pixel, sample, depth, slot)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t x) {
  return fmix32(h ^ (x * 0x9E3779B1u + 0x7F4A7C15u));
}

__device__ __forceinline__ uint32_t pixel_key(uint32_t seed, int pix) {
  return mix32(mix32(0u, seed), static_cast<uint32_t>(pix));
}

// trace_kernel._uniform's conversion: top 23 bits as a float in [0, 1)
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Uniform for (path key, segment depth, slot), or the per-lane table
// table[slot * stride + lane] when one is given
__device__ __forceinline__ float draw(const float* __restrict__ table,
                                      int stride, int lane, uint32_t key,
                                      int depth, int slot) {
  if (table != nullptr) return table[slot * stride + lane];
  return to_uniform(mix32(key, static_cast<uint32_t>(depth) * 8u +
                                   static_cast<uint32_t>(slot)));
}

__device__ __forceinline__ float tent(float u) {
  const float r = 2.0f * u;
  return r < 1.0f ? sqrtf(r) - 1.0f : 1.0f - sqrtf(fmaxf(2.0f - r, 0.0f));
}

// pixel index -> (x, y) with the y flip
__device__ __forceinline__ void pixel_xy(const Cam& cam, int pix, float& px,
                                         float& py) {
  const int row = pix / cam.width;
  px = static_cast<float>(pix - row * cam.width);
  py = static_cast<float>(cam.height - 1 - row);
}

// Tent-filtered camera ray of sample s on the 2x2 subpixel grid (s mod 4)
__device__ __forceinline__ void camera_ray(const Cam& cam, float px, float py,
                                           int s, float u1, float u2,
                                           float d[3]) {
  const float xf = tent(u1);
  const float yf = tent(u2);
  const float xsub = static_cast<float>(s & 1);
  const float ysub = static_cast<float>((s >> 1) & 1);
  const float sx = (px + 0.5f * (0.5f + xsub + xf)) * cam.inv_w - 0.5f;
  const float sy = (py + 0.5f * (0.5f + ysub + yf)) * cam.inv_h - 0.5f;
  float dd[3];
  for (int k = 0; k < 3; ++k)
    dd[k] = cam.lc[k] - (cam.so[k] + cam.su[k] * sx + cam.sv[k] * sy);
  const float dl = rsqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
  for (int k = 0; k < 3; ++k) d[k] = dd[k] * dl;
}

// ---- the baked scene: ops/kernels/trace_v2.py COL_* row layout ----
constexpr int PRIM_F = 32;
constexpr int GATE_F = 4;
constexpr int COL_KIND = 0;     // 0 sphere, 1 triangle, 2 quad
constexpr int COL_GEOM = 1;     // sphere: center(3), r2
                                // tri/quad: a, e1, e2, n, unit n, e2 x a,
                                // a x e1 (3 each), a . n
constexpr int COL_COLOR = 23;
constexpr int COL_EMIS = 26;
constexpr int COL_RTYPE = 29;
constexpr int COL_PREVID = 30;
constexpr int COL_GATE = 31;
constexpr int MAX_PRIMS = 128;

// Bounding-sphere gate of make_prim_scan: does the ray reach the sphere?
__device__ __forceinline__ bool gate_hit(const float* g, const float o[3],
                                         const float d[3]) {
  const float opx = g[0] - o[0], opy = g[1] - o[1], opz = g[2] - o[2];
  const float b = opx * d[0] + opy * d[1] + opz * d[2];
  const float det = b * b - (opx * opx + opy * opy + opz * opz) + g[3];
  const float sq = sqrtf(fmaxf(det, 0.0f));
  return det >= 0.0f && (b - sq >= EPS || b + sq >= EPS);
}

// Sequential closest-hit scan of the baked scene (prims and gates in shared
// memory): strictly closer wins, so the first hit wins ties; the departed
// triangle `prev` is excluded. Returns the row hit (-1 for a miss) and its
// distance in tmin (BIG for a miss).
__device__ __forceinline__ int prim_scan(const float* prims, int n_prims,
                                         const float* gates,
                                         const float o[3], const float d[3],
                                         int prev, float& tmin) {
  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  tmin = BIG;
  int best = -1;
  for (int p = 0; p < n_prims; ++p) {
    const float* r = prims + p * PRIM_F;
    const float* g = r + COL_GEOM;
    float t;
    if (r[COL_KIND] == 0.0f) {
      const float opx = g[0] - o[0], opy = g[1] - o[1], opz = g[2] - o[2];
      const float b = opx * d[0] + opy * d[1] + opz * d[2];
      const float det = b * b - (opx * opx + opy * opy + opz * opz) + g[3];
      const float sq = sqrtf(fmaxf(det, 0.0f));
      const float tn = b - sq, tf = b + sq;
      t = tn >= EPS ? tn : (tf >= EPS ? tf : BIG);
      if (det < 0.0f) t = BIG;
    } else {
      // g[0..2] holds a itself; the scan needs it only through the
      // folded e2 x a, a x e1 and a . n
      const float* e1 = g + 3;
      const float* e2 = g + 6;
      const float* nn = g + 9;
      const float* e2xa = g + 15;
      const float* axe1 = g + 18;
      const float na = g[21];
      const float det = -(d[0] * nn[0] + d[1] * nn[1] + d[2] * nn[2]);
      const float udet = (m[0] * e2[0] + m[1] * e2[1] + m[2] * e2[2]) -
                         (d[0] * e2xa[0] + d[1] * e2xa[1] + d[2] * e2xa[2]);
      const float vdet = -(m[0] * e1[0] + m[1] * e1[1] + m[2] * e1[2]) -
                         (d[0] * axe1[0] + d[1] * axe1[1] + d[2] * axe1[2]);
      const float tdet = (o[0] * nn[0] + o[1] * nn[1] + o[2] * nn[2]) - na;
      const bool dvalid = fabsf(det) >= EPS;
      const float inv = 1.0f / (dvalid ? det : 1.0f);
      const float u = udet * inv, v = vdet * inv;
      t = tdet * inv;
      const bool uv_hi = r[COL_KIND] == 2.0f ? (v <= 1.0f) : (u + v <= 1.0f);
      bool valid = dvalid && u >= 0.0f && u <= 1.0f && v >= 0.0f && uv_hi &&
                   t > EPS && prev != static_cast<int>(r[COL_PREVID]);
      const int gate = static_cast<int>(r[COL_GATE]);
      if (valid && gate >= 0) valid = gate_hit(gates + gate * GATE_F, o, d);
      if (!valid) t = BIG;
    }
    if (t < tmin) {
      tmin = t;
      best = p;
    }
  }
  return best;
}

// Hit point and shading normal on baked row r at distance tmin
__device__ __forceinline__ void prim_surface(const float* r, const float o[3],
                                             const float d[3], float tmin,
                                             float point[3], float nrm[3]) {
  for (int k = 0; k < 3; ++k) point[k] = o[k] + d[k] * tmin;
  if (r[COL_KIND] == 0.0f) {
    float sn[3];
    for (int k = 0; k < 3; ++k) sn[k] = point[k] - r[COL_GEOM + k];
    const float sl =
        rsqrtf(fmaxf(sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2], TINY));
    for (int k = 0; k < 3; ++k) nrm[k] = sn[k] * sl;
  } else {
    for (int k = 0; k < 3; ++k) nrm[k] = r[COL_GEOM + 12 + k];
  }
}

// ---- shade_phase for a found hit: Russian roulette, emission, diffuse,
// mirror or always-RR refraction sampling, the unconditional max-depth cut.
// Adds the emission to acc, writes the next direction and throughput, and
// returns whether the path lives on.
__device__ __forceinline__ bool shade(const float d[3], const float nrm[3],
                                      const float* color, const float* emis,
                                      float rtype, const float thr[3],
                                      float acc[3], float u_rr, float u1,
                                      float u2, float u_br, int new_depth,
                                      int max_depth, int rr_start_depth,
                                      float dn[3], float thr_new[3]) {
  const float nd = nrm[0] * d[0] + nrm[1] * d[1] + nrm[2] * d[2];
  const bool to_ray = nd < 0.0f;
  float nl[3];
  for (int k = 0; k < 3; ++k) nl[k] = to_ray ? nrm[k] : -nrm[k];

  const float max_refl = fmaxf(color[0], fmaxf(color[1], color[2]));
  const bool rr_on = new_depth > rr_start_depth;
  const bool survive = (u_rr < max_refl) && (new_depth < max_depth);
  const bool die_rr = rr_on && !survive;
  const float scale = (rr_on && survive) ? 1.0f / fmaxf(max_refl, TINY) : 1.0f;

  for (int k = 0; k < 3; ++k) acc[k] = acc[k] + thr[k] * emis[k];

  float wgt = 1.0f;
  if (rtype < 0.5f) {  // diffuse: cosine-weighted around nl
    const float r1 = TWO_PI * u1;
    const float r2s = sqrtf(u2);
    const bool use_y = fabsf(nl[0]) > TENTH;
    const float upx = use_y ? 0.0f : 1.0f;
    const float upy = use_y ? 1.0f : 0.0f;
    float ux = upy * nl[2];
    float uy = -upx * nl[2];
    float uz = upx * nl[1] - upy * nl[0];
    const float ul = rsqrtf(fmaxf(ux * ux + uy * uy + uz * uz, TINY));
    ux *= ul;
    uy *= ul;
    uz *= ul;
    const float vx = nl[1] * uz - nl[2] * uy;
    const float vy = nl[2] * ux - nl[0] * uz;
    const float vz = nl[0] * uy - nl[1] * ux;
    float sr, cr;
    sincosf(r1, &sr, &cr);
    const float cr1 = cr * r2s, sr1 = sr * r2s;
    const float wz = sqrtf(fmaxf(1.0f - u2, 0.0f));
    const float d0 = ux * cr1 + vx * sr1 + nl[0] * wz;
    const float d1 = uy * cr1 + vy * sr1 + nl[1] * wz;
    const float d2 = uz * cr1 + vz * sr1 + nl[2] * wz;
    const float dl = rsqrtf(fmaxf(d0 * d0 + d1 * d1 + d2 * d2, TINY));
    dn[0] = d0 * dl;
    dn[1] = d1 * dl;
    dn[2] = d2 * dl;
  } else {
    float d_spec[3];
    for (int k = 0; k < 3; ++k) d_spec[k] = d[k] - nrm[k] * 2.0f * nd;
    if (rtype < 1.5f) {  // mirror
      for (int k = 0; k < 3; ++k) dn[k] = d_spec[k];
    } else {  // refract, always-RR branch: weights Re/P, Tr/(1-P)
      const bool into = to_ray;
      const float nnt = into ? INV_IOR : IOR;
      const float ddn = nl[0] * d[0] + nl[1] * d[1] + nl[2] * d[2];
      const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
      const bool tir = cos2t < 0.0f;
      const float tsc = ddn * nnt + sqrtf(fmaxf(cos2t, 0.0f));
      float td[3];
      for (int k = 0; k < 3; ++k) td[k] = d[k] * nnt - nl[k] * tsc;
      const float tl =
          rsqrtf(fmaxf(td[0] * td[0] + td[1] * td[1] + td[2] * td[2], TINY));
      for (int k = 0; k < 3; ++k) td[k] *= tl;
      const float tdn = td[0] * nrm[0] + td[1] * nrm[1] + td[2] * nrm[2];
      const float c = 1.0f - (into ? -ddn : tdn);
      const float c2 = c * c;
      const float re = R0 + ONE_MINUS_R0 * (c * (c2 * c2));
      const float p = 0.25f + 0.5f * re;
      const bool lo = u_br < p;
      for (int k = 0; k < 3; ++k) dn[k] = (lo || tir) ? d_spec[k] : td[k];
      const float w_num = lo ? re : 1.0f - re;
      const float w_den = lo ? p : 1.0f - p;
      wgt = tir ? 1.0f : w_num / w_den;
    }
  }

  for (int k = 0; k < 3; ++k) thr_new[k] = thr[k] * color[k] * scale * wgt;
  const float thr_max = fmaxf(thr_new[0], fmaxf(thr_new[1], thr_new[2]));
  const bool die_depth = new_depth >= max_depth;
  return !die_rr && !die_depth && thr_max > 0.0f;
}

}  // namespace pt
