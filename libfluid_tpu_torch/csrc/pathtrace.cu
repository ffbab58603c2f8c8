// The persistent path tracer over the uniform-grid accelerator: every path
// of a rendered frame, one thread each, in one launch.
//
// Replaces no TPU kernel. It stands in for the body of the persistent
// lax.while_loop of libfluid_tpu/renderer/pathtrace.py:_trace_persistent_mega
// (jnp there; XLA fuses the loop on the TPU). The port's plain version,
// libfluid_tpu_torch/renderer/pathtrace.py:_trace_persistent_mega, runs that
// body as a Python loop of eager PyTorch over 65,536 lanes: several hundred
// launches an iteration, ~120 iterations a 256^2 x 4 spp frame, so on the
// card it is bound by enqueueing and leaves the device idle.
//
// Design. A persistent grid of as many blocks as the card keeps resident.
// Each warp claims 32 consecutive sample ids with one atomicAdd on a device
// counter, so its first rays leave neighbouring pixels of one row; each
// thread traces its sample to the end, and the warp claims again until the
// counter passes npix * spp. The plain loop's draws are pure functions of
// (seed, sample id, bounce, component) (renderer/draws.py: HashDraws.lane,
// the lowbias32 chain of jitter.cuh here), so each path, and the
// estimator, are the plain loop's whatever the schedule. A path runs, as
// the plain loop runs it for one lane:
//   the camera ray (its jitter is bounce -1), then per bounce
//   accel.init_state: the big-triangle list once, the ray clipped to the
//     grid box, the DDA at the entry cell;
//   accel.step_state until the ray is done: the cell's CSR list in list
//     order (the plain loop's CHUNK of 8 tests a step finds the same
//     nearest hit: the first of equal hits wins either way), then a DDA
//     step or a hop through the proximity field (dist >= 2), until the
//     cell's exit lies past the nearest hit or the ray leaves the grid;
//   intersect.finalize_hit: every sphere, then the position, normal,
//     material and uv;
//   materials.emission_at, intersect.tangent_frame, materials.sample_bsdf
//     of the material's own kind (the plain code computes all three kinds
//     and selects one: the same value), textures bilinear where the scene
//     has any; the throughput and pdf cut, the roulette from rr_start with
//     rr_floor, max_bounces.
// Radiance stays in registers. A finished path adds it to its pixel with
// three float atomics (the plain loop's index_add_ is atomics on the card
// too, so two runs differ in the last bits either way), and each warp adds
// its rays cast to one int64 count.
//
// Arithmetic: built with -fmad=false. Every product, sum and comparison is
// the plain code's as written, in its order and with its float32 constants;
// a float32 tensor divided by a Python number is a product with the
// number's float32 reciprocal, as PyTorch computes it on the card. PyTorch's
// own CUDA kernels sum a trailing axis of 3 as (a + c) + b and fuse the
// multiply-adds of its cross products and 3 x 3 products (measured on an
// H100), so a path leaves the plain loop's on the card only where such a
// last-bit difference falls on a triangle edge or a roulette threshold: on
// two 256^2 x 4 spp frames of dam64 none did (the images 1e-10 apart, the
// rays cast equal).
//
// Bound: the bytes of the triangles, the accelerator, the scene's tables
// and the image, each read or written once: ~20 MB at dam64, ~6 us at
// 3.35 TB/s. What bounds it in fact is the traversal: divergent loops of
// dependent loads (cell, list, triangle) whose latency the resident warps
// hide only in part.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jitter.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;
constexpr float kBig = 3.0e38f;      // accel._BIG, intersect._BIG
constexpr float kRayOffset = 1e-3f;  // pathtrace._RAY_OFFSET
constexpr float kPi = 3.14159265358979323846f;
constexpr uint32_t kTagLane = 0x2545F491u;  // draws._TAG_LANE

struct Tables {
  const float* pack;             // (T + 1, 9) p0 | e1 | e2 (accel.pack_tris)
  const float* tri_normal;       // (T, 3)
  const long long* tri_mat;      // (T,)
  const long long* cell_start;   // (C + 1,)
  const long long* tri_ids;      // (E,)
  const long long* big_ids;      // (B,), -1 padded
  const long long* dist;         // (C,)
  const float* lo;               // (3,)
  const float* cell;             // (3,)
  const float* sph_to_local;     // (S, 3, 4)
  const long long* sph_mat;      // (S,)
  const long long* kind;         // (M,)
  const float* albedo;           // (M, 3)
  const float* ior;              // (M,)
  const float* emission;         // (M, 3)
  const long long* albedo_tex;   // (M,)
  const long long* emission_tex; // (M,)
  const float* textures;         // (NT, TH, TW, 3)
  const long long* tex_hw;       // (NT, 2)
  const float* cam_pos;          // (3,) the camera: Camera.position,
  const float* cam_fwd;          // (3,) norm_forward,
  const float* cam_hh;           // (3,) half_horizontal,
  const float* cam_hv;           // (3,) half_vertical
  int n_big, n_sph, rx, ry, rz, tex_h, tex_w, textured;
};

// draws._uniform(seed, _TAG_LANE, sid, bounce, comp): the top 24 bits of a
// chain of lowbias32 mixes, exactly
__device__ __forceinline__ float lane_uniform(uint32_t seed, uint32_t sid, uint32_t bounce, uint32_t comp) {
  uint32_t h = srl_mix(seed ^ kTagLane);
  h = srl_mix(h ^ sid);
  h = srl_mix(h ^ bounce);
  h = srl_mix(h ^ comp);
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

// a sum over a trailing axis of 3, as written
__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + b) + c; }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// torch.linalg.cross
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// a float32 tensor divided by a Python number on the card: a product with
// the number's float32 reciprocal
__device__ __forceinline__ float div_scalar(float x, float s) { return x * (1.0f / s); }

// accel._moller_trumbore, with the hit test `t < best_t` of the traversal;
// returns early where the result can no longer be a hit
__device__ __forceinline__ bool moller_trumbore(const float* o, const float* d, const float* __restrict__ row,
                                                float best_t, float& t, float& u, float& v) {
  const float p0[3] = {__ldg(row + 0), __ldg(row + 1), __ldg(row + 2)};
  const float e1[3] = {__ldg(row + 3), __ldg(row + 4), __ldg(row + 5)};
  const float e2[3] = {__ldg(row + 6), __ldg(row + 7), __ldg(row + 8)};
  float pv[3];
  cross3(d, e2, pv);
  const float det = dot3(e1, pv);
  if (!(fabsf(det) > 1e-9f)) return false;
  const float inv = 1.0f / det;
  const float tv[3] = {o[0] - p0[0], o[1] - p0[1], o[2] - p0[2]};
  u = dot3(tv, pv) * inv;
  if (!(u >= 0.0f)) return false;
  float qv[3];
  cross3(tv, e1, qv);
  v = dot3(d, qv) * inv;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return false;
  t = dot3(e2, qv) * inv;
  return t > 0.0f && t < best_t;
}

struct Hit {
  float t, u, v;
  long long id;
};

__device__ __forceinline__ void fetch(const Tables& s, const int* c, long long& start, long long& cnt,
                                      long long& dist) {
  long long flat = ((long long)c[0] * s.ry + c[1]) * s.rz + c[2];
  const long long cells = (long long)s.rx * s.ry * s.rz;
  flat = flat < 0 ? 0 : (flat > cells - 1 ? cells - 1 : flat);
  start = __ldg(s.cell_start + flat);
  cnt = __ldg(s.cell_start + flat + 1) - start;
  dist = __ldg(s.dist + flat);
}

__device__ __forceinline__ bool outside(const Tables& s, const int* c) {
  return c[0] < 0 || c[0] >= s.rx || c[1] < 0 || c[1] >= s.ry || c[2] < 0 || c[2] >= s.rz;
}

// floor((p - lo) / cell) as an int, saturated far outside the grid (the
// plain code's int64 of the same floor, for every cell it can compare)
__device__ __forceinline__ int cell_of(float x) {
  const float f = floorf(x);
  return f < -1.0e9f ? -1000000000 : (f > 1.0e9f ? 1000000000 : (int)f);
}

// accel.init_state then accel.step_state until the ray is done: the
// nearest triangle, t in units of |d| (kBig and id -1 where none)
__device__ Hit traverse(const Tables& s, const float* o, const float* d) {
  Hit best = {kBig, 0.0f, 0.0f, -1};
  for (int b = 0; b < s.n_big; ++b) {
    const long long id = __ldg(s.big_ids + b);
    if (id < 0) continue;
    float t, u, v;
    if (moller_trumbore(o, d, s.pack + id * 9, best.t, t, u, v)) best = {t, u, v, id};
  }

  const int res[3] = {s.rx, s.ry, s.rz};
  float inv_d[3], t_delta[3], lo[3], cell[3];
  int step[3];
  float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = __ldg(s.lo + i);
    cell[i] = __ldg(s.cell + i);
    inv_d[i] = fabsf(d[i]) > 1e-30f ? 1.0f / d[i] : kBig;
    step[i] = d[i] > 0.0f ? 1 : (d[i] < 0.0f ? -1 : 0);
    t_delta[i] = fabsf(cell[i] * inv_d[i]);
    const float hi = lo[i] + cell[i] * (float)res[i];
    const float t_lo = (lo[i] - o[i]) * inv_d[i];
    const float t_hi = (hi - o[i]) * inv_d[i];
    t_near = i == 0 ? fminf(t_lo, t_hi) : fmaxf(t_near, fminf(t_lo, t_hi));
    t_far = i == 0 ? fmaxf(t_lo, t_hi) : fminf(t_far, fmaxf(t_lo, t_hi));
  }
  float t_min_delta = kBig;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (step[i] != 0) t_min_delta = fminf(t_min_delta, t_delta[i]);
  }
  const float t_enter = fmaxf(t_near, 0.0f);
  if (t_far < t_enter || t_enter >= best.t) return best;

  int c[3];
  float t_next[3];
  const float t_in = t_enter + 1e-7f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float p = o[i] + d[i] * t_in;
    const int ci = cell_of((p - lo[i]) / cell[i]);
    c[i] = ci < 0 ? 0 : (ci > res[i] - 1 ? res[i] - 1 : ci);
    const float bound = lo[i] + (float)(c[i] + (step[i] > 0)) * cell[i];
    t_next[i] = step[i] == 0 ? kBig : (bound - o[i]) * inv_d[i];
  }
  float t_cur = t_enter;
  long long start, cnt, dist;
  fetch(s, c, start, cnt, dist);

  for (;;) {
    for (long long k = start; k < start + cnt; ++k) {
      const long long id = __ldg(s.tri_ids + k);
      float t, u, v;
      if (moller_trumbore(o, d, s.pack + id * 9, best.t, t, u, v)) best = {t, u, v, id};
    }
    // the cell is exhausted: torch.min's first smallest t_next
    int axis = 0;
    float t_exit = t_next[0];
    if (t_next[1] < t_exit) { t_exit = t_next[1]; axis = 1; }
    if (t_next[2] < t_exit) { t_exit = t_next[2]; axis = 2; }
    if (t_exit >= best.t) break;  // the nearest hit lies before the cell's exit
    int nc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) nc[i] = c[i] + (i == axis ? step[i] : 0);
    if (outside(s, nc)) break;
    if (dist >= 2) {  // a hop through the empty L-inf ball of the proximity field
      const float t_land = (t_cur + (float)(dist - 1) * t_min_delta) + 1e-6f;
      int cj[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) cj[i] = cell_of(((o[i] + d[i] * t_land) - lo[i]) / cell[i]);
      if (outside(s, cj)) break;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        c[i] = cj[i];
        const float bound = lo[i] + (float)(cj[i] + (step[i] > 0)) * cell[i];
        t_next[i] = step[i] == 0 ? kBig : (bound - o[i]) * inv_d[i];
      }
      t_cur = t_land;
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        c[i] = nc[i];
        t_next[i] = t_next[i] + (i == axis ? 1.0f : 0.0f) * t_delta[i];
      }
      t_cur = t_exit;
    }
    fetch(s, c, start, cnt, dist);
  }
  return best;
}

// materials.sample_texture: bilinear, uv wrapped, texel centres at
// (i + 0.5) / n, the edge clamped
__device__ void texture_at(const Tables& s, long long tex, float u, float v, float* out) {
  const float h = (float)__ldg(s.tex_hw + 2 * tex), w = (float)__ldg(s.tex_hw + 2 * tex + 1);
  const float px = (u - floorf(u)) * w + 0.5f, py = (v - floorf(v)) * h + 0.5f;
  const float ix = floorf(px), iy = floorf(py);
  const float fx = px - ix, fy = py - iy;
  const long long x0 = (long long)fmaxf(ix - 1.0f, 0.0f), y0 = (long long)fmaxf(iy - 1.0f, 0.0f);
  const long long x1 = (long long)fminf(ix, w - 1.0f), y1 = (long long)fminf(iy, h - 1.0f);
  const float* base = s.textures + tex * s.tex_h * s.tex_w * 3;
  const float* tl = base + (y0 * s.tex_w + x0) * 3;
  const float* tr = base + (y0 * s.tex_w + x1) * 3;
  const float* bl = base + (y1 * s.tex_w + x0) * 3;
  const float* br = base + (y1 * s.tex_w + x1) * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float top = __ldg(tl + i) + (__ldg(tr + i) - __ldg(tl + i)) * fx;
    const float bot = __ldg(bl + i) + (__ldg(br + i) - __ldg(bl + i)) * fx;
    out[i] = top + (bot - top) * fy;
  }
}

// a material channel (albedo or emission) at uv: materials._channel
__device__ __forceinline__ void channel(const Tables& s, const float* table, const long long* tex_ids, long long mat,
                                        float u, float v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = __ldg(table + 3 * mat + i);
  if (s.textured) {
    float tx[3];
    texture_at(s, __ldg(tex_ids + mat), u, v, tx);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = out[i] * tx[i];
  }
}

// materials.sample_bsdf in RADIANCE mode for the material's own kind:
// the tangent-space direction, its pdf and the BSDF value (pre-divided by
// |cos| for the specular kinds)
__device__ void sample_bsdf(const Tables& s, long long mat, const float* win, float xi0, float xi1, float u,
                            float v, float* dir, float& pdf, float* f) {
  const long long kind = __ldg(s.kind + mat);
  float albedo[3];
  channel(s, s.albedo, s.albedo_tex, mat, u, v, albedo);
  const float cos_in_sgn = win[1];
  if (kind == 1) {  // perfect mirror
    const float abs_cos_in = fmaxf(fabsf(cos_in_sgn), 1e-8f);
    dir[0] = -win[0];
    dir[1] = win[1];
    dir[2] = -win[2];
    pdf = 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) f[i] = albedo[i] / abs_cos_in;
  } else if (kind == 2) {  // dielectric transmission
    const float ior = __ldg(s.ior + mat);
    const bool entering = cos_in_sgn >= 0.0f;
    const float eta_in = entering ? 1.0f : ior, eta_out = entering ? ior : 1.0f;
    const float cos_in = fabsf(cos_in_sgn);
    const float sign = entering ? 1.0f : -1.0f;
    const float eta = eta_in / eta_out;
    const float sin2_out = ((1.0f - cos_in * cos_in) * eta) * eta;
    const bool tir = sin2_out >= 1.0f;
    const float cos_out = tir ? 0.0f : sqrtf(1.0f - sin2_out);
    float fres = 1.0f;
    if (!tir) {  // materials.fresnel_dielectric
      const float r_par = (eta_out * cos_in - eta_in * cos_out) / (eta_out * cos_in + eta_in * cos_out);
      const float r_perp = (eta_in * cos_in - eta_out * cos_out) / (eta_in * cos_in + eta_out * cos_out);
      fres = 0.5f * (r_par * r_par + r_perp * r_perp);
    }
    if (tir) {
      dir[0] = -win[0];
      dir[1] = win[1];
      dir[2] = -win[2];
      pdf = 1.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = albedo[i] / cos_in;
    } else if (xi0 > fres) {  // refraction
      const float m = -eta;
      dir[0] = m * win[0];
      dir[1] = m * win[1] + (eta * cos_in - cos_out) * sign;
      dir[2] = m * win[2];
      pdf = 1.0f - fres;
      const float eta2 = eta * eta;
      const float co = fmaxf(cos_out, 1e-8f);
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = (((1.0f - fres) * albedo[i]) / co) * eta2;
    } else {  // Fresnel reflection
      dir[0] = -win[0];
      dir[1] = win[1];
      dir[2] = -win[2];
      pdf = fres;
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = (fres * albedo[i]) / cos_in;
    }
  } else {  // lambertian, double-sided: the concentric disk's cosine warp
    const float ox = 2.0f * xi0 - 1.0f, oy = 2.0f * xi1 - 1.0f;
    float px = 0.0f, py = 0.0f;
    if (!(ox == 0.0f && oy == 0.0f)) {
      const bool use_x = fabsf(ox) > fabsf(oy);
      const float r = use_x ? ox : oy;
      const float theta = use_x ? (kPi / 4.0f) * (oy / ox) : (kPi / 2.0f) - (kPi / 4.0f) * (ox / oy);
      px = r * cosf(theta);
      py = r * sinf(theta);
    }
    const float z = sqrtf(fmaxf((1.0f - px * px) - py * py, 0.0f));
    dir[0] = px;
    dir[1] = cos_in_sgn < 0.0f ? -z : z;
    dir[2] = py;
    pdf = div_scalar(fabsf(dir[1]), kPi);
#pragma unroll
    for (int i = 0; i < 3; ++i) f[i] = div_scalar(albedo[i], kPi);
  }
}

struct Frame {
  int width, npix;
  long long total;
  int max_bounces, rr_start;
  float rr_floor, inv_w, inv_h;
  uint32_t seed;
};

// One path of sample `sid`; returns its rays cast and adds its radiance to
// the image.
__device__ int trace_path(const Tables& s, const Frame& fr, long long sid, float* __restrict__ img) {
  const int pix = (int)(sid % fr.npix);
  const uint32_t usid = (uint32_t)sid;
  float o[3], d[3];
  {  // _Lanes.respawn: the jittered camera ray, normalized
    const float sx = ((float)(pix % fr.width) + lane_uniform(fr.seed, usid, 0xFFFFFFFFu, 0)) * fr.inv_w;
    const float sy = ((float)(pix / fr.width) + lane_uniform(fr.seed, usid, 0xFFFFFFFFu, 1)) * fr.inv_h;
    const float ax = sx * 2.0f - 1.0f, ay = sy * 2.0f - 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[i] = __ldg(s.cam_pos + i);
      d[i] = (__ldg(s.cam_fwd + i) + ax * __ldg(s.cam_hh + i)) + ay * __ldg(s.cam_hv + i);
    }
    const float n = fmaxf(sqrtf(dot3(d, d)), 1e-30f);
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = d[i] / n;
  }
  float rad[3] = {0.0f, 0.0f, 0.0f}, tp[3] = {1.0f, 1.0f, 1.0f};
  int casts = 0;
  for (int bounce = 0;; ++bounce) {
    const Hit tri = traverse(s, o, d);
    ++casts;

    // intersect.finalize_hit: the spheres, first of equal hits
    float s_t = kBig, ol[3] = {0.0f, 0.0f, 0.0f}, dl[3] = {0.0f, 0.0f, 0.0f};
    int sj = 0;
    for (int k = 0; k < s.n_sph; ++k) {
      if (__ldg(s.sph_mat + k) <= 0) continue;
      const float* m = s.sph_to_local + 12 * k;
      float a_o[3], a_d[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float r[3] = {__ldg(m + 4 * i), __ldg(m + 4 * i + 1), __ldg(m + 4 * i + 2)};
        a_o[i] = fminf(fmaxf(dot3(r, o) + __ldg(m + 4 * i + 3), -1e15f), 1e15f);
        a_d[i] = dot3(r, d);
      }
      const float a = dot3(a_d, a_d);
      const float b = 2.0f * dot3(a_o, a_d);
      const float c = dot3(a_o, a_o) - 1.0f;
      const float disc = b * b - (4.0f * a) * c;
      const float sq = disc > 0.0f ? sqrtf(disc) : 0.0f;
      const float t_near = (-b - sq) / (2.0f * a), t_far = (-b + sq) / (2.0f * a);
      const float t = t_near > 0.0f ? t_near : t_far;
      if (disc >= 0.0f && t > 0.0f && t < s_t) {
        s_t = t;
        sj = k;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ol[i] = a_o[i];
          dl[i] = a_d[i];
        }
      }
    }
    const bool use_sphere = s_t < tri.t;
    const float best_t = use_sphere ? s_t : tri.t;
    if (!(best_t < kBig)) break;  // a miss: the path ends

    float pos[3], nrm[3], u, v;
    long long mat;
#pragma unroll
    for (int i = 0; i < 3; ++i) pos[i] = o[i] + d[i] * best_t;
    if (use_sphere) {
      const float* m = s.sph_to_local + 12 * sj;
      const float tl = fminf(s_t, 1e12f);
      float lp[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) lp[i] = ol[i] + dl[i] * tl;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        nrm[i] = sum3(__ldg(m + i) * lp[0], __ldg(m + 4 + i) * lp[1], __ldg(m + 8 + i) * lp[2]);
      }
      const float n = fmaxf(sqrtf(dot3(nrm, nrm)), 1e-30f);
#pragma unroll
      for (int i = 0; i < 3; ++i) nrm[i] = nrm[i] / n;
      mat = __ldg(s.sph_mat + sj);
      const float phi = atan2f(lp[2], lp[0]);
      const float theta = acosf(fminf(fmaxf(lp[1], (float)(-1.0 + 1e-6)), (float)(1.0 - 1e-6)));
      u = div_scalar(phi, (float)(2.0 * 3.14159265358979323846)) + 0.5f;
      v = div_scalar(theta, kPi);
    } else {
      const long long id = tri.id < 0 ? 0 : tri.id;
#pragma unroll
      for (int i = 0; i < 3; ++i) nrm[i] = __ldg(s.tri_normal + 3 * id + i);
      mat = __ldg(s.tri_mat + id);
      u = tri.u;
      v = tri.v;
    }

    float emis[3];
    channel(s, s.emission, s.emission_tex, mat, u, v, emis);
#pragma unroll
    for (int i = 0; i < 3; ++i) rad[i] = rad[i] + tp[i] * emis[i];

    // intersect.tangent_frame: rows x, the normal, z
    float fx[3], fz[3];
    {
      const float a0 = fabsf(nrm[0]), a1 = fabsf(nrm[1]), a2 = fabsf(nrm[2]);
      const bool use_x = a0 <= a1 && a0 <= a2;
      const bool use_y = !use_x && a1 <= a2;
      const float axis[3] = {use_x ? 1.0f : 0.0f, (!use_x && use_y) ? 1.0f : 0.0f, (!use_x && !use_y) ? 1.0f : 0.0f};
      cross3(nrm, axis, fx);
      if (!(dot3(fx, fx) > 1e-24f)) {
        fx[0] = 1.0f;
        fx[1] = 0.0f;
        fx[2] = 0.0f;
      }
      const float n = fmaxf(sqrtf(dot3(fx, fx)), 1e-30f);
#pragma unroll
      for (int i = 0; i < 3; ++i) fx[i] = fx[i] / n;
      cross3(fx, nrm, fz);
    }
    const float md[3] = {-d[0], -d[1], -d[2]};
    const float win[3] = {dot3(fx, md), dot3(nrm, md), dot3(fz, md)};

    const uint32_t ub = (uint32_t)bounce;
    const float xi0 = lane_uniform(fr.seed, usid, ub, 0), xi1 = lane_uniform(fr.seed, usid, ub, 1);
    const float rr = lane_uniform(fr.seed, usid, ub, 2);
    float dir[3], pdf, f[3];
    sample_bsdf(s, mat, win, xi0, xi1, u, v, dir, pdf, f);

    // pathtrace._shade: the attenuation, the next ray
    const float q = fabsf(dir[1]) / fmaxf(pdf, 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) tp[i] = tp[i] * (f[i] * q);
    const float tmax = fmaxf(fmaxf(tp[0], tp[1]), tp[2]);
    bool alive = tmax > 1e-7f && pdf > 1e-12f;
    if (bounce >= fr.rr_start) {  // pathtrace._roulette
      const float p = fminf(fmaxf(tmax, fr.rr_floor), 1.0f);
      const bool survive = rr < p;
      if (alive && survive) {
#pragma unroll
        for (int i = 0; i < 3; ++i) tp[i] = tp[i] / p;
      }
      alive = alive && survive;
    }
    if (!alive || bounce + 1 >= fr.max_bounces) break;
    const float off = (dir[1] > 0.0f ? 1.0f : -1.0f) * kRayOffset;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      d[i] = sum3(fx[i] * dir[0], nrm[i] * dir[1], fz[i] * dir[2]);
      o[i] = pos[i] + nrm[i] * off;
    }
  }
  if (rad[0] != 0.0f || rad[1] != 0.0f || rad[2] != 0.0f) {  // adding zeros changes nothing
#pragma unroll
    for (int i = 0; i < 3; ++i) atomicAdd(img + 3 * pix + i, rad[i]);
  }
  return casts;
}

__global__ void __launch_bounds__(kThreads) pathtrace_kernel(Tables s, Frame fr, float* __restrict__ img,
                                                             unsigned long long* __restrict__ ctr) {
  const int lane = threadIdx.x & 31;
  unsigned long long casts = 0;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(ctr, 32ull);
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (base >= (unsigned long long)fr.total) break;
    const long long sid = (long long)base + lane;
    if (sid < fr.total) casts += trace_path(s, fr, sid, img);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) casts += __shfl_xor_sync(0xFFFFFFFFu, casts, off);
  if (lane == 0 && casts) atomicAdd(ctr + 1, casts);
}

// Blocks of a launch: as many as the card keeps resident, at most one per
// kThreads samples.
int grid_blocks(long long total, int* blocks) {
  static int resident[kMaxDevices];  // per device, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pathtrace_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long need = (total + kThreads - 1) / kThreads;
  *blocks = need < resident[dev] ? (need > 0 ? (int)need : 1) : resident[dev];
  return 0;
}

}  // namespace

// pack (T + 1, 9), tri_normal (T, 3), tri_mat (T,); the accelerator's
// cell_start (C + 1,), tri_ids (E,), big_ids (n_big,), dist (C,), lo (3,),
// cell (3,); sph_to_local (n_sph, 3, 4), sph_mat (n_sph,); the material
// table's kind, albedo, ior, emission, albedo_tex, emission_tex, textures
// (NT, tex_h, tex_w, 3), tex_hw (NT, 2) (read where `textured`); the
// camera's position, forward, half horizontal and half vertical (3,) each;
// img (npix, 3)
// f32 and ctr (2,) int64 {samples claimed, rays cast}, both zeroed. Integer
// tensors are int64.
extern "C" int lf_pathtrace(const float* pack, const float* tri_normal, const long long* tri_mat,
                            const long long* cell_start, const long long* tri_ids, const long long* big_ids,
                            const long long* dist, const float* lo, const float* cell, const float* sph_to_local,
                            const long long* sph_mat, const long long* kind, const float* albedo, const float* ior,
                            const float* emission, const long long* albedo_tex, const long long* emission_tex,
                            const float* textures, const long long* tex_hw, const float* cam_pos,
                            const float* cam_fwd, const float* cam_hh, const float* cam_hv, float* img,
                            long long* ctr, int n_big, int n_sph, int rx, int ry, int rz, int tex_h, int tex_w,
                            int textured, int width, int height, int spp, int max_bounces, int rr_start,
                            float rr_floor, float inv_w, float inv_h, int seed, void* stream) {
  const Tables s = {pack, tri_normal, tri_mat, cell_start, tri_ids, big_ids, dist, lo, cell, sph_to_local, sph_mat,
                    kind, albedo, ior, emission, albedo_tex, emission_tex, textures, tex_hw, cam_pos, cam_fwd,
                    cam_hh, cam_hv,
                    n_big, n_sph, rx, ry, rz, tex_h, tex_w, textured};
  const Frame fr = {width, width * height, (long long)width * height * spp, max_bounces, rr_start,
                    rr_floor, inv_w, inv_h, (uint32_t)seed};
  int blocks = 0;
  const int e = grid_blocks(fr.total, &blocks);
  if (e != 0) return e;
  pathtrace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(s, fr, img, (unsigned long long*)ctr);
  return (int)cudaGetLastError();
}
