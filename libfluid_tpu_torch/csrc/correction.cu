// Kernel E: position-correction springs over the slot grid.
//
// Replaces libfluid_tpu/sim/kernels.py:_correction_kernel (launched through
// correction_springs_pallas). For every resident slot i = (k < KC, cell)
// with mask 1 it computes
//
//   spring_i = x_i * sum_j w_ij - sum_j w_ij x_j + coin_i * jitter(seed, g, k, c)
//   w_ij     = (1 - d^2/re2)^3 / d   (0 where d^2 < 1e-12)
//
// over the KC slots j of the 27 neighbour cells inside the grid, the slot
// itself excluded; coin_i counts the pairs with d^2 < 1e-12 and the jitter
// is libfluid_tpu_torch/sim/jitterhash.py's hash of (seed, global cell,
// slot, component), here in uint32 arithmetic (logical shifts).
//
// Design: one thread per resident slot, z-fastest so neighbouring threads
// read neighbouring cells; a thread whose slot is empty writes 0 and
// returns. No Newton's-third-law half sweep, no x-plane blocks or lane
// rolls and no KC_LO split: each slot sums its own 27*KC pairs, so nothing
// is accumulated across threads and no atomics are needed. 1/d is
// 1.0f / sqrtf(sq) (not rsqrtf), the file is built without fast math.
//
// Reads: res_pos (3, KC, C) and res_mask (KC, C) from contiguous tensors
// (the wrapper passes the slot grid's own columns, which are contiguous
// when KC equals the slot capacity, or one contiguous copy otherwise).
//
// Bound: loads. An occupied slot loads 27*KC masks and the positions of the
// occupied ones (~5 KB at KC = 12), served by L1/L2 since the 27 cells
// around neighbouring threads overlap; the 302 MB output at 128^3 is
// written once. Empty slots, the majority, cost one load and one store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t srl_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// jitterhash.jitter_value: the int32 hash bits scaled by 2^-31
__device__ __forceinline__ float jitter_value(uint32_t seed, int gx, int gy, int gz, int k,
                                              int c) {
  uint32_t t = (uint32_t)gx * 198491317u + (uint32_t)gy * 6542989u + (uint32_t)gz * 362437u +
               (uint32_t)k * 87178291u + (uint32_t)c * 1299709u;
  const uint32_t b = srl_mix(srl_mix(t ^ seed));
  return (float)(int32_t)b * (1.0f / 2147483648.0f);
}

__global__ void correction_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                                  float* __restrict__ out, int KC, int nx, int ny, int nz,
                                  float re2, uint32_t seed, int ox, int oy, int oz) {
  const long long C = (long long)nx * ny * nz;
  const long long KCC = (long long)KC * C;
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= KCC) return;
  if (mask[s] == 0.0f) {
    out[s] = 0.0f;
    out[KCC + s] = 0.0f;
    out[2 * KCC + s] = 0.0f;
    return;
  }
  const int k = (int)(s / C);
  const long long cell = s % C;
  const int l = (int)(cell % nz);
  const int j = (int)((cell / nz) % ny);
  const int i = (int)(cell / ((long long)nz * ny));
  const float px = pos[s], py = pos[KCC + s], pz = pos[2 * KCC + s];
  const float mi = mask[s];

  float wsum = 0.f, wx = 0.f, wy = 0.f, wz = 0.f, coin = 0.f;
  for (int dx = -1; dx <= 1; ++dx) {
    const int bx = i + dx;
    if (bx < 0 || bx >= nx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int by = j + dy;
      if (by < 0 || by >= ny) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int bz = l + dz;
        if (bz < 0 || bz >= nz) continue;
        const bool centre = dx == 0 && dy == 0 && dz == 0;
        const long long nb = ((long long)bx * ny + by) * nz + bz;
        for (int k2 = 0; k2 < KC; ++k2) {
          if (centre && k2 == k) continue;
          const long long t = (long long)k2 * C + nb;
          const float pair = mi * mask[t];
          if (pair == 0.0f) continue;
          const float qx = pos[t], qy = pos[KCC + t], qz = pos[2 * KCC + t];
          const float ex = px - qx, ey = py - qy, ez = pz - qz;
          const float sq = ex * ex + ey * ey + ez * ez;
          if (sq < 1e-12f) {
            coin += pair;
            continue;
          }
          const float kl = fmaxf(1.0f - sq / re2, 0.0f);
          const float w = kl * kl * kl * (1.0f / sqrtf(sq)) * pair;
          wsum += w;
          wx += w * qx;
          wy += w * qy;
          wz += w * qz;
        }
      }
    }
  }
  const int gx = i + ox, gy = j + oy, gz = l + oz;
  out[s] = px * wsum - wx + coin * jitter_value(seed, gx, gy, gz, k, 0);
  out[KCC + s] = py * wsum - wy + coin * jitter_value(seed, gx, gy, gz, k, 1);
  out[2 * KCC + s] = pz * wsum - wz + coin * jitter_value(seed, gx, gy, gz, k, 2);
}

}  // namespace

// pos: (3, KC, nx, ny, nz), mask: (KC, nx, ny, nz), out: (3, KC, nx, ny, nz),
// all f32 contiguous; (ox, oy, oz) the global coordinates of local cell 0.
extern "C" int lf_correction(const float* pos, const float* mask, float* out, int KC, int nx,
                             int ny, int nz, float re2, int seed, int ox, int oy, int oz,
                             void* stream) {
  const long long total = (long long)KC * nx * ny * nz;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  correction_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pos, mask, out, KC, nx, ny, nz, re2, (uint32_t)seed, ox, oy, oz);
  return (int)cudaGetLastError();
}
