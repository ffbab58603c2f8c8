// Kernel D: G2P (PIC/APIC grid-to-particle).
//
// Replaces libfluid_tpu/sim/transfers.py:_transpose_major and
// _transpose_rows, the two Pallas kernels of the TPU's G2P. They only pin
// memory layouts around a (C, 64) per-cell sample table and its row gather,
// which the TPU needs to gather fast; this kernel computes what the whole
// of g2p_pic computes, with no table. Per particle: clamp its cell, read the
// 18 face samples per axis straight from u, v, w (zero outside the face
// array's transverse extent), and sum the trilinear velocity and the three
// APIC gradient rows. The derivative factor uses the half-open support
// d in [-1, 1) with sign -1 for d > 0.
//
// Bound: latency of the 54 scattered face loads per particle (2M particles
// at 128^3). Particles arrive in rank-major slot order, so consecutive
// threads sit in consecutive cells and their loads share cache lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float hat(float d) { return fmaxf(1.0f - fabsf(d), 0.0f); }

__device__ __forceinline__ float dhat(float d) {
  return (d >= -1.0f && d < 1.0f) ? (d > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

__global__ void g2p_kernel(const float* __restrict__ u, const float* __restrict__ v,
                           const float* __restrict__ w, const float* __restrict__ pos,
                           float* __restrict__ vel, float* __restrict__ aff, long long n,
                           int nx, int ny, int nz, float h, float ox, float oy, float oz) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float g[3] = {(pos[3 * p] - ox) / h, (pos[3 * p + 1] - oy) / h,
                      (pos[3 * p + 2] - oz) / h};
  const int dims[3] = {nx, ny, nz};
  int cell[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int c = (int)floorf(g[q]);
    cell[q] = c < 0 ? 0 : (c > dims[q] - 1 ? dims[q] - 1 : c);
  }
  const float* arrs[3] = {u, v, w};

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // face array `a` has one extra layer along axis a
    const int fx = nx + (a == 0), fy = ny + (a == 1), fz = nz + (a == 2);
    const float* arr = arrs[a];
    float coord[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) coord[q] = g[q] - (q == a ? 0.0f : 0.5f);
    float val = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    for (int di = (a == 0 ? 0 : -1); di <= 1; ++di) {
      const int ix = cell[0] + di;
      const float d0 = coord[0] - (float)ix;
      const float n0 = hat(d0), s0 = dhat(d0);
      for (int dj = (a == 1 ? 0 : -1); dj <= 1; ++dj) {
        const int iy = cell[1] + dj;
        const float d1 = coord[1] - (float)iy;
        const float n1 = hat(d1), s1 = dhat(d1);
        for (int dk = (a == 2 ? 0 : -1); dk <= 1; ++dk) {
          const int iz = cell[2] + dk;
          if (ix < 0 || ix >= fx || iy < 0 || iy >= fy || iz < 0 || iz >= fz) continue;
          const float d2 = coord[2] - (float)iz;
          const float n2 = hat(d2), s2 = dhat(d2);
          const float sample = arr[((long long)ix * fy + iy) * fz + iz];
          val += n0 * n1 * n2 * sample;
          g0 += s0 * n1 * n2 / h * sample;
          g1 += n0 * s1 * n2 / h * sample;
          g2 += n0 * n1 * s2 / h * sample;
        }
      }
    }
    vel[3 * p + a] = val;
    aff[9 * p + 3 * a] = g0;
    aff[9 * p + 3 * a + 1] = g1;
    aff[9 * p + 3 * a + 2] = g2;
  }
}

}  // namespace

// u: (nx+1, ny, nz), v: (nx, ny+1, nz), w: (nx, ny, nz+1), pos: (n, 3) f32;
// vel: (n, 3), aff: (n, 3, 3) f32 outputs.
extern "C" int lf_g2p(const float* u, const float* v, const float* w, const float* pos,
                      float* vel, float* aff, long long n, int nx, int ny, int nz, float h,
                      float ox, float oy, float oz, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  g2p_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u, v, w, pos, vel, aff, n, nx, ny, nz, h, ox, oy, oz);
  return (int)cudaGetLastError();
}
