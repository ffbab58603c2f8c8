// Kernel D': the adjoint of kernel D (PIC/APIC grid-to-particle).
//
// Replaces the backward of G2P, which the JAX package takes by autodiff of
// g2p_from_table (libfluid_tpu/sim/transfers.py:597-641) around its Pallas
// layout kernels _transpose_major and _transpose_rows. Forward, for each
// axis a and each of the 18 faces f around the particle's cell,
//   vel_a   += n0 n1 n2 S_f
//   aff_a,r += (prod_{q != r} n_q) s_r / h * S_f,
// with d_q = coord_q - f_q, n_q = hat(d_q) and s_q the derivative factor on
// the half-open support [-1, 1) (a constant: its own derivative is 0).
// Backward, with cotangents gv (N, 3) and ga (N, 3, 3):
//   S_f bar  = gv_a n0 n1 n2 + sum_r ga_a,r (prod_{q != r} n_q) s_r / h,
//              scattered into u, v, w with atomicAdd;
//   x_q bar += S_f (gv_a n'_q prod_{q' != q} n_q'
//              + sum_{r != q} ga_a,r n'_q s_r prod_{q' != q, r} n_q' / h) / h,
// the second term being the affine rows' dependence on the hats of the
// other two axes. n' takes the JAX package's subgradients (slope -1 at
// d = 0, half the slope at |d| = 1).
//
// One thread per particle. The face cotangents are sums of atomicAdds in
// an order that changes from run to run, so their last bits do too (about
// one float32 rounding per contribution, up to ~50 contributions a face).
//
// Bound: the 54 face loads and up to 54 atomics per particle (2M particles
// at 128^3). Particles arrive in slot order, so neighbouring threads add to
// neighbouring faces; the atomics resolve in L2, where the three face
// arrays (26 MB at 128^3) fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float hat(float d) { return fmaxf(1.0f - fabsf(d), 0.0f); }

// the forward's derivative factor (a constant of the backward)
__device__ __forceinline__ float sfac(float d) {
  return (d >= -1.0f && d < 1.0f) ? (d > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

// d hat / dd with the subgradients of jnp.maximum(1 - jnp.abs(d), 0)
__device__ __forceinline__ float dhat(float d) {
  const float y = 1.0f - fabsf(d);
  const float gate = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
  return d >= 0.0f ? -gate : gate;
}

__global__ void g2p_bwd_kernel(const float* __restrict__ u, const float* __restrict__ v,
                               const float* __restrict__ w, const float* __restrict__ pos,
                               const float* __restrict__ gvel, const float* __restrict__ gaff,
                               float* __restrict__ gu, float* __restrict__ gv,
                               float* __restrict__ gw, float* __restrict__ gpos, long long n,
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
  float* garrs[3] = {gu, gv, gw};
  float gd[3] = {0.0f, 0.0f, 0.0f};  // cotangent of d_q

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int fx = nx + (a == 0), fy = ny + (a == 1), fz = nz + (a == 2);
    const float* arr = arrs[a];
    float* garr = garrs[a];
    const float cv = gvel[3 * p + a];
    const float ca0 = gaff[9 * p + 3 * a] / h, ca1 = gaff[9 * p + 3 * a + 1] / h,
                ca2 = gaff[9 * p + 3 * a + 2] / h;
    float coord[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) coord[q] = g[q] - (q == a ? 0.0f : 0.5f);
    for (int di = (a == 0 ? 0 : -1); di <= 1; ++di) {
      const int ix = cell[0] + di;
      if (ix < 0 || ix >= fx) continue;
      const float d0 = coord[0] - (float)ix;
      const float n0 = hat(d0), s0 = sfac(d0), e0 = dhat(d0);
      for (int dj = (a == 1 ? 0 : -1); dj <= 1; ++dj) {
        const int iy = cell[1] + dj;
        if (iy < 0 || iy >= fy) continue;
        const float d1 = coord[1] - (float)iy;
        const float n1 = hat(d1), s1 = sfac(d1), e1 = dhat(d1);
        for (int dk = (a == 2 ? 0 : -1); dk <= 1; ++dk) {
          const int iz = cell[2] + dk;
          if (iz < 0 || iz >= fz) continue;
          const float d2 = coord[2] - (float)iz;
          const float n2 = hat(d2), s2 = sfac(d2), e2 = dhat(d2);
          const long long f = ((long long)ix * fy + iy) * fz + iz;
          const float gs = cv * n0 * n1 * n2 + ca0 * s0 * n1 * n2 + ca1 * n0 * s1 * n2 +
                           ca2 * n0 * n1 * s2;
          if (gs != 0.0f) atomicAdd(garr + f, gs);
          const float S = arr[f];
          if (S == 0.0f) continue;
          gd[0] += S * (cv * e0 * n1 * n2 + ca1 * e0 * s1 * n2 + ca2 * e0 * n1 * s2);
          gd[1] += S * (cv * n0 * e1 * n2 + ca0 * s0 * e1 * n2 + ca2 * n0 * e1 * s2);
          gd[2] += S * (cv * n0 * n1 * e2 + ca0 * s0 * n1 * e2 + ca1 * n0 * s1 * e2);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) gpos[3 * p + q] = gd[q] / h;
}

}  // namespace

// u: (nx+1, ny, nz), v: (nx, ny+1, nz), w: (nx, ny, nz+1), pos: (n, 3),
// gvel: (n, 3), gaff: (n, 3, 3) f32; gu, gv, gw: face cotangents, zeroed by
// the caller and accumulated here; gpos: (n, 3) position cotangent.
extern "C" int lf_g2p_bwd(const float* u, const float* v, const float* w, const float* pos,
                          const float* gvel, const float* gaff, float* gu, float* gv,
                          float* gw, float* gpos, long long n, int nx, int ny, int nz,
                          float h, float ox, float oy, float oz, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  g2p_bwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u, v, w, pos, gvel, gaff, gu, gv, gw, gpos, n, nx, ny, nz, h, ox, oy, oz);
  return (int)cudaGetLastError();
}
