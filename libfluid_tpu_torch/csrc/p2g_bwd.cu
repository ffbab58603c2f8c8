// Kernel B': the adjoint of kernel B (P2G face sums from the slot grid).
//
// Replaces the backward of libfluid_tpu/sim/kernels.py:_p2g_kernel, which
// the JAX package takes as jax.vjp of its jnp oracle
// (transfers._p2g_bwd over _p2g_slots_jnp). Forward, each face f = c + d of
// axis a (d_a in {0, 1}, the other two d in {-1, 0, 1}) sums over the K
// slots of cell c
//   num_a[f] += m * H * val,   den_a[f] += m * H,
//   H = prod_q hat(t_q),  t_q = (x_q - o_q) / h - shift_q - f_q,
//   val = v_a + sum_q A_aq * (x_face_q - x_q)   (APIC only).
// Backward, every slot gathers the cotangents (gn, gd) of the faces in its
// staggered support and sums
//   d m     = (gn * val + gd) * H
//   d v_a   = gn * m * H
//   d A_aq  = gn * m * H * (x_face_q - x_q)
//   d x_q   = (gn * val + gd) * m * hat'(t_q) * prod_{q' != q} hat(t_q') / h
//             - gn * m * H * A_aq.
// hat' takes the JAX package's subgradients (slope -1 at t = 0, half the
// slope at |t| = 1), so the result equals jax.vjp of the oracle.
//
// One thread per slot; an empty slot (mask 0: most of the K*C slots) writes
// zeros and returns. A face with some |t_q| > 1 adds nothing and is skipped
// before its loads. No atomics: each thread writes only its own slot's 16
// rows, so the result is the same from run to run.
//
// Bound: the 16-row payload-sized write (1.6 GB at 128^3 / K = 12) and the
// read of the occupied slots; the face cotangents (6 x 8.5 MB at 128^3) are
// re-read by the ~8 slots of each cell around a face and stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float hat(float t) { return fmaxf(1.0f - fabsf(t), 0.0f); }

// d hat / dt with the subgradients of jnp.maximum(1 - jnp.abs(t), 0)
__device__ __forceinline__ float dhat(float t) {
  const float y = 1.0f - fabsf(t);
  const float gate = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
  return t >= 0.0f ? -gate : gate;
}

__global__ void p2g_bwd_kernel(const float* __restrict__ data, const float* __restrict__ gnu,
                               const float* __restrict__ gnv, const float* __restrict__ gnw,
                               const float* __restrict__ gdu, const float* __restrict__ gdv,
                               const float* __restrict__ gdw, float* __restrict__ out, int K,
                               int nx, int ny, int nz, float h, float ox, float oy, float oz,
                               int use_affine) {
  const long long C = (long long)nx * ny * nz;
  const long long col = (long long)K * C;  // stride between payload rows
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= col) return;
  const float m = data[3 * col + s];
  if (m == 0.0f) {
    for (int r = 0; r < 16; ++r) out[r * col + s] = 0.0f;
    return;
  }
  const long long cell = s % C;
  const int c[3] = {(int)(cell / ((long long)ny * nz)), (int)((cell / nz) % ny),
                    (int)(cell % nz)};
  const int dims[3] = {nx, ny, nz};
  const float o[3] = {ox, oy, oz};
  float p[3], gp[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    p[q] = data[q * col + s];
    gp[q] = (p[q] - o[q]) / h;
  }
  const float* gns[3] = {gnu, gnv, gnw};
  const float* gds[3] = {gdu, gdv, gdw};

  float d_m = 0.0f;
  float d_t[3] = {0.0f, 0.0f, 0.0f};  // through the hats, in cell units
  float d_x[3] = {0.0f, 0.0f, 0.0f};  // through val, in world units
  float d_v[3] = {0.0f, 0.0f, 0.0f};
  float d_a[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int fy = ny + (a == 1), fz = nz + (a == 2);
    const float va = data[(4 + a) * col + s];
    float arow[3] = {0.0f, 0.0f, 0.0f};
    if (use_affine) {
#pragma unroll
      for (int q = 0; q < 3; ++q) arow[q] = data[(7 + 3 * a + q) * col + s];
    }
    float shift[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) shift[q] = q == a ? 0.0f : 0.5f;
    for (int dx = (a == 0 ? 0 : -1); dx <= 1; ++dx) {
      const int f0 = c[0] + dx;
      if (f0 < 0 || f0 >= dims[0] + (a == 0)) continue;
      const float t0 = (gp[0] - shift[0]) - (float)f0;
      if (fabsf(t0) > 1.0f) continue;
      for (int dy = (a == 1 ? 0 : -1); dy <= 1; ++dy) {
        const int f1 = c[1] + dy;
        if (f1 < 0 || f1 >= fy) continue;
        const float t1 = (gp[1] - shift[1]) - (float)f1;
        if (fabsf(t1) > 1.0f) continue;
        for (int dz = (a == 2 ? 0 : -1); dz <= 1; ++dz) {
          const int f2 = c[2] + dz;
          if (f2 < 0 || f2 >= fz) continue;
          const float t2 = (gp[2] - shift[2]) - (float)f2;
          if (fabsf(t2) > 1.0f) continue;
          const long long f = ((long long)f0 * fy + f1) * fz + f2;
          const float gn = gns[a][f], gd = gds[a][f];
          const float h0 = hat(t0), h1 = hat(t1), h2 = hat(t2);
          const float H = h0 * h1 * h2;
          const float fc[3] = {(float)f0, (float)f1, (float)f2};
          float val = va;
          float lever[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            lever[q] = ((fc[q] + shift[q]) * h + o[q]) - p[q];
            if (use_affine) val += arow[q] * lever[q];
          }
          const float gw = gn * val + gd;  // cotangent of m * H
          d_m += gw * H;
          const float gwm = gw * m;
          d_t[0] += gwm * dhat(t0) * h1 * h2;
          d_t[1] += gwm * h0 * dhat(t1) * h2;
          d_t[2] += gwm * h0 * h1 * dhat(t2);
          const float gnw_ = gn * m * H;  // cotangent of val
          d_v[a] += gnw_;
          if (use_affine) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              d_a[3 * a + q] += gnw_ * lever[q];
              d_x[q] -= gnw_ * arow[q];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) out[q * col + s] = d_t[q] / h + d_x[q];
  out[3 * col + s] = d_m;
#pragma unroll
  for (int q = 0; q < 3; ++q) out[(4 + q) * col + s] = d_v[q];
#pragma unroll
  for (int r = 0; r < 9; ++r) out[(7 + r) * col + s] = d_a[r];
}

}  // namespace

// data: (16, K, nx, ny, nz) f32 slot payload; gn*/gd*: cotangents of the
// num/den face arrays u (nx+1, ny, nz), v (nx, ny+1, nz), w (nx, ny, nz+1);
// out: (16, K, nx, ny, nz) cotangent of the payload.
extern "C" int lf_p2g_bwd(const float* data, const float* gnu, const float* gnv,
                          const float* gnw, const float* gdu, const float* gdv,
                          const float* gdw, float* out, int K, int nx, int ny, int nz, float h,
                          float ox, float oy, float oz, int use_affine, void* stream) {
  const long long total = (long long)K * nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  p2g_bwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      data, gnu, gnv, gnw, gdu, gdv, gdw, out, K, nx, ny, nz, h, ox, oy, oz, use_affine);
  return (int)cudaGetLastError();
}
