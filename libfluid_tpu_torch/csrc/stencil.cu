// Kernel C: the masked 7-point Poisson stencil of the multigrid V-cycle and
// of the CG operator.
//
// Replaces libfluid_tpu/sim/multigrid.py:_stencil_kernel (launched through
// _stencil_pass). With x' = x * fluid,
//   A x = scale * (diag * x' - sum_nbr couple * x'_nbr) * fluid
// and the pass writes, by mode:
//   0: A x
//   1: x + damp * inv_diag * (b - A x)     (damped Jacobi)
//   2: b - A x                             (residual)
// The TPU kernel runs on x-planes with three shifted views of a padded x
// and only on levels of >= 2^18 cells (launch overhead there); here one
// thread per cell runs on every level.
//
// Bound: device-memory bandwidth (about 12 floats in, 1 out per cell;
// ~0.1 FLOP per byte). Threads run along z, so every load is coalesced and
// the x/y neighbour loads of adjacent rows hit the caches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stencil_kernel(const float* __restrict__ x, const float* __restrict__ b,
                               const float* __restrict__ diag,
                               const float* __restrict__ inv_diag,
                               const float* __restrict__ fluid,
                               const float* __restrict__ cu, const float* __restrict__ cv,
                               const float* __restrict__ cw, float* __restrict__ out,
                               int nx, int ny, int nz, int mode, float damp, float scale) {
  const long long syz = (long long)ny * nz;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nx * syz) return;
  const int k = (int)(t % nz);
  const int j = (int)((t / nz) % ny);
  const int i = (int)(t / syz);

  const float f = fluid[t];
  const float xm = x[t] * f;
  // neighbours in the order of the plain version's slice adds
  float nbr = 0.0f;
  const long long fu = ((long long)i * ny + j) * nz + k;        // u face i of the cell
  const long long fv = ((long long)i * (ny + 1) + j) * nz + k;  // v face j
  const long long fw = ((long long)i * ny + j) * (nz + 1) + k;  // w face k
  if (i > 0) nbr += cu[fu] * (x[t - syz] * fluid[t - syz]);
  if (i < nx - 1) nbr += cu[fu + syz] * (x[t + syz] * fluid[t + syz]);
  if (j > 0) nbr += cv[fv] * (x[t - nz] * fluid[t - nz]);
  if (j < ny - 1) nbr += cv[fv + nz] * (x[t + nz] * fluid[t + nz]);
  if (k > 0) nbr += cw[fw] * (x[t - 1] * fluid[t - 1]);
  if (k < nz - 1) nbr += cw[fw + 1] * (x[t + 1] * fluid[t + 1]);
  const float ax = scale * (diag[t] * xm - nbr) * f;

  if (mode == 0) {
    out[t] = ax;
  } else if (mode == 1) {
    out[t] = x[t] + damp * inv_diag[t] * (b[t] - ax);
  } else {
    out[t] = b[t] - ax;
  }
}

}  // namespace

// x, b, diag, inv_diag, fluid, out: (nx, ny, nz) f32; cu: (nx+1, ny, nz);
// cv: (nx, ny+1, nz); cw: (nx, ny, nz+1).
extern "C" int lf_stencil(const float* x, const float* b, const float* diag,
                          const float* inv_diag, const float* fluid, const float* cu,
                          const float* cv, const float* cw, float* out, int nx, int ny,
                          int nz, int mode, float damp, float scale, void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, mode, damp, scale);
  return (int)cudaGetLastError();
}
