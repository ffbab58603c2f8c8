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
//
// "stencil16" is the same pass in bfloat16, for the "mg16" preconditioner
// (libfluid_tpu/sim/pressure.py:_cg runs the V-cycle on a bfloat16 copy of
// the levels; the TPU kernel itself takes float32 only, so there the cycle
// runs in XLA). Storage is bfloat16 and every operation rounds its float
// result to bfloat16, in the order of the plain PyTorch version, so the two
// agree bit for bit. Half the bytes of the float32 pass.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// round to bfloat16 and back, as each bfloat16 operation of PyTorch does
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float mul16(float a, float b) { return rb(__fmul_rn(a, b)); }
__device__ __forceinline__ float add16(float a, float b) { return rb(__fadd_rn(a, b)); }
__device__ __forceinline__ float sub16(float a, float b) { return rb(__fsub_rn(a, b)); }

__global__ void stencil16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ b,
                                 const __nv_bfloat16* __restrict__ diag,
                                 const __nv_bfloat16* __restrict__ inv_diag,
                                 const __nv_bfloat16* __restrict__ fluid,
                                 const __nv_bfloat16* __restrict__ cu,
                                 const __nv_bfloat16* __restrict__ cv,
                                 const __nv_bfloat16* __restrict__ cw,
                                 __nv_bfloat16* __restrict__ out, int nx, int ny, int nz,
                                 int mode, float damp, float scale) {
  const long long syz = (long long)ny * nz;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nx * syz) return;
  const int k = (int)(t % nz);
  const int j = (int)((t / nz) % ny);
  const int i = (int)(t / syz);

  const float f = ld(fluid, t);
  const float xm = mul16(ld(x, t), f);
  const long long fu = ((long long)i * ny + j) * nz + k;
  const long long fv = ((long long)i * (ny + 1) + j) * nz + k;
  const long long fw = ((long long)i * ny + j) * (nz + 1) + k;
  // the plain version: nbr = 0, then one rounded += per neighbour, in order
  float nbr = 0.0f;
  if (i > 0) nbr = add16(nbr, mul16(ld(cu, fu), mul16(ld(x, t - syz), ld(fluid, t - syz))));
  if (i < nx - 1)
    nbr = add16(nbr, mul16(ld(cu, fu + syz), mul16(ld(x, t + syz), ld(fluid, t + syz))));
  if (j > 0) nbr = add16(nbr, mul16(ld(cv, fv), mul16(ld(x, t - nz), ld(fluid, t - nz))));
  if (j < ny - 1)
    nbr = add16(nbr, mul16(ld(cv, fv + nz), mul16(ld(x, t + nz), ld(fluid, t + nz))));
  if (k > 0) nbr = add16(nbr, mul16(ld(cw, fw), mul16(ld(x, t - 1), ld(fluid, t - 1))));
  if (k < nz - 1) nbr = add16(nbr, mul16(ld(cw, fw + 1), mul16(ld(x, t + 1), ld(fluid, t + 1))));
  // scale * (diag * x' - nbr) * fluid
  const float ax = mul16(mul16(scale, sub16(mul16(ld(diag, t), xm), nbr)), f);

  float y;
  if (mode == 0) {
    y = ax;
  } else if (mode == 1) {
    // x + damp * inv_diag * (b - A x)
    y = add16(ld(x, t), mul16(mul16(damp, ld(inv_diag, t)), sub16(ld(b, t), ax)));
  } else {
    y = sub16(ld(b, t), ax);
  }
  out[t] = __float2bfloat16_rn(y);
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

// The bfloat16 instance: every array bfloat16, shapes as lf_stencil's.
extern "C" int lf_stencil16(const __nv_bfloat16* x, const __nv_bfloat16* b,
                            const __nv_bfloat16* diag, const __nv_bfloat16* inv_diag,
                            const __nv_bfloat16* fluid, const __nv_bfloat16* cu,
                            const __nv_bfloat16* cv, const __nv_bfloat16* cw,
                            __nv_bfloat16* out, int nx, int ny, int nz, int mode, float damp,
                            float scale, void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil16_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, mode, damp, scale);
  return (int)cudaGetLastError();
}
