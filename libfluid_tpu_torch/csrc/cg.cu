// The CG iteration of the pressure solve: its vector updates and reductions
// as two launches beside the V-cycle's.
//
// Replaces the body of the lax.while_loop of libfluid_tpu/sim/pressure.py:_cg
// (jnp there, no Pallas kernel; XLA runs the whole loop on the TPU). An
// iteration of the port's loop (sim/pressure.py:_cg) is
//
//   w = M^-1 r                      the V-cycle (csrc/vcycle.cu), or Jacobi
//   lf_cg_direction                 z = w / m_scale, sigma' = z . r,
//                                   beta = sigma' / safe(sigma) (0 the first
//                                   time), s = z + beta s, q = a_scale A_1 s,
//                                   alpha = sigma' / safe(q . s), sigma = sigma'
//   lf_cg_update                    p += alpha s, r -= alpha q, res = max |r|,
//                                   iterations += 1,
//                                   done = !(res >= tol) || iterations >= max
//
// with safe(x) = x where x != 0, else 1, and A_1 the masked 7-point operator
// of the finest level in kernel C's apply mode (csrc/stencil.cu), written in
// the same order. CG's scalars stay in device memory: sc = {sigma, alpha,
// res, a_scale, m_scale} (float32; a_scale comes from the time step, which
// lives on the device, so it is never passed by value) and st = {iterations,
// done} (int32). Both kernels return at
// once where st's done is set, so the host may enqueue iterations past the
// exit and read `done` some iterations behind the queue: an iteration after
// the exit writes nothing.
//
// Each kernel is one cooperative launch of as many blocks as the card keeps
// resident (at most one per 256 cells), a grid-stride loop over the cells
// and grid.sync() between the steps that need a grid-wide result. A
// reduction is fixed in order: each thread sums its cells in order, a block
// sums its threads in a fixed tree and writes one partial, and after the
// grid's sync every block sums the partials in the same fixed tree. No
// float atomics: two runs on one card give the same bits. Built with
// -fmad=false, so each product and sum rounds as the plain version's
// separate PyTorch operations do (only the reductions' order differs).
//
// Bound: bytes. lf_cg_direction reads w twice, r, s, the operator's five
// masks and s again for the stencil, and writes s and q: ~12 arrays of the
// grid (~100 MB at 128^3, ~30 us at 3.35 TB/s); lf_cg_update reads p, r, s,
// q and writes p, r (~50 MB, ~15 us). The eager loop this replaces spent ~22
// PyTorch launches and a blocking host read on the same work each iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgs = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// at most this many blocks: the partials buffer holds 2 * kMaxBlocks floats
// (pressure._CG_PARTIALS)
constexpr int kMaxBlocks = 2048;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float safe(float x) { return x != 0.0f ? x : 1.0f; }

// the larger of a and b, NaN where either is NaN (torch.amax's rule)
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

// The sum (or, with `max`, the largest) of v over the block's threads, in a
// fixed tree; every thread gets it. `smem` holds kWarps + 1 floats.
template <bool max>
__device__ float block_reduce(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    v = max ? nan_max(v, u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem is free again
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, o);
      v = max ? nan_max(v, u) : v + u;
    }
    if (lane == 0) smem[kWarps] = v;
  }
  __syncthreads();
  return smem[kWarps];
}

// The reduction of the grid's `n` partials, the same tree in every block.
// The partials were written by other blocks before the grid's sync: read
// them from L2, past this SM's L1.
template <bool max>
__device__ float grid_reduce(const float* part, int n, float* smem) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float u = __ldcg(part + i);
    v = max ? nan_max(v, u) : v + u;
  }
  return block_reduce<max>(v, smem);
}

__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(const float* __restrict__ w, const float* __restrict__ r, float* s,
                    float* __restrict__ q, const float* __restrict__ diag,
                    const float* __restrict__ fluid, const float* __restrict__ cu,
                    const float* __restrict__ cv, const float* __restrict__ cw, float scale,
                    int first, float* sc, const int* st, float* part, int nx, int ny, int nz) {
  if (st[1]) return;  // the same value in every block: all return, or none
  __shared__ float smem[kWarps + 1];
  const float a_scale = sc[3], m_scale = sc[4];
  cgs::grid_group grid = cgs::this_grid();
  const long long syz = (long long)ny * nz, n = (long long)nx * syz;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;

  // sigma' = z . r
  float acc = 0.0f;
  for (long long t = t0; t < n; t += stride) acc += (w[t] / m_scale) * r[t];
  acc = block_reduce<false>(acc, smem);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
  grid.sync();
  const float sigma = grid_reduce<false>(part, gridDim.x, smem);
  const float beta = first ? 0.0f : sigma / safe(sc[0]);

  // s = z + beta s (s = z the first time: s holds nothing yet)
  for (long long t = t0; t < n; t += stride) {
    const float z = w[t] / m_scale;
    s[t] = first ? z : z + beta * s[t];
  }
  grid.sync();

  // q = a_scale A_1 s, kernel C's apply mode; q . s. s was written by other
  // blocks: read it from L2.
  acc = 0.0f;
  for (long long t = t0; t < n; t += stride) {
    const int k = (int)(t % nz);
    const int j = (int)((t / nz) % ny);
    const int i = (int)(t / syz);
    const float f = fluid[t];
    const float sv = __ldcg(s + t);
    const float xm = sv * f;
    float nbr = 0.0f;
    const long long fu = ((long long)i * ny + j) * nz + k;
    const long long fv = ((long long)i * (ny + 1) + j) * nz + k;
    const long long fw = ((long long)i * ny + j) * (nz + 1) + k;
    if (i > 0) nbr += cu[fu] * (__ldcg(s + t - syz) * fluid[t - syz]);
    if (i < nx - 1) nbr += cu[fu + syz] * (__ldcg(s + t + syz) * fluid[t + syz]);
    if (j > 0) nbr += cv[fv] * (__ldcg(s + t - nz) * fluid[t - nz]);
    if (j < ny - 1) nbr += cv[fv + nz] * (__ldcg(s + t + nz) * fluid[t + nz]);
    if (k > 0) nbr += cw[fw] * (__ldcg(s + t - 1) * fluid[t - 1]);
    if (k < nz - 1) nbr += cw[fw + 1] * (__ldcg(s + t + 1) * fluid[t + 1]);
    const float qt = (scale * (diag[t] * xm - nbr) * f) * a_scale;
    q[t] = qt;
    acc += qt * sv;
  }
  acc = block_reduce<false>(acc, smem);
  if (threadIdx.x == 0) part[gridDim.x + blockIdx.x] = acc;
  grid.sync();

  // every block has read sigma (sc[0]) before the last sync
  if (blockIdx.x == 0) {
    const float qs = grid_reduce<false>(part + gridDim.x, gridDim.x, smem);
    if (threadIdx.x == 0) {
      sc[1] = sigma / safe(qs);
      sc[0] = sigma;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(float* __restrict__ p, float* __restrict__ r, const float* __restrict__ s,
                 const float* __restrict__ q, float* sc, int* st, float* part, long long n,
                 float tol, int max_iters) {
  if (st[1]) return;  // read by every block before block 0 writes it, after the sync
  __shared__ float smem[kWarps + 1];
  cgs::grid_group grid = cgs::this_grid();
  const long long stride = (long long)gridDim.x * kThreads;
  const float alpha = sc[1];
  float m = 0.0f;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n; t += stride) {
    p[t] = p[t] + alpha * s[t];
    const float rt = r[t] - alpha * q[t];
    r[t] = rt;
    m = nan_max(m, fabsf(rt));
  }
  m = block_reduce<true>(m, smem);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
  grid.sync();
  if (blockIdx.x == 0) {
    const float res = grid_reduce<true>(part, gridDim.x, smem);
    if (threadIdx.x == 0) {
      const int it = st[0] + 1;
      sc[2] = res;
      st[0] = it;
      st[1] = !(res >= tol) || it >= max_iters;
    }
  }
}

// Blocks of a launch over `n` cells: as many as the card keeps resident at
// once (a cooperative launch needs them all resident), at most one per
// kThreads cells and at most kMaxBlocks; the same number at every launch of
// a shape on a device, so a reduction's order is fixed.
int grid_blocks(const void* kernel, long long n, int* blocks) {
  static int resident[2][kMaxDevices];  // per kernel and device, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& cached = resident[kernel == (const void*)cg_update_kernel][dev];
  if (cached == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    cached = sms * per_sm < kMaxBlocks ? sms * per_sm : kMaxBlocks;
    if (cached < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  const long long need = (n + kThreads - 1) / kThreads;
  *blocks = need < cached ? (need > 0 ? (int)need : 1) : cached;
  return 0;
}

int launch(const void* kernel, long long n, void** args, void* stream) {
  int blocks = 0;
  const int e = grid_blocks(kernel, n, &blocks);
  if (e != 0) return e;
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0,
                                                      (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the wrapper raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// w, r, s, q, diag, fluid: (nx, ny, nz) f32; cu: (nx+1, ny, nz); cv: (nx,
// ny+1, nz); cw: (nx, ny, nz+1); sc: 5 f32 {sigma, alpha, res, a_scale,
// m_scale}; st: 2 int32 {iterations, done}; part: 2 * kMaxBlocks f32 of
// scratch. `scale` is the level's operator scale, `first` 1 on the first
// iteration of a solve.
extern "C" int lf_cg_direction(const float* w, const float* r, float* s, float* q,
                               const float* diag, const float* fluid, const float* cu,
                               const float* cv, const float* cw, float scale, int first, float* sc,
                               const int* st, float* part, int nx, int ny, int nz, void* stream) {
  void* args[] = {&w,  &r,  &s,     &q,     &diag, &fluid, &cu, &cv, &cw,
                  &scale, &first, &sc, &st, &part, &nx, &ny, &nz};
  return launch((const void*)cg_direction_kernel, (long long)nx * ny * nz, args, stream);
}

// p, r, s, q: n f32; sc, st, part as lf_cg_direction's.
extern "C" int lf_cg_update(float* p, float* r, const float* s, const float* q, float* sc, int* st,
                            float* part, long long n, float tol, int max_iters, void* stream) {
  void* args[] = {&p, &r, &s, &q, &sc, &st, &part, &n, &tol, &max_iters};
  return launch((const void*)cg_update_kernel, n, args, stream);
}
