// Kernel F': the vector-Jacobian product of the mesher's surface node pass
// (kernel F, csrc/surface.cu) with respect to the particle positions.
//
// Stands in for libfluid_tpu/mesher/surface.py:_surface_bwd, which takes
// jax.vjp of the scatter oracle around _surface_kernel. The forward that
// wants a gradient (lf_surface_keep) kept each node's sums (W_n, X_n); from
// them, the node values' cotangent g_n and the node position x_n this kernel
// forms per node, where W_n > 0 (else zeros), with diff = X_n / W_n - x_n,
//
//   a_n = g_n diff / (sqrt(|diff|^2 + 1e-30) max(W_n, 1e-30)),  b_n = a_n . diff
//
// in kernel F's expression order (the same bits as F's node pass would give
// them): the cotangent of X_n is a_n and that of W_n is -(a_n . x_n + b_n).
// Then every binned particle p gathers, over the (2 cr)^3 nodes its bin
// reaches that lie in the node grid, with d = x_p - x_n and
// kl = max(1 - |d|^2 / ext^2, 0),
//
//   d x_p = sum_n (a_n . d - b_n) * 3 kl^2 * (-2 d / ext^2) + a_n kl^3.
//
// kl is clamped at 0, so a node at or beyond the extent adds nothing, as the
// oracle's where(kl > 0, ...) has it; a . x_p - a . avg is formed from d and
// from b (both of the support's size), not from world coordinates. A gather:
// no atomics, the same bits from run to run, whatever the tiles.
//
// Bound: operations, ~29 a particle and node within its extent (2.0M
// particles x 268 nodes at the main path: 0.23 ms; the loop runs over the 512
// nodes of the window); the bytes (20 B a node read, 24 B a particle) are less.
//
// Design: one block per tile of TB^3 bins of the padded bin grid (the CSR
// bins the forward sorted the particles into), a thread a particle.
//   1. The tile's TB x TB rows of bins along z are contiguous ranges of the
//      sorted particles; two loads a plane of rows, then the rows' own ends,
//      tell the tiles with no particle (most of the grid), which return.
//   2. The tile's particles form one list, row after row; each row's bin
//      starts are kept as places in that list, so a particle's bin, and with
//      it its window of nodes, comes from the binning itself and not from a
//      second rounding of its position.
//   3. The nodes the tile reaches are a box of TB + 2 cr - 1 nodes an axis.
//      Its (a, b) words are formed as they go to shared memory (~20
//      operations a node, each node ~6.6 times at cr = 4: a few per cent of
//      the pairs' work), nodes outside the node grid as zeros: the whole box
//      if it fits SLAB_NODES words (cr <= 4), else a slab of (x, y) lines
//      along z at a time, in line order, the particle's sums staying in
//      registers across the slabs. THREADS particles are in flight at a
//      time; a tile with more (a crammed bin) takes its list in rounds, and
//      with several slabs stages them again each round.
//   4. A particle walks its window x, y, z ascending, so its bits depend on
//      neither the tile nor the slabs, and stores its three sums at its row
//      of the sorted order; the wrapper puts them back through the sort's
//      order. Particles outside the padded grid are in no bin and keep the
//      wrapper's zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;           // bins a tile and axis
constexpr int ROWS = TB * TB;   // its rows of bins along z
constexpr int THREADS = 256;
constexpr int SLAB_NODES = 3584;  // 16-byte words of shared memory for the nodes

// ONE_SLAB: the whole box of nodes fits shared memory (cr <= 4); the
// window's lines then need no clipping to the slab
template <bool ONE_SLAB>
__global__ void __launch_bounds__(THREADS)
surface_bwd_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
                   const float4* __restrict__ sums, const float* __restrict__ cot,
                   float* __restrict__ out, int mx, int my, int mz, int cr, float h, float ox,
                   float oy, float oz, float ext2) {
  extern __shared__ float4 nodes[];  // SLAB_NODES
  __shared__ int glo[ROWS];          // a row's first particle in `pos`
  __shared__ int rb[ROWS + 1];       // its place in the tile's list
  __shared__ int lstart[ROWS][TB + 1];  // its bins' places in the list
  const int n2 = 2 * cr;
  const int BX = mx + n2, BY = my + n2, BZ = mz + n2;  // the padded bin grid
  const int t0x = blockIdx.z * TB, t0y = blockIdx.y * TB, t0z = blockIdx.x * TB;

  // 1. is any particle in the tile? First its planes of rows over all z
  int any = 0;
  for (int lx = threadIdx.x; lx < TB; lx += THREADS) {
    const long long bx = t0x + lx;
    if (bx < BX)
      any |= starts[(bx * BY + min(t0y + TB, BY)) * BZ] - starts[(bx * BY + t0y) * BZ];
  }
  if (!__syncthreads_or(any)) return;
  // then the rows' own ends; bins past the padded grid are empty
  const int z1 = min(t0z + TB, BZ);
  any = 0;
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int bx = t0x + r / TB, by = t0y + r % TB;
    int lo = 0, n = 0;
    if (bx < BX && by < BY) {
      const long long row = ((long long)bx * BY + by) * BZ;
      lo = starts[row + t0z];
      n = starts[row + z1] - lo;
    }
    glo[r] = lo;
    rb[r + 1] = n;  // its length, for the scan below
    any |= n;
  }
  if (!__syncthreads_or(any)) return;

  // 2. each row's place in the list, then its bins' places
  if (threadIdx.x == 0) {
    int before = 0;
    for (int r = 0; r < ROWS; ++r) {
      const int n = rb[r + 1];
      rb[r] = before;
      before += n;
    }
    rb[ROWS] = before;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ROWS * (TB + 1); t += THREADS) {
    const int r = t / (TB + 1), z = t % (TB + 1);
    const int bx = t0x + r / TB, by = t0y + r % TB;
    int place = rb[r];
    if (bx < BX && by < BY)
      place += starts[((long long)bx * BY + by) * BZ + min(t0z + z, BZ)] - glo[r];
    lstart[r][z] = place;
  }
  const int total = rb[ROWS];

  // 3. the box of nodes the tile reaches: bin b (padded) reaches the nodes
  // b - 2 cr + 1 ... b
  const int w = TB + n2 - 1;  // nodes an axis of the box
  const int n0x = t0x - n2 + 1, n0y = t0y - n2 + 1, n0z = t0z - n2 + 1;
  const int lines = w * w;  // its (x, y) lines of w nodes along z
  const int sl = ONE_SLAB ? lines : min(lines, SLAB_NODES / w);  // lines a slab
  const float inv_ext2 = 1.0f / ext2;
  const float slope = -6.0f * inv_ext2;  // 3 kl^2 * (-2 / ext^2)

  for (int e0 = 0; e0 < total; e0 += THREADS) {
    const int e = e0 + threadIdx.x;
    const bool has = e < total;
    float px = 0.f, py = 0.f, pz = 0.f;
    int lbx = 0, lby = 0, lbz = 0;  // the particle's bin in the tile = its window's corner in the box
    long long row_in_pos = 0;
    __syncthreads();  // the places are written (first round)
    if (has) {
      int r = 0;  // the last row with rb[r] <= e
      for (int step = ROWS / 2; step > 0; step >>= 1)
        if (rb[r + step] <= e) r += step;
      int z = 0;  // the last bin of the row with lstart[r][z] <= e
      for (int step = TB / 2; step > 0; step >>= 1)
        if (lstart[r][z + step] <= e) z += step;
      lbx = r / TB;
      lby = r % TB;
      lbz = z;
      row_in_pos = (long long)glo[r] + (e - rb[r]);
      const float* p = pos + 3 * row_in_pos;
      px = p[0];
      py = p[1];
      pz = p[2];
    }
    float gx = 0.f, gy = 0.f, gz = 0.f;

    for (int s0 = 0; s0 < lines; s0 += sl) {  // the lines [s0, s1)
      const int s1 = min(s0 + sl, lines);
      if (!ONE_SLAB || e0 == 0) {
        __syncthreads();  // the last slab is read
        for (int t = threadIdx.x; t < (s1 - s0) * w; t += THREADS) {
          const int line = s0 + t / w, lz = t % w;
          const int a = n0x + line / w, b = n0y + line % w, c = n0z + lz;
          float4 word = make_float4(0.f, 0.f, 0.f, 0.f);
          if (a >= 0 && a <= mx && b >= 0 && b <= my && c >= 0 && c <= mz) {
            const long long at = ((long long)a * (my + 1) + b) * (mz + 1) + c;
            const float4 sum = sums[at];  // (W, X, Y, Z)
            if (sum.x > 0.0f) {
              const float nxp = ox + (float)a * h, nyp = oy + (float)b * h, nzp = oz + (float)c * h;
              const float Wc = fmaxf(sum.x, 1e-30f);
              const float dx = sum.y / Wc - nxp, dy = sum.z / Wc - nyp, dz = sum.w / Wc - nzp;
              const float norm = sqrtf(dx * dx + dy * dy + dz * dz + 1e-30f);
              const float s = cot[at] / (norm * Wc);
              const float ax = s * dx, ay = s * dy, az = s * dz;
              word = make_float4(ax, ay, az, ax * dx + ay * dy + az * dz);
            }
          }
          nodes[t] = word;
        }
        __syncthreads();
      }
      if (!has) continue;
      for (int lx = lbx; lx < lbx + n2; ++lx) {
        // the slab's lines of plane lx in the window
        const int y_lo = ONE_SLAB ? lby : max(lby, s0 - lx * w);
        const int y_hi = ONE_SLAB ? lby + n2 : min(lby + n2, s1 - lx * w);
        if (!ONE_SLAB && y_lo >= y_hi) continue;
        const float dx = px - (ox + (float)(n0x + lx) * h);
        for (int ly = y_lo; ly < y_hi; ++ly) {
          const float dy = py - (oy + (float)(n0y + ly) * h);
          const float dxy = dx * dx + dy * dy;
          const float4* line = nodes + (lx * w + ly - s0) * w;
#pragma unroll 2
          for (int lz = lbz; lz < lbz + n2; ++lz) {
            const float4 n = line[lz];
            const float dz = pz - (oz + (float)(n0z + lz) * h);
            const float kl = fmaxf(1.0f - (dxy + dz * dz) * inv_ext2, 0.0f);
            const float k2 = kl * kl;
            const float t = (n.x * dx + n.y * dy + n.z * dz - n.w) * (k2 * slope);
            const float k3 = k2 * kl;
            gx += t * dx + n.x * k3;
            gy += t * dy + n.y * k3;
            gz += t * dz + n.z * k3;
          }
        }
      }
    }
    if (has) {
      float* o = out + 3 * row_in_pos;
      o[0] = gx;
      o[1] = gy;
      o[2] = gz;
    }
  }
}

}  // namespace

// pos: (M, 3) f32 particles sorted by padded bin; starts: ((mx+2cr)(my+2cr)(mz+2cr) + 1)
// int32 CSR starts; sums: (mx+1, my+1, mz+1, 4) f32, 16-byte aligned, from
// lf_surface_keep; cot: (mx+1, my+1, mz+1) f32, the node values' cotangent;
// out: (M, 3) f32 in the sorted order, zero-filled by the caller (rows of
// unbinned particles are not written); any cr >= 1.
extern "C" int lf_surface_bwd(const float* pos, const int* starts, const float* sums,
                              const float* cot, float* out, int mx, int my, int mz, int cr, float h,
                              float ox, float oy, float oz, float ext2, void* stream) {
  if (cr < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = SLAB_NODES * sizeof(float4);
  const int n2 = 2 * cr, w = TB + n2 - 1;
  auto kernel = w * w * w <= SLAB_NODES ? surface_bwd_kernel<true> : surface_bwd_kernel<false>;
  // above 48 KB a kernel has to ask for its dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((mz + n2 + TB - 1) / TB, (my + n2 + TB - 1) / TB, (mx + n2 + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, starts, reinterpret_cast<const float4*>(sums), cot, out, mx, my, mz, cr, h, ox, oy, oz,
      ext2);
  return (int)cudaGetLastError();
}
