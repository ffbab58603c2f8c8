// Kernel F: the mesher's surface node pass (Zhu-Bridson implicit surface).
//
// Replaces libfluid_tpu/mesher/surface.py:_surface_kernel (launched through
// _sample_surface_pallas). For every node n of the (mx+1, my+1, mz+1) grid
// it sums, over the particles p within the kernel support,
//
//   w = max(0, 1 - |x_p - x_n|^2 / ext^2)^3,   W = sum w,   X = sum w x_p
//
// and writes |X/W - x_n| - r, or +1 where W = 0.
//
// Design: a gather per node over particles binned by mesher cell in CSR
// form (the wrapper sorts the particles' cell ids and builds the bin
// starts with bincount/cumsum). A particle in cell b reaches nodes
// b - cr + 1 ... b + cr along each axis (cr = ceil(ext/h)), so node n reads
// the (2 cr)^3 cells b = n - cr ... n + cr - 1. The bin grid is padded by
// cr cells on every side, so particles outside the node grid still reach
// the nodes inside it (as in the scatter oracle, whose bounds test is on
// the node); a particle beyond the padding reaches no node and is not
// binned. There is no cap on particles per cell (the TPU kernel's 8-slot
// grid dropped the excess). The 2 cr cells along z are adjacent bins, so
// each (x, y) row of the support is one contiguous range of the sorted
// particles: 4 cr^2 ranges per node. No atomics: deterministic.
//
// Bound: loads of the sorted particles (12 B each) by every node whose
// support holds them, ~(2 cr)^3 = 512 times at cr = 4, served by L1/L2
// because neighbouring threads (z fastest) share all but one z-row of
// their support. Nodes far from the fluid read 4 cr^2 pairs of bin starts
// and write +1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void surface_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
                               float* __restrict__ out, int mx, int my, int mz, int cr,
                               float h, float ox, float oy, float oz, float ext2,
                               float radius) {
  const long long ex = mx + 1, ey = my + 1, ez = mz + 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ex * ey * ez) return;
  const int c = (int)(t % ez);
  const int b = (int)((t / ez) % ey);
  const int a = (int)(t / (ez * ey));
  const long long BY = my + 2 * cr, BZ = mz + 2 * cr;
  const float nx = ox + (float)a * h, ny = oy + (float)b * h, nz = oz + (float)c * h;

  float W = 0.f, X = 0.f, Y = 0.f, Z = 0.f;
  // padded bin index of cell n - cr is n
  for (int px = a; px < a + 2 * cr; ++px) {
    for (int py = b; py < b + 2 * cr; ++py) {
      const long long row = ((long long)px * BY + py) * BZ;
      const int lo = starts[row + c], hi = starts[row + c + 2 * cr];
      for (int q = lo; q < hi; ++q) {
        const float x = pos[3 * (long long)q], y = pos[3 * (long long)q + 1],
                    z = pos[3 * (long long)q + 2];
        const float dx = x - nx, dy = y - ny, dz = z - nz;
        const float kl = 1.0f - (dx * dx + dy * dy + dz * dz) / ext2;
        if (kl > 0.0f) {
          const float w = kl * kl * kl;
          W += w;
          X += w * x;
          Y += w * y;
          Z += w * z;
        }
      }
    }
  }
  float value = 1.0f;
  if (W > 0.0f) {
    const float Wc = fmaxf(W, 1e-30f);
    const float dx = X / Wc - nx, dy = Y / Wc - ny, dz = Z / Wc - nz;
    value = sqrtf(dx * dx + dy * dy + dz * dz + 1e-30f) - radius;
  }
  out[t] = value;
}

}  // namespace

// pos: (M, 3) f32 particles sorted by padded bin; starts: ((mx+2cr)(my+2cr)(mz+2cr) + 1)
// int32 CSR starts; out: (mx+1, my+1, mz+1) f32.
extern "C" int lf_surface(const float* pos, const int* starts, float* out, int mx, int my, int mz,
                          int cr, float h, float ox, float oy, float oz, float ext2,
                          float radius, void* stream) {
  const long long total = (long long)(mx + 1) * (my + 1) * (mz + 1);
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  surface_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pos, starts, out, mx, my, mz, cr, h, ox, oy, oz, ext2, radius);
  return (int)cudaGetLastError();
}
