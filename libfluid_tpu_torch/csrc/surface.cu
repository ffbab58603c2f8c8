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
// A gather per node over particles binned by mesher cell in CSR form (the
// wrapper sorts the particles' cell ids and builds the bin starts). A
// particle in cell b reaches nodes b - cr + 1 ... b + cr along each axis
// (cr = ceil(ext/h)), so node n reads cells b = n - cr ... n + cr - 1. The
// bin grid is padded by cr cells on every side, so particles outside the
// node grid still reach the nodes inside it (as in the scatter oracle, whose
// bounds test is on the node); a particle beyond the padding reaches no node
// and is not binned. There is no cap on particles per cell (the TPU kernel's
// 8-slot grid dropped the excess). Cells along z are adjacent bins, so each
// (x, y) row of a node's support is one contiguous range of the sorted
// particles. No atomics: the same bits from run to run.
//
// Bound: operations, ~21 a particle and node in reach (0.17 ms at the main
// path's 2.0M particles, support 4 cells); the bytes (the particles once,
// the nodes once) are less. A thread a node walking device memory (the
// kernel this replaces) loaded 8 cr^2 bin starts for every node, near the
// fluid or not, and every particle of a node's support from L1/L2.
//
// Design: one block per tile of TX x TY x TZ nodes, a thread a node.
//   1. The tile's support box is (TX + 2 cr - 1) x (TY + 2 cr - 1) rows of
//      TZ + 2 cr - 1 bins, each row one contiguous range of particles. The
//      block first reads the two ends of each plane of rows over all z (the
//      particles of a plane lie together), then the rows' own ends; where
//      all are empty (most of the grid) it writes +1 and returns.
//   2. Otherwise it copies the box's bin starts into shared memory, as
//      places in the list of the box's particles (row after row), and then
//      the particles themselves as 16-byte words, CAP a chunk, a thread a
//      particle: a crammed bin or a dense floor takes several chunks, and
//      the sums stay in registers across them. Where the box's starts do
//      not fit beside the chunk (a support of more than 12 cells), the box
//      is taken a run of whole rows at a time, in row order, each run with
//      its own list and chunks.
//   3. Per chunk a thread walks the (2 cr)^2 rows of its node's support in
//      the order x, y, then particle, and takes from each row the 2 cr bins
//      its z reaches. Every node sees its particles in the order of the
//      one-thread-per-node kernel, whatever the tile, the runs of rows or
//      the chunks, so its bits depend on none of them.
// d^2 / ext^2 is a multiplication by 1 / ext^2. Measured and not kept, being
// no faster: two by two nodes a thread, which load a particle once for four
// nodes (the time goes to the ~18 operations a pair, not to shared
// memory), and leaving out the bins of a row that lie farther than ext from
// the node (a fifth of them at cr = 4).
//
// Shared memory: 16 B x CAP for a chunk of particles, 4 B for every bin
// start of a run of rows and ~12 B a row: 56 + 17 KB at cr = 4, three blocks
// an SM; the whole box up to cr = 12 (56 + 132 KB), any cr in runs.
//
// With KEEP (launch "surface_keep", for a forward whose positions want a
// gradient) the pass also writes each node's sums (W, X) as one 16-byte
// word, zeros where no particle is in reach: kernel F' (csrc/surface_bwd.cu)
// forms its node words from them, so no second node pass runs. A mesh
// without a gradient launches the plain form and keeps nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8, TY = 8, TZ = 8;  // nodes a tile
constexpr int THREADS = TX * TY * TZ;
constexpr int CAP = 3584;  // particles a chunk
constexpr size_t MAX_SHARED = 227 * 1024;  // a block's dynamic shared memory, at most

// KEEP: also write each node's sums (W, X) to `sums`. RUNS: the box's rows
// in runs (cr > 12); without it the whole box is one run and the code clips
// nothing to it.
template <bool KEEP, bool RUNS>
__global__ void __launch_bounds__(THREADS)
surface_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
               float* __restrict__ out, float4* __restrict__ sums, int mx, int my, int mz, int cr,
               float h, float ox, float oy, float oz, float ext2, float radius, int run) {
  extern __shared__ float4 chunk[];  // CAP particles, then the arrays below
  const int n2 = 2 * cr;
  const int wx = TX + n2 - 1, wy = TY + n2 - 1, wz = TZ + n2 - 1;  // the box, in bins
  const int rows = wx * wy;
  // per row of a run of `run` rows:
  int* glo = (int*)(chunk + CAP);     // [run] its first particle in `pos`
  int* len = glo + run;               // [run] its particles
  int* rb = len + run;                // [run + 1] its place in the run's list
  int* lstart = rb + run + 1;         // [run][wz + 1] its bins' places in the list
  int* group_len = lstart + run * (wz + 1);  // [(run + 31) / 32]
  const int BX = mx + n2, BY = my + n2, BZ = mz + n2;  // the padded bin grid
  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, t0z = blockIdx.x * TZ;
  const int tz = threadIdx.x % TZ, ty = (threadIdx.x / TZ) % TY, tx = threadIdx.x / (TZ * TY);
  const int a = t0x + tx, b = t0y + ty, c = t0z + tz;  // the node; z fastest: stores coalesce
  const bool inside = a <= mx && b <= my && c <= mz;
  const long long at = ((long long)a * (my + 1) + b) * (mz + 1) + c;
  // a node no particle reaches: outside (+1), sums 0
  auto write_empty = [&]() {
    if (!inside) return;
    out[at] = 1.0f;
    if (KEEP) sums[at] = make_float4(0.f, 0.f, 0.f, 0.f);
  };

  // 1. is any particle in reach? First the box's (x, y) rows over all z,
  // which lie together in the sorted particles: two loads a plane of rows
  // tell most tiles away from the fluid. The padded bin of cell n - cr is n.
  int any = 0;
  for (int lx = threadIdx.x; lx < wx; lx += THREADS) {
    const long long bx = t0x + lx;
    if (bx < BX) any |= starts[(bx * BY + min(t0y + wy, BY)) * BZ] - starts[(bx * BY + t0y) * BZ];
  }
  if (!__syncthreads_or(any)) {
    write_empty();
    return;
  }
  const float inv_ext2 = 1.0f / ext2;
  const float nxp = ox + (float)a * h, nyp = oy + (float)b * h, nzp = oz + (float)c * h;
  float W = 0.f, X = 0.f, Y = 0.f, Z = 0.f;
  const int z0 = min(t0z, BZ), z1 = min(t0z + wz, BZ);

  // the box's rows [r0, r0 + nr), a run at a time (all of them up to cr = 12)
  for (int r0 = 0; r0 < rows; r0 += RUNS ? run : rows) {
    const int nr = RUNS ? min(run, rows - r0) : rows;
    __syncthreads();  // the last run is read
    // then the rows' own ends; bins past the padded grid (a tile that
    // overhangs the node grid) are empty
    any = 0;
    for (int r = threadIdx.x; r < nr; r += THREADS) {
      const int bx = t0x + (r0 + r) / wy, by = t0y + (r0 + r) % wy;
      int lo = 0, n = 0;
      if (bx < BX && by < BY) {
        const long long row = ((long long)bx * BY + by) * BZ;
        lo = starts[row + z0];
        n = starts[row + z1] - lo;
      }
      glo[r] = lo;
      len[r] = n;
      any |= n;
    }
    if (!__syncthreads_or(any)) continue;

    // 2. each row's place in the list of the run's particles (the rows of
    // each group of 32, then each row in its group), then its bins' places
    const int groups = (nr + 31) / 32;
    for (int g = threadIdx.x; g < groups; g += THREADS) {
      int sum = 0;
      for (int r = 32 * g; r < 32 * g + 32 && r < nr; ++r) sum += len[r];
      group_len[g] = sum;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += THREADS) {
      int before = 0;
      for (int g = 0; g < r / 32; ++g) before += group_len[g];
      for (int q = r & ~31; q < r; ++q) before += len[q];
      rb[r] = before;
      if (r == nr - 1) rb[nr] = before + len[r];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nr * (wz + 1); t += THREADS) {
      const int r = t / (wz + 1), z = t % (wz + 1);
      const int bx = t0x + (r0 + r) / wy, by = t0y + (r0 + r) % wy;
      int place = rb[r];
      if (bx < BX && by < BY)
        place += starts[((long long)bx * BY + by) * BZ + min(t0z + z, BZ)] - glo[r];
      lstart[t] = place;
    }
    const int total = rb[nr];
    const int top = 1 << (31 - __clz(nr));  // the largest power of two <= nr

    // 3. the list, CAP particles [e0, e1) at a time
    for (int e0 = 0; e0 < total; e0 += CAP) {
      const int e1 = min(e0 + CAP, total);
      __syncthreads();  // the places are written; the last chunk is read
      // 3a. the chunk's particles, a thread a particle (loads that do not
      // wait for each other): its row is the last r with rb[r] <= e
#pragma unroll 4
      for (int e = e0 + threadIdx.x; e < e1; e += THREADS) {
        int r = 0;
        for (int step = top; step > 0; step >>= 1)
          if (r + step < nr && rb[r + step] <= e) r += step;
        const float* p = pos + 3 * ((long long)glo[r] + (e - rb[r]));
        chunk[e - e0] = make_float4(p[0], p[1], p[2], 0.f);
      }
      __syncthreads();

      // 3b. the rows of the node's support in the run: x, y, then particle
      // ascending
      for (int rx = 0; rx < n2; ++rx) {
        const int lx = tx + rx;
        // the run's rows of plane lx
        const int p_lo = RUNS ? max(lx * wy - r0, 0) : lx * wy;
        const int p_hi = RUNS ? min((lx + 1) * wy - r0, nr) : (lx + 1) * wy;
        if ((RUNS && p_lo >= p_hi) || rb[p_hi] <= e0 || rb[p_lo] >= e1) continue;
        for (int ry = 0; ry < n2; ++ry) {
          const int r = lx * wy + ty + ry - (RUNS ? r0 : 0);
          if (RUNS && (r < 0 || r >= nr)) continue;
          const int* bins = lstart + r * (wz + 1) + tz;
          const int lo = max(bins[0], e0), hi = min(bins[n2], e1);
#pragma unroll 2
          for (int e = lo; e < hi; ++e) {
            const float4 p = chunk[e - e0];
            const float dx = p.x - nxp, dy = p.y - nyp, dz = p.z - nzp;
            const float kl = fmaxf(1.0f - (dx * dx + dy * dy + dz * dz) * inv_ext2, 0.0f);
            const float w = kl * kl * kl;
            W += w;
            X += w * p.x;
            Y += w * p.y;
            Z += w * p.z;
          }
        }
      }
    }
  }

  if (!inside) return;
  if (KEEP) sums[at] = make_float4(W, X, Y, Z);
  if (!(W > 0.0f)) {
    out[at] = 1.0f;
    return;
  }
  const float Wc = fmaxf(W, 1e-30f);
  const float dx = X / Wc - nxp, dy = Y / Wc - nyp, dz = Z / Wc - nzp;
  out[at] = sqrtf(dx * dx + dy * dy + dz * dz + 1e-30f) - radius;
}

// a chunk of particles, and per row of a run its bins' places and three
// ints, and an int a group of 32 rows
size_t shared_bytes(int cr, int run) {
  const size_t wz = TZ + 2 * cr - 1;
  return CAP * sizeof(float4) + ((size_t)run * (wz + 1 + 3) + 1 + (run + 31) / 32) * sizeof(int);
}

// the rows a run: the whole box where it fits, else as many as fit
int run_rows(int cr) {
  const int rows = (TX + 2 * cr - 1) * (TY + 2 * cr - 1);
  int run = rows;
  while (run > 1 && shared_bytes(cr, run) > MAX_SHARED) run = (int)((long long)run * 15 / 16);
  return run;
}

template <bool KEEP>
int launch(const float* pos, const int* starts, float* out, float4* sums, int mx, int my, int mz,
           int cr, float h, float ox, float oy, float oz, float ext2, float radius, void* stream) {
  if (cr < 1) return (int)cudaErrorInvalidValue;
  const int run = run_rows(cr);
  const size_t smem = shared_bytes(cr, run);
  auto kernel = run < (TX + 2 * cr - 1) * (TY + 2 * cr - 1) ? surface_kernel<KEEP, true>
                                                             : surface_kernel<KEEP, false>;
  // above 48 KB a kernel has to ask for its dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((mz + TZ) / TZ, (my + TY) / TY, (mx + TX) / TX);  // m + 1 nodes an axis
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, starts, out, sums, mx, my, mz, cr, h, ox, oy, oz, ext2, radius, run);
  return (int)cudaGetLastError();
}

}  // namespace

// pos: (M, 3) f32 particles sorted by padded bin; starts: ((mx+2cr)(my+2cr)(mz+2cr) + 1)
// int32 CSR starts; out: (mx+1, my+1, mz+1) f32; any cr >= 1.
extern "C" int lf_surface(const float* pos, const int* starts, float* out, int mx, int my, int mz,
                          int cr, float h, float ox, float oy, float oz, float ext2,
                          float radius, void* stream) {
  return launch<false>(pos, starts, out, nullptr, mx, my, mz, cr, h, ox, oy, oz, ext2, radius,
                       stream);
}

// The same with the node sums kept: sums (mx+1, my+1, mz+1, 4) f32, 16-byte
// aligned: (W, X, Y, Z) a node, zeros where no particle is in reach.
extern "C" int lf_surface_keep(const float* pos, const int* starts, float* out, float* sums, int mx,
                               int my, int mz, int cr, float h, float ox, float oy, float oz,
                               float ext2, float radius, void* stream) {
  return launch<true>(pos, starts, out, reinterpret_cast<float4*>(sums), mx, my, mz, cr, h, ox, oy,
                      oz, ext2, radius, stream);
}
