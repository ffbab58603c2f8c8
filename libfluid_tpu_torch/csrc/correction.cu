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
// Bound: the 3 * KC * cells output written once (302 MB at 128^3, KC = 12)
// plus the masks and the occupied positions read once; the ~230 pairs of an
// occupied slot are ~20 float32 operations each, about as long on this card.
//
// Design: one block per tile of TX x TY x TZ cells. Slots are taken a word
// of 32 at a time (slots 0-31, 32-63, ...), the width of an occupancy mask:
// the tile's own slots a word at a time, and for each such word the
// neighbours' slots a word at a time (one pass at the main path's KC = 12).
//   1. The block reads its own cells' masks; a tile that holds no particle
//      (most of a dam-break's domain) zeroes its outputs and returns.
//   2. It loads the word's occupied slots of the tile and of its one-cell
//      halo into shared memory once, compacted per cell in slot order as
//      (x, y, z, mask) with an occupancy bit mask per cell, so that a pair
//      costs one 16-byte shared-memory load and no index arithmetic on
//      device memory. Cells outside the grid hold no slot. The cell stride
//      is an odd number of 16-byte words, which spreads the cells over the
//      banks.
//   3. The tile's occupied slots of its own word form one list, cell after
//      cell, and each thread takes one of them: the threads of a warp then
//      belong to a few cells only, walk the same neighbour lists (their
//      loads are broadcasts) and leave the loops together. A slot sums its
//      pairs neighbour cells dx, dy, dz ascending and then slots ascending:
//      the order in which the one-thread-per-slot kernel this replaces read
//      them from device memory. Empty slots are written 0. Above 32 slots a
//      cell a slot writes its spring after the first word of neighbours and
//      adds the others' to it.
// The tile is 4x4x8 cells with 512 threads: its 6x6x10 cells with the halo
// (2.8 cells loaded per cell of the tile) hold a word of 32 slots a cell in
// a block's shared memory (360 cells x 33 x 16 B = 186 KB), and at the main
// path's KC = 12 (73 KB) more than one block shares an SM.
// No Newton's-third-law half sweep: each slot sums its own pairs, so
// nothing is accumulated across threads and no atomics are needed.
//
// Arithmetic per pair: d^2/re2 is a multiplication by 1/re2 and 1/d is
// rsqrtf (2 ulp), where the one-thread-per-slot kernel divided twice (an
// IEEE division and a square root are ~30 instructions a pair, most of its
// arithmetic). At the 128^3 shapes the springs moved by 2.2e-8 of 100
// max|pos| with this, and the error against the plain version stayed at
// 3.2e-8 (bound 2e-6). The file is built without fast math otherwise.
//
// Reads: res_pos (3, KC, C) and res_mask (KC, C) from contiguous tensors
// (the wrapper passes the slot grid's own columns, which are contiguous
// when KC equals the slot capacity, or one contiguous copy otherwise).

#include <cuda_runtime.h>
#include <stdint.h>

#include "jitter.cuh"

namespace {

constexpr int MASK_BITS = 32;  // slots an occupancy mask

// A block's tile of TX x TY x TZ cells (a power of two, at least 32) and
// the tile with its one-cell halo.
constexpr int TX = 4, TY = 4, TZ = 8, THREADS = 512;
constexpr int HY = TY + 2, HZ = TZ + 2;
constexpr int TILE_CELLS = TX * TY * TZ;
constexpr int HALO_CELLS = (TX + 2) * HY * HZ;
constexpr int GROUPS = TILE_CELLS / 32;  // for the scan over the cells' counts
static_assert((TILE_CELLS & (TILE_CELLS - 1)) == 0 && TILE_CELLS >= 32 && TILE_CELLS <= THREADS,
              "tile size");

// a tile cell's index among the cells of the tile with its halo
__device__ __forceinline__ int halo_of(int cl) {
  return ((cl / (TY * TZ) + 1) * HY + ((cl / TZ) % TY + 1)) * HZ + (cl % TZ + 1);
}

// 16-byte words between two cells' slot lists in shared memory: odd
__host__ __device__ constexpr int cell_stride(int KC) { return (KC < MASK_BITS ? KC : MASK_BITS) | 1; }

__global__ void __launch_bounds__(THREADS)
correction_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                  float* __restrict__ out, int KC, int nx, int ny, int nz, float re2,
                  uint32_t seed, int ox, int oy, int oz) {
  extern __shared__ float4 slots[];  // HALO_CELLS * cell_stride(KC)
  __shared__ uint32_t occupied[HALO_CELLS];  // a cell's occupied slots of the neighbours' word
  __shared__ uint32_t own[TILE_CELLS];       // a tile cell's occupied slots of its own word
  __shared__ int first[TILE_CELLS + 1];
  __shared__ int group_first[GROUPS];
  const long long C = (long long)nx * ny * nz;
  const long long KCC = (long long)KC * C;
  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, t0z = blockIdx.x * TZ;
  const int stride = cell_stride(KC);
  const float inv_re2 = 1.0f / re2;

  // 1. the tile's own masks, a thread a cell: is there any particle?
  int any = 0;
  for (int cl = threadIdx.x; cl < TILE_CELLS; cl += THREADS) {
    const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
    if (i >= nx || j >= ny || l >= nz) continue;
    const float* m = mask + ((long long)i * ny + j) * nz + l;
#pragma unroll 4
    for (int k = 0; k < KC; ++k) any |= m[k * C] != 0.0f;
  }
  if (!__syncthreads_or(any)) {
    for (int t = threadIdx.x; t < KC * TILE_CELLS; t += THREADS) {
      const int cl = t % TILE_CELLS, k = t / TILE_CELLS;
      const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
      if (i < nx && j < ny && l < nz) {
        const long long s = (long long)k * C + ((long long)i * ny + j) * nz + l;
        out[s] = 0.0f;
        out[KCC + s] = 0.0f;
        out[2 * KCC + s] = 0.0f;
      }
    }
    return;
  }

  for (int wi = 0; wi < KC; wi += MASK_BITS) {  // the tile's own slots wi ... wi + 31
    const int ni = min(KC - wi, MASK_BITS);
    __syncthreads();  // the last word's lists are read
    for (int cl = threadIdx.x; cl < TILE_CELLS; cl += THREADS) {
      const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
      uint32_t bits = 0;
      if (i < nx && j < ny && l < nz) {
        const float* m = mask + (long long)wi * C + ((long long)i * ny + j) * nz + l;
#pragma unroll 4
        for (int k = 0; k < ni; ++k) bits |= (m[k * C] != 0.0f ? 1u : 0u) << k;
      }
      own[cl] = bits;
    }
    __syncthreads();
    // the tile's occupied slots in one list, cell after cell: first[cl] is
    // the place of cell cl's first slot, so that the threads of a warp work
    // on few cells and walk the same neighbour lists. A scan in two steps:
    // the count of every group of 32 cells, then each cell's place in its
    // group.
    if (threadIdx.x < GROUPS) {
      int count = 0;
      for (int c = 0; c < 32; ++c) count += __popc(own[32 * threadIdx.x + c]);
      group_first[threadIdx.x] = count;
    }
    __syncthreads();
    if (threadIdx.x < TILE_CELLS) {
      const int g = threadIdx.x / 32;
      int before = 0;
      for (int q = 0; q < g; ++q) before += group_first[q];
      for (int c = 32 * g; c < threadIdx.x; ++c) before += __popc(own[c]);
      first[threadIdx.x] = before;
      if (threadIdx.x == TILE_CELLS - 1) first[TILE_CELLS] = before + __popc(own[threadIdx.x]);
    }

    // 3a. zeros for the tile's empty slots of the word
    for (int t = threadIdx.x; t < ni * TILE_CELLS; t += THREADS) {
      const int cl = t % TILE_CELLS, k = t / TILE_CELLS;
      const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
      if (i >= nx || j >= ny || l >= nz || (own[cl] >> k & 1u)) continue;
      const long long s = (long long)(wi + k) * C + ((long long)i * ny + j) * nz + l;
      out[s] = 0.0f;
      out[KCC + s] = 0.0f;
      out[2 * KCC + s] = 0.0f;
    }
    __syncthreads();
    const int total = first[TILE_CELLS];
    if (total == 0) continue;

    for (int wj = 0; wj < KC; wj += MASK_BITS) {  // the neighbours' slots wj ... wj + 31
      const int nj = min(KC - wj, MASK_BITS);
      __syncthreads();  // the last word's slots are read
      // 2. the word's occupied slots of the tile and its halo, a thread a
      // cell: the cell's occupancy bits from its masks (loads that do not
      // wait for each other), then its occupied slots to their places in
      // slot order
      for (int h = threadIdx.x; h < HALO_CELLS; h += THREADS) {
        const int i = t0x - 1 + h / (HY * HZ), j = t0y - 1 + (h / HZ) % HY, l = t0z - 1 + h % HZ;
        uint32_t bits = 0;
        if (i >= 0 && i < nx && j >= 0 && j < ny && l >= 0 && l < nz) {
          const long long cell = (long long)wj * C + ((long long)i * ny + j) * nz + l;
#pragma unroll 4
          for (int k = 0; k < nj; ++k) bits |= (mask[k * C + cell] != 0.0f ? 1u : 0u) << k;
          int place = 0;
          for (uint32_t rest = bits; rest; rest &= rest - 1, ++place) {
            const long long s = (long long)(__ffs(rest) - 1) * C + cell;
            slots[h * stride + place] = make_float4(pos[s], pos[KCC + s], pos[2 * KCC + s], mask[s]);
          }
        }
        occupied[h] = bits;
      }
      __syncthreads();

      // 3b. one occupied slot of the tile at a time
      for (int t = threadIdx.x; t < total; t += THREADS) {
        int cl = 0;  // the last cell with first[cl] <= t
        for (int step = TILE_CELLS / 2; step > 0; step >>= 1)
          if (first[cl + step] <= t) cl += step;
        const int self = t - first[cl];  // its place in its cell's list
        const int hc = halo_of(cl);
        uint32_t rest = own[cl];
        for (int n = 0; n < self; ++n) rest &= rest - 1;
        const int k = wi + __ffs(rest) - 1;  // the slot of that place
        const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
        const long long s = (long long)k * C + ((long long)i * ny + j) * nz + l;
        const float px = pos[s], py = pos[KCC + s], pz = pos[2 * KCC + s], mi = mask[s];

        // The pair loop has no branch: the slot itself counts with weight 0,
        // and a coincident pair adds 0 to the sums and its weight to the
        // count, which leaves every sum's bits as they are.
        float wsum = 0.f, wx = 0.f, wy = 0.f, wz = 0.f, coin = 0.f;
#pragma unroll 1
        for (int n = 0; n < 27; ++n) {  // dx, dy, dz ascending
          const int nb = hc + ((n / 9 - 1) * HY + (n / 3) % 3 - 1) * HZ + n % 3 - 1;
          const int count = __popc(occupied[nb]);
          // the centre cell holds the slot itself in its own word
          const int skip = n == 13 && wi == wj ? self : -1;
          const float4* list = &slots[nb * stride];
#pragma unroll 1
          for (int e = 0; e < count; ++e) {
            const float4 q = list[e];
            const float pair = e == skip ? 0.0f : mi * q.w;
            const float ex = px - q.x, ey = py - q.y, ez = pz - q.z;
            const float sq = ex * ex + ey * ey + ez * ez;
            const bool coincide = sq < 1e-12f;
            const float kl = fmaxf(1.0f - sq * inv_re2, 0.0f);
            const float w = coincide ? 0.0f : kl * kl * kl * rsqrtf(sq) * pair;
            coin += coincide ? pair : 0.0f;
            wsum += w;
            wx += w * q.x;
            wy += w * q.y;
            wz += w * q.z;
          }
        }
        const int gx = i + ox, gy = j + oy, gz = l + oz;
        const float sx = px * wsum - wx + coin * jitter_value(seed, gx, gy, gz, k, 0);
        const float sy = py * wsum - wy + coin * jitter_value(seed, gx, gy, gz, k, 1);
        const float sz = pz * wsum - wz + coin * jitter_value(seed, gx, gy, gz, k, 2);
        if (wj == 0) {
          out[s] = sx;
          out[KCC + s] = sy;
          out[2 * KCC + s] = sz;
        } else {
          out[s] += sx;
          out[KCC + s] += sy;
          out[2 * KCC + s] += sz;
        }
      }
    }
  }
}

// 16 bytes a slot of a word of the tile and its halo: 186 KB from KC = 32
// on, inside the 227 KB a block may have with the static arrays above
constexpr size_t slot_bytes(int KC) {
  return (size_t)HALO_CELLS * cell_stride(KC) * sizeof(float4);
}
static_assert(slot_bytes(MASK_BITS) <= 216 * 1024, "the tile's slots do not fit a block");

}  // namespace

// pos: (3, KC, nx, ny, nz), mask: (KC, nx, ny, nz), out: (3, KC, nx, ny, nz),
// all f32 contiguous, any KC >= 1; (ox, oy, oz) the global coordinates of
// local cell 0.
extern "C" int lf_correction(const float* pos, const float* mask, float* out, int KC, int nx,
                             int ny, int nz, float re2, int seed, int ox, int oy, int oz,
                             void* stream) {
  if (KC < 1) return (int)cudaErrorInvalidValue;
  if ((long long)nx * ny * nz == 0) return 0;
  const size_t smem = slot_bytes(KC);
  // above 48 KB a kernel has to ask for its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(correction_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  correction_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, mask, out, KC, nx, ny, nz, re2, (uint32_t)seed, ox, oy, oz);
  return (int)cudaGetLastError();
}
