// Kernel E': the vector-Jacobian product of kernel E (position-correction
// springs over the slot grid).
//
// Stands in for libfluid_tpu/sim/correction.py:_springs_bwd, which takes
// jax.vjp of the jnp oracle around libfluid_tpu/sim/kernels.py:
// _correction_kernel. Forward, slot i = (k < KC, cell) with mask m_i has
//
//   spring_i = m_i sum_j m_j w(|r|^2) r + coin_i * jitter_i,   r = x_i - x_j,
//   w(s) = max(1 - s/re2, 0)^3 / sqrt(s)   (0 where s < 1e-12),
//   coin_i = m_i sum_j m_j [s < 1e-12]
//
// over the slots j of the 27 neighbour cells inside the grid, the slot
// itself excluded. Every pair stands in both slots' sums, so for the
// springs' cotangent g, with G = g_i - g_j,
//
//   d x_i = m_i sum_j m_j (w G + 2 w' (r . G) r),
//           2 w' = -k^2 / sqrt(s) * (6 / re2 + k / s),  k = max(1 - s/re2, 0),
//   d m_i = sum_j m_j (w r . G + [s < 1e-12] (jitter_i . g_i + jitter_j . g_j)):
//
// a gather like the forward, no atomics, the same bits from run to run. The
// oracle's rules at the kinks hold: the cube has slope 0 where k reaches 0,
// and a coincident pair passes nothing to the positions. Empty slots get 0
// in both outputs (the oracle gives an empty slot's mask a value; the slot
// grid's expand hands back the valid slots only, so it is dropped with the
// slot). d m is skipped when its pointer is null.
//
// Bound: g read, d x and d m written over all 3 * KC * cells and KC * cells
// slots (0.7 GB at 128^3, KC = 12: 0.21 ms), the mask and the occupied
// positions read; the ~230 pairs of an occupied slot are ~45 float32
// operations each, a little more than that at this card's peak.
//
// Design: kernel E's tile (csrc/correction.cu): one block per tile of cells,
// the occupied slots of the tile and its one-cell halo compacted per cell in
// shared memory, a thread a slot of the tile's list, the pairs in E's order
// (neighbour cells dx, dy, dz ascending, then slots ascending), both steps
// in one place each (stage_word, pair_sums). Up to BIG_TILE_MAX_KC the
// tile's and the halo's slots are staged once (correction_bwd_kernel);
// above that a second kernel (correction_bwd_words_kernel) takes, as E does,
// the tile's own slots and the neighbours' a word of 32 at a time, a slot
// writing its cotangents after the first word of neighbours and adding the
// others'. (One kernel for both cost the main path's KC = 12 7-10 % of its
// time: 56 -> 64 registers and a second pass over the tile's masks, in two
// runs of tools/kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700 W.)
// A slot is two 16-byte words in two planes, (x, y, z, m) and
// (g_x, g_y, g_z, jitter . g):
// the jitter of a neighbour, which needs its cell and slot number, is
// hashed once where the slot is loaded, not per coincident pair. A tile
// with no particle writes its zeros and returns.
// Twice E's shared memory a slot: the 4 x 4 x 8 tile with 512 threads holds
// up to BIG_TILE_MAX_KC = 18 slots a cell (360 cells x 19 x 32 B = 214 KB; at
// the main path's KC = 12, 146 KB, one block an SM), the words kernel's 4 x 4
// x 4 tile with 256 threads a word of 32 (216 cells x 33 x 32 B = 223 KB; at
// KC = 12 that tile took 1.94 ms on the device for the larger tile's 1.78).
// 1 / sqrt(s) is rsqrtf (2 ulp), as in E: with 1 / sqrtf the kernel took 2.44
// ms for 1.78 at the 128^3 shapes and its results moved by 9.5e-6 of values
// up to 1e2, under the error either has against float64 (one run of
// tools/kernel_variants.py --backward on an NVIDIA H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "jitter.cuh"

namespace {

constexpr int MASK_BITS = 32;  // slots an occupancy mask
constexpr int BIG_TILE_MAX_KC = 18;  // the most slots a cell the 4 x 4 x 8 tile holds

// 32-byte slots between two cells' lists in shared memory (a word of slots
// at most): odd
__host__ __device__ constexpr int cell_stride(int KC) { return (KC < MASK_BITS ? KC : MASK_BITS) | 1; }

// A block's tile of TX x TY x TZ cells (a power of two, at least 32, at most
// THREADS) and the tile with its one-cell halo.
template <int TX, int TY, int TZ, int THREADS>
struct Tile {
  static constexpr int HY = TY + 2, HZ = TZ + 2;
  static constexpr int CELLS = TX * TY * TZ;
  static constexpr int HALO_CELLS = (TX + 2) * HY * HZ;
  static constexpr int GROUPS = CELLS / 32;  // for the scan over the cells' counts
  static constexpr int BLOCK = THREADS;
  static_assert((CELLS & (CELLS - 1)) == 0 && CELLS >= 32 && CELLS <= THREADS, "tile size");
  // a tile cell's index among the cells of the tile with its halo
  __device__ static int halo_of(int cl) {
    return ((cl / (TY * TZ) + 1) * HY + ((cl / TZ) % TY + 1)) * HZ + (cl % TZ + 1);
  }
  static constexpr size_t slot_bytes(int KC) {
    return (size_t)2 * HALO_CELLS * cell_stride(KC) * sizeof(float4);
  }
};

// Stages the slots wj ... wj + nj - 1 (nj <= 32) of every cell of the tile
// and its halo, a thread a cell: the cell's occupancy bits from its masks,
// then its occupied slots to their places in slot order, each with its
// cotangent and jitter . g.
template <class T>
__device__ __forceinline__ void stage_word(const float* __restrict__ pos,
                                           const float* __restrict__ mask,
                                           const float* __restrict__ g, float4* slots,
                                           float4* cots, uint32_t* occupied, int wj, int nj,
                                           long long C, long long KCC, int stride, int t0x,
                                           int t0y, int t0z, int nx, int ny, int nz,
                                           uint32_t seed, int ox, int oy, int oz) {
  constexpr int HY = T::HY, HZ = T::HZ;
  for (int h = threadIdx.x; h < T::HALO_CELLS; h += T::BLOCK) {
    const int i = t0x - 1 + h / (HY * HZ), j = t0y - 1 + (h / HZ) % HY, l = t0z - 1 + h % HZ;
    uint32_t bits = 0;
    if (i >= 0 && i < nx && j >= 0 && j < ny && l >= 0 && l < nz) {
      const long long cell = ((long long)i * ny + j) * nz + l;
#pragma unroll 4
      for (int k = 0; k < nj; ++k) bits |= (mask[(wj + k) * C + cell] != 0.0f ? 1u : 0u) << k;
      int place = 0;
      for (uint32_t rest = bits; rest; rest &= rest - 1, ++place) {
        const int k = wj + __ffs(rest) - 1;
        const long long s = (long long)k * C + cell;
        const float gx = g[s], gy = g[KCC + s], gz = g[2 * KCC + s];
        const int cx = i + ox, cy = j + oy, cz = l + oz;
        const float jg = jitter_value(seed, cx, cy, cz, k, 0) * gx +
                         jitter_value(seed, cx, cy, cz, k, 1) * gy +
                         jitter_value(seed, cx, cy, cz, k, 2) * gz;
        slots[h * stride + place] = make_float4(pos[s], pos[KCC + s], pos[2 * KCC + s], mask[s]);
        cots[h * stride + place] = make_float4(gx, gy, gz, jg);
      }
    }
    occupied[h] = bits;
  }
}

// The sums of one slot (me: position and mask, mine: cotangent and
// jitter . g, at halo cell hc) over the staged slots of the 27 neighbour
// cells, in E's order (dx, dy, dz ascending, then slots ascending); `self`
// is its place in the centre cell's list, or -1 where it is not staged.
// Returns (d x / m_i, d m). The pair loop has no branch: the slot itself
// counts with mask 0, and a coincident pair adds 0 to the position sums.
template <class T>
__device__ __forceinline__ float4 pair_sums(const float4* slots, const float4* cots,
                                            const uint32_t* occupied, int stride, int hc,
                                            int self, float4 me, float4 mine, float inv_re2) {
  constexpr int HY = T::HY, HZ = T::HZ;
  float dx = 0.f, dy = 0.f, dz = 0.f, dm = 0.f;
#pragma unroll 1
  for (int n = 0; n < 27; ++n) {  // dx, dy, dz ascending
    const int nb = hc + ((n / 9 - 1) * HY + (n / 3) % 3 - 1) * HZ + n % 3 - 1;
    const int count = __popc(occupied[nb]);
    const int skip = n == 13 ? self : -1;  // the centre cell holds the slot itself
    const float4* list = &slots[nb * stride];
    const float4* glist = &cots[nb * stride];
#pragma unroll 1
    for (int e = 0; e < count; ++e) {
      const float4 q = list[e];
      const float4 qg = glist[e];
      const float mj = e == skip ? 0.0f : q.w;
      const float ex = me.x - q.x, ey = me.y - q.y, ez = me.z - q.z;
      const float sq = ex * ex + ey * ey + ez * ez;
      const bool coincide = sq < 1e-12f;
      const float kl = fmaxf(1.0f - sq * inv_re2, 0.0f);
      const float rs = rsqrtf(sq);
      const float kk = kl * kl * rs;
      const float w = coincide ? 0.0f : kk * kl;
      const float w2 = coincide ? 0.0f : -kk * (6.0f * inv_re2 + kl * rs * rs);  // 2 w'
      const float Gx = mine.x - qg.x, Gy = mine.y - qg.y, Gz = mine.z - qg.z;
      const float rG = ex * Gx + ey * Gy + ez * Gz;
      const float c = w2 * rG;
      dx += mj * (w * Gx + c * ex);
      dy += mj * (w * Gy + c * ey);
      dz += mj * (w * Gz + c * ez);
      dm += mj * (w * rG + (coincide ? mine.w + qg.w : 0.0f));
    }
  }
  return make_float4(dx, dy, dz, dm);
}

// One word of slots (KC <= BIG_TILE_MAX_KC): the slots of the tile and its
// halo staged once.
template <int TX, int TY, int TZ, int THREADS>
__global__ void __launch_bounds__(THREADS)
correction_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                      const float* __restrict__ g, float* __restrict__ dpos,
                      float* __restrict__ dmask, int KC, int nx, int ny, int nz, float re2,
                      uint32_t seed, int ox, int oy, int oz) {
  using T = Tile<TX, TY, TZ, THREADS>;
  constexpr int TILE_CELLS = T::CELLS, HALO_CELLS = T::HALO_CELLS;
  extern __shared__ float4 slots[];  // two planes of HALO_CELLS * cell_stride(KC)
  __shared__ uint32_t occupied[HALO_CELLS];  // a cell's occupied slots, bit k for slot k
  __shared__ int first[TILE_CELLS + 1];
  __shared__ int group_first[T::GROUPS];
  const long long C = (long long)nx * ny * nz;
  const long long KCC = (long long)KC * C;
  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, t0z = blockIdx.x * TZ;
  const int stride = cell_stride(KC);
  float4* const cots = slots + HALO_CELLS * stride;  // the second plane
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
  const bool live = __syncthreads_or(any);

  // 2. the occupied slots of the tile and its halo
  if (live) {
    stage_word<T>(pos, mask, g, slots, cots, occupied, 0, KC, C, KCC, stride, t0x, t0y, t0z, nx,
                  ny, nz, seed, ox, oy, oz);
    __syncthreads();
    // the tile's occupied slots in one list, cell after cell: first[cl] is
    // the place of cell cl's first slot. A scan in two steps: the count of
    // every group of 32 cells, then each cell's place in its group.
    if (threadIdx.x < T::GROUPS) {
      int count = 0;
      for (int c = 0; c < 32; ++c) count += __popc(occupied[T::halo_of(32 * threadIdx.x + c)]);
      group_first[threadIdx.x] = count;
    }
    __syncthreads();
    if (threadIdx.x < TILE_CELLS) {
      const int grp = threadIdx.x / 32;
      int before = 0;
      for (int q = 0; q < grp; ++q) before += group_first[q];
      for (int c = 32 * grp; c < threadIdx.x; ++c) before += __popc(occupied[T::halo_of(c)]);
      first[threadIdx.x] = before;
      if (threadIdx.x == TILE_CELLS - 1)
        first[TILE_CELLS] = before + __popc(occupied[T::halo_of(threadIdx.x)]);
    }
    __syncthreads();
  }

  // 3a. zeros for the tile's empty slots (all of them in a tile without a
  // particle)
  for (int t = threadIdx.x; t < KC * TILE_CELLS; t += THREADS) {
    const int cl = t % TILE_CELLS, k = t / TILE_CELLS;
    const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
    if (i >= nx || j >= ny || l >= nz) continue;
    if (live && (occupied[T::halo_of(cl)] >> k & 1u)) continue;
    const long long s = (long long)k * C + ((long long)i * ny + j) * nz + l;
    dpos[s] = 0.0f;
    dpos[KCC + s] = 0.0f;
    dpos[2 * KCC + s] = 0.0f;
    if (dmask) dmask[s] = 0.0f;
  }
  if (!live) return;

  // 3b. one occupied slot of the tile at a time
  const int total = first[TILE_CELLS];
  for (int t = threadIdx.x; t < total; t += THREADS) {
    int cl = 0;  // the last cell with first[cl] <= t
    for (int step = TILE_CELLS / 2; step > 0; step >>= 1)
      if (first[cl + step] <= t) cl += step;
    const int self = t - first[cl];  // its place in its cell's list
    const int hc = T::halo_of(cl);
    uint32_t rest = occupied[hc];
    for (int n = 0; n < self; ++n) rest &= rest - 1;
    const int k = __ffs(rest) - 1;  // the slot of that place
    const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
    const long long s = (long long)k * C + ((long long)i * ny + j) * nz + l;
    const float4 me = slots[hc * stride + self];
    const float4 d = pair_sums<T>(slots, cots, occupied, stride, hc, self, me,
                                  cots[hc * stride + self], inv_re2);
    dpos[s] = me.w * d.x;
    dpos[KCC + s] = me.w * d.y;
    dpos[2 * KCC + s] = me.w * d.z;
    if (dmask) dmask[s] = d.w;
  }
}

// More than BIG_TILE_MAX_KC slots a cell: the tile's own slots a word (32)
// at a time, and for each such word the neighbours' a word at a time; a slot
// writes its cotangents after the first word of neighbours and adds the
// others'.
template <int TX, int TY, int TZ, int THREADS>
__global__ void __launch_bounds__(THREADS)
correction_bwd_words_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                            const float* __restrict__ g, float* __restrict__ dpos,
                            float* __restrict__ dmask, int KC, int nx, int ny, int nz, float re2,
                            uint32_t seed, int ox, int oy, int oz) {
  using T = Tile<TX, TY, TZ, THREADS>;
  constexpr int TILE_CELLS = T::CELLS, HALO_CELLS = T::HALO_CELLS;
  extern __shared__ float4 slots[];  // two planes of HALO_CELLS * cell_stride(KC)
  __shared__ uint32_t occupied[HALO_CELLS];  // a cell's occupied slots of the neighbours' word
  __shared__ uint32_t own[TILE_CELLS];       // a tile cell's occupied slots of its own word
  __shared__ int first[TILE_CELLS + 1];
  __shared__ int group_first[T::GROUPS];
  const long long C = (long long)nx * ny * nz;
  const long long KCC = (long long)KC * C;
  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, t0z = blockIdx.x * TZ;
  const int stride = cell_stride(KC);
  float4* const cots = slots + HALO_CELLS * stride;  // the second plane
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
  const bool live = __syncthreads_or(any);

  for (int wi = 0; wi < KC; wi += MASK_BITS) {  // the tile's own slots wi ... wi + 31
    const int ni = min(KC - wi, MASK_BITS);
    __syncthreads();  // the last word's lists are read
    if (live) {
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
      // the tile's occupied slots of the word in one list, cell after cell:
      // first[cl] is the place of cell cl's first slot. A scan in two steps:
      // the count of every group of 32 cells, then each cell's place in its
      // group.
      if (threadIdx.x < T::GROUPS) {
        int count = 0;
        for (int c = 0; c < 32; ++c) count += __popc(own[32 * threadIdx.x + c]);
        group_first[threadIdx.x] = count;
      }
      __syncthreads();
      if (threadIdx.x < TILE_CELLS) {
        const int grp = threadIdx.x / 32;
        int before = 0;
        for (int q = 0; q < grp; ++q) before += group_first[q];
        for (int c = 32 * grp; c < threadIdx.x; ++c) before += __popc(own[c]);
        first[threadIdx.x] = before;
        if (threadIdx.x == TILE_CELLS - 1) first[TILE_CELLS] = before + __popc(own[threadIdx.x]);
      }
    }

    // 3a. zeros for the tile's empty slots of the word (all of them in a
    // tile without a particle)
    for (int t = threadIdx.x; t < ni * TILE_CELLS; t += THREADS) {
      const int cl = t % TILE_CELLS, k = t / TILE_CELLS;
      const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
      if (i >= nx || j >= ny || l >= nz) continue;
      if (live && (own[cl] >> k & 1u)) continue;
      const long long s = (long long)(wi + k) * C + ((long long)i * ny + j) * nz + l;
      dpos[s] = 0.0f;
      dpos[KCC + s] = 0.0f;
      dpos[2 * KCC + s] = 0.0f;
      if (dmask) dmask[s] = 0.0f;
    }
    if (!live) continue;
    __syncthreads();
    const int total = first[TILE_CELLS];
    if (total == 0) continue;

    for (int wj = 0; wj < KC; wj += MASK_BITS) {  // the neighbours' slots wj ... wj + 31
      __syncthreads();  // the last word's slots are read
      stage_word<T>(pos, mask, g, slots, cots, occupied, wj, min(KC - wj, MASK_BITS), C, KCC,
                    stride, t0x, t0y, t0z, nx, ny, nz, seed, ox, oy, oz);
      __syncthreads();

      // 3b. one occupied slot of the tile at a time
      for (int t = threadIdx.x; t < total; t += THREADS) {
        int cl = 0;  // the last cell with first[cl] <= t
        for (int step = TILE_CELLS / 2; step > 0; step >>= 1)
          if (first[cl + step] <= t) cl += step;
        const int self = t - first[cl];  // its place in its cell's list
        const int hc = T::halo_of(cl);
        uint32_t rest = own[cl];
        for (int n = 0; n < self; ++n) rest &= rest - 1;
        const int k = wi + __ffs(rest) - 1;  // the slot of that place
        const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
        const long long s = (long long)k * C + ((long long)i * ny + j) * nz + l;
        const bool same = wi == wj;
        float4 me, mine;
        if (same) {
          me = slots[hc * stride + self];
          mine = cots[hc * stride + self];
        } else {
          me = make_float4(pos[s], pos[KCC + s], pos[2 * KCC + s], mask[s]);
          const float gx = g[s], gy = g[KCC + s], gz = g[2 * KCC + s];
          const int cx = i + ox, cy = j + oy, cz = l + oz;
          mine = make_float4(gx, gy, gz,
                             jitter_value(seed, cx, cy, cz, k, 0) * gx +
                                 jitter_value(seed, cx, cy, cz, k, 1) * gy +
                                 jitter_value(seed, cx, cy, cz, k, 2) * gz);
        }

        // the slot itself is staged in its own word
        const float4 d = pair_sums<T>(slots, cots, occupied, stride, hc, same ? self : -1, me, mine,
                                      inv_re2);
        if (wj == 0) {
          dpos[s] = me.w * d.x;
          dpos[KCC + s] = me.w * d.y;
          dpos[2 * KCC + s] = me.w * d.z;
          if (dmask) dmask[s] = d.w;
        } else {
          dpos[s] += me.w * d.x;
          dpos[KCC + s] += me.w * d.y;
          dpos[2 * KCC + s] += me.w * d.z;
          if (dmask) dmask[s] += d.w;
        }
      }
    }
  }
}

// WORDS: the kernel that takes the slots a word at a time
template <int TX, int TY, int TZ, int THREADS, bool WORDS>
int launch(const float* pos, const float* mask, const float* g, float* dpos, float* dmask, int KC,
           int nx, int ny, int nz, float re2, int seed, int ox, int oy, int oz,
           cudaStream_t stream) {
  using T = Tile<TX, TY, TZ, THREADS>;
  const size_t smem = T::slot_bytes(KC);
  const auto kernel = [] {
    if constexpr (WORDS) return correction_bwd_words_kernel<TX, TY, TZ, THREADS>;
    else return correction_bwd_kernel<TX, TY, TZ, THREADS>;
  }();
  // above 48 KB a kernel has to ask for its dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  kernel<<<grid, THREADS, smem, stream>>>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2,
                                          (uint32_t)seed, ox, oy, oz);
  return (int)cudaGetLastError();
}

// 32 bytes a slot of the tile and its halo, beside ~2.5 KB of static arrays,
// inside the 227 KB a block may have
static_assert(BIG_TILE_MAX_KC <= 0 ||
                  Tile<4, 4, 8, 512>::slot_bytes(BIG_TILE_MAX_KC) <= 222 * 1024,
              "the big tile's slots do not fit a block");
static_assert(Tile<4, 4, 4, 256>::slot_bytes(MASK_BITS) <= 224 * 1024,
              "the small tile's slots do not fit a block");

}  // namespace

// pos, g, dpos: (3, KC, nx, ny, nz); mask, dmask: (KC, nx, ny, nz); all f32
// contiguous, any KC >= 1; dmask may be null; (ox, oy, oz) the global
// coordinates of local cell 0.
extern "C" int lf_correction_bwd(const float* pos, const float* mask, const float* g, float* dpos,
                                 float* dmask, int KC, int nx, int ny, int nz, float re2, int seed,
                                 int ox, int oy, int oz, void* stream) {
  if (KC < 1) return (int)cudaErrorInvalidValue;
  if ((long long)nx * ny * nz == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (KC <= BIG_TILE_MAX_KC)
    return launch<4, 4, 8, 512, false>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2, seed, ox, oy,
                                       oz, st);
  return launch<4, 4, 4, 256, true>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2, seed, ox, oy, oz,
                                    st);
}
