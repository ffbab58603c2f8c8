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
// Bound: the ~230 ordered pairs of an occupied slot's 27 cells are ~45
// float32 operations each (4.16e8 pairs at the 128^3 main path: 0.28 ms at
// this card's peak), but only the pairs closer than re have a term that is
// not an exact 0, a few per cent of them. The bytes bound it: the masks
// read and d x, d m written over all KC * cells slots, the positions and g
// of the occupied slots read (g at an empty slot is never needed; 0.55 GB
// at the main path's KC = 12 and 2.0M particles: 0.165 ms).
//
// Design: a warp a target cell, its slots (the i's) against the slots of
// its 27 neighbour cells (the j's) spread over the lanes.
//   1. One block per TILES = 4 tiles of 2 x 4 x 8 cells along z, 8 warps. A
//      thread a (slot, cell) of the four reads the masks and writes the
//      zeros of the empty slots (rows of 32 cells along z); a tile with no
//      particle (most of a dam-break's domain) is done then. Four tiles a
//      block pay that phase's latency once for the four (one and eight
//      tiles a block: tools/kernel_variants.py --backward).
//   2. The occupied slots of the tile and its one-cell halo are staged in
//      shared memory, compacted in cell order (z fastest) and slot order,
//      as two 16-byte words (x, y, z, m) and (g, jitter . g): a thread a
//      halo cell reads its occupancy bits, a scan over the 240 cells' counts
//      (a warp's, then the warps') gives their places, then a thread a
//      (slot, cell) puts the slot in its place. The jitter of a slot, which
//      needs its cell and slot number, is hashed once here, not per
//      coincident pair. Only the occupied slots take room: 92 KB at KC = 12
//      full, so two blocks share an SM.
//   3. A warp takes the tile's cells in turn. The 27 neighbour cells are 9
//      runs of three cells along z, each one contiguous range of the staged
//      list (~200 j's at the main path's fill). A j farther than re from
//      the box of the cell's i's (with a margin for the roundings of both
//      distances) is farther than re from every i: each of its pairs adds
//      an exact 0, and it is left out. The others (~a quarter) are
//      compacted in order (dx, dy ascending, then z and slot: E's order)
//      into the warp's list, a run's j's a lane each and a ballot. Lane l
//      takes the kept j's l, l + 32, ...; for each it loops over the cell's
//      i's, read as shared-memory broadcasts, IG at a time so that their
//      pairs overlap, and accumulates (d x, d m) per i in registers, NI
//      buckets (a template: 4, 8, 12, 16). The self-pair is skipped by its
//      place in the list (it adds exact zeros to d x; only its
//      coincident-pair term is left out).
//   4. A transposed tree over the lanes sums each i's four values (the same
//      pairs of lanes as a butterfly xor 16, 8, 4, 2, 1, so the same bits, at
//      a quarter of the shuffles), and each lane writes the value it ends
//      with. Same bits from run to run; the order differs from kernel E's (a
//      lane's j's, then the tree).
// Slots are staged a word of WORD = 16 at a time (the i's of a cell are
// then at most 16, the largest register bucket): above 16 slots a cell the
// block stages the neighbours' slots a word at a time, takes each cell's
// own slots a word at a time (read into a small per-warp buffer where that
// word is not the staged one), and a slot writes its cotangents after the
// first word of neighbours and adds the others'. Any KC >= 1.
// 1 / sqrt(s) is the rsqrt instruction without rsqrtf's fix-up for
// denormal inputs (s >= 1e-12 wherever it is used), the same bits as
// rsqrtf there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jitter.cuh"

namespace {

constexpr int TX = 2, TY = 4, TZ = 8;  // cells a tile
constexpr int TILES = 4;  // tiles a block, along z
constexpr int HY = TY + 2, HZ = TZ + 2;
constexpr int CELLS = TX * TY * TZ;
constexpr int HALO = (TX + 2) * HY * HZ;  // the tile with its one-cell halo
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WORD = 16;  // slots a cell staged at a time
constexpr int IG = 2;  // a cell's i's taken together (their pairs overlap)
constexpr float BIG = 3.0e38f;
static_assert(CELLS % WARPS == 0, "cells a warp");
static_assert(HALO <= THREADS, "a thread a halo cell");

__host__ __device__ constexpr int word_slots(int KC) { return KC < WORD ? KC : WORD; }

// the staged list's room in each of its two planes: a word of slots of every
// halo cell, and WORD more, which a cell's last group of i's may read past
// its own (what it reads there is not used)
__host__ __device__ constexpr int list_room(int KC) { return HALO * word_slots(KC) + WORD; }

// two 16-byte words a staged slot
size_t shared_bytes(int KC) { return (size_t)2 * list_room(KC) * sizeof(float4); }

// 1 / sqrt(x) for a normal x: rsqrtf without its fix-up for denormals
__device__ __forceinline__ float rsqrt_normal(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return rsqrtf(x);
#endif
}

// a tile cell's index among the cells of the tile with its halo
__device__ __forceinline__ int halo_of(int cl) {
  return ((cl / (TY * TZ) + 1) * HY + ((cl / TZ) % TY + 1)) * HZ + (cl % TZ + 1);
}

// jitter . g of slot k of global cell (cx, cy, cz)
__device__ __forceinline__ float jitter_dot(uint32_t seed, int cx, int cy, int cz, int k, float gx,
                                            float gy, float gz) {
  return jitter_value(seed, cx, cy, cz, k, 0) * gx + jitter_value(seed, cx, cy, cz, k, 1) * gy +
         jitter_value(seed, cx, cy, cz, k, 2) * gz;
}

// One step of a transposed sum over the lanes: lanes l and l ^ o pair up,
// the one with bit o clear keeps the sums of v[0, N/2), the other those of
// v[N/2, N), in v[0, N/2). Each value is summed over the same pairs of lanes
// as in a butterfly (xor 16, 8, 4, 2, 1), so with the same bits, at a
// quarter of its shuffles.
template <int N>
__device__ __forceinline__ void halve(float* v, int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int a = 0; a < N / 2; ++a) {
    const float send = up ? v[a] : v[a + N / 2];
    const float keep = up ? v[a + N / 2] : v[a];
    v[a] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// v[0, 32) summed over the lanes: lane l returns the sum of v[l]
__device__ __forceinline__ float sum32(float* v, int lane) {
  halve<32>(v, lane, 16);
  halve<16>(v, lane, 8);
  halve<8>(v, lane, 4);
  halve<4>(v, lane, 2);
  halve<2>(v, lane, 1);
  return v[0];
}

// v[0, 16) summed over the lanes: lanes l and l ^ 1 return the sum of v[l / 2]
__device__ __forceinline__ float sum16(float* v, int lane) {
  halve<16>(v, lane, 16);
  halve<8>(v, lane, 8);
  halve<4>(v, lane, 4);
  halve<2>(v, lane, 2);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <int NI>
__global__ void __launch_bounds__(THREADS, 2)
correction_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                      const float* __restrict__ g, float* __restrict__ dpos,
                      float* __restrict__ dmask, int KC, int nx, int ny, int nz, float re2,
                      uint32_t seed, int ox, int oy, int oz) {
  extern __shared__ float4 staged[];   // (x, y, z, m) of every staged slot, then (g, jitter . g)
  __shared__ uint32_t occupied[HALO];  // a halo cell's occupied slots of the staged word
  __shared__ int first[HALO + 1];      // the place of its first slot in the staged list
  __shared__ int warp_count[WARPS];
  __shared__ float4 own_pos[WARPS][NI + IG], own_cot[WARPS][NI + IG];  // a cell's i's of another word
  __shared__ int reach[WARPS][27 * NI];  // the places of a cell's j's in reach of its i's
  const long long C = (long long)nx * ny * nz;
  const long long KCC = (long long)KC * C;
  float4* const spos = staged;
  float4* const scot = staged + list_room(KC);
  const float inv_re2 = 1.0f / re2;
  const float six_re2 = 6.0f * inv_re2;
  const float cut2 = re2 * 1.001f;  // a j this far from the box of a cell's i's reaches none of them
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, z0 = blockIdx.x * TZ * TILES;

  // 1. the masks of the block's TILES tiles: zeros for the empty slots;
  // which tiles hold a particle? (A block for a few tiles: most of a
  // dam-break's tiles hold none, and each block's latency is paid once.)
  constexpr int ZS = TZ * TILES;  // the block's cells along z
  uint32_t any = 0;  // bit q: tile q
#pragma unroll 4
  for (int t = threadIdx.x; t < KC * CELLS * TILES; t += THREADS) {
    const int cl = t % (CELLS * TILES), k = t / (CELLS * TILES);
    const int i = t0x + cl / (TY * ZS), j = t0y + (cl / ZS) % TY, l = z0 + cl % ZS;
    if (i >= nx || j >= ny || l >= nz) continue;
    const long long s = (long long)k * C + ((long long)i * ny + j) * nz + l;
    if (mask[s] != 0.0f) {
      any |= 1u << (cl % ZS / TZ);
      continue;
    }
    dpos[s] = 0.0f;
    dpos[KCC + s] = 0.0f;
    dpos[2 * KCC + s] = 0.0f;
    if (dmask) dmask[s] = 0.0f;
  }
  uint32_t live = 0;
#pragma unroll
  for (int q = 0; q < TILES; ++q) live |= (uint32_t)(__syncthreads_or(any >> q & 1u) != 0) << q;

  for (int tile = 0; tile < TILES; ++tile) {  // the block's tiles that hold a particle
    if (!(live >> tile & 1u)) continue;
    const int t0z = z0 + tile * TZ;

    for (int wj = 0; wj < KC; wj += WORD) {  // the neighbours' slots wj ... wj + WORD - 1
      const int nj = min(KC - wj, WORD);
      __syncthreads();  // the last word's list is read
      // 2. the word's occupied slots of the tile and its halo: a thread a
      // halo cell reads its bits, their places come from a scan over the
      // cells' counts (each warp's, then the warps' totals), then a thread a
      // (slot, cell) puts the slots in their places
      {
        const int h = threadIdx.x;
        const int i = t0x - 1 + h / (HY * HZ), j = t0y - 1 + (h / HZ) % HY, l = t0z - 1 + h % HZ;
        uint32_t bits = 0;
        if (h < HALO && i >= 0 && i < nx && j >= 0 && j < ny && l >= 0 && l < nz) {
          const float* m = mask + (long long)wj * C + ((long long)i * ny + j) * nz + l;
#pragma unroll
          for (int k = 0; k < WORD; ++k)
            if (k < nj) bits |= (m[k * C] != 0.0f ? 1u : 0u) << k;
        }
        const int count = __popc(bits);
        int upto = count;  // the counts of the warp's cells up to this one
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int below = __shfl_up_sync(0xffffffffu, upto, o);
          if (lane >= o) upto += below;
        }
        if (lane == 31) warp_count[warp] = upto;
        __syncthreads();
        int before = upto - count;
        for (int q = 0; q < warp; ++q) before += warp_count[q];
        if (h < HALO) {
          occupied[h] = bits;
          first[h] = before;
        }
        if (h == HALO - 1) first[HALO] = before + count;
      }
      __syncthreads();
#pragma unroll 4
      for (int t = threadIdx.x; t < nj * HALO; t += THREADS) {
        const int h = t % HALO, k = t / HALO;
        const uint32_t bits = occupied[h];
        if (!(bits >> k & 1u)) continue;
        const int i = t0x - 1 + h / (HY * HZ), j = t0y - 1 + (h / HZ) % HY, l = t0z - 1 + h % HZ;
        const long long s = (long long)(wj + k) * C + ((long long)i * ny + j) * nz + l;
        const float gx = g[s], gy = g[KCC + s], gz = g[2 * KCC + s];
        const int at = first[h] + __popc(bits & ((1u << k) - 1u));
        spos[at] = make_float4(pos[s], pos[KCC + s], pos[2 * KCC + s], mask[s]);
        scot[at] = make_float4(gx, gy, gz, jitter_dot(seed, i + ox, j + oy, l + oz, wj + k, gx, gy, gz));
      }
      __syncthreads();

      // 3. a warp a cell of the tile
      for (int cl = warp; cl < CELLS; cl += WARPS) {
        const int i = t0x + cl / (TY * TZ), j = t0y + (cl / TZ) % TY, l = t0z + cl % TZ;
        if (i >= nx || j >= ny || l >= nz) continue;
        const long long cell = ((long long)i * ny + j) * nz + l;
        const int hc = halo_of(cl);
        for (int wi = 0; wi < KC; wi += WORD) {  // the cell's own slots wi ... wi + WORD - 1
          uint32_t bits;
          const float4 *ip, *ic;
          int self;  // the place of the cell's first i in the staged list (none: far below)
          if (wi == wj) {
            bits = occupied[hc];
            self = first[hc];
            ip = spos + self;
            ic = scot + self;
          } else {
            const long long s = (long long)(wi + lane) * C + cell;
            const bool occ = lane < min(KC - wi, WORD) && mask[s] != 0.0f;
            bits = __ballot_sync(0xffffffffu, occ);
            __syncwarp();  // the last cell's i's are read
            if (occ) {
              const float gx = g[s], gy = g[KCC + s], gz = g[2 * KCC + s];
              const int at = __popc(bits & ((1u << lane) - 1u));
              own_pos[warp][at] = make_float4(pos[s], pos[KCC + s], pos[2 * KCC + s], mask[s]);
              own_cot[warp][at] =
                  make_float4(gx, gy, gz, jitter_dot(seed, i + ox, j + oy, l + oz, wi + lane, gx, gy, gz));
            }
            __syncwarp();
            self = -(1 << 30);
            ip = own_pos[warp];
            ic = own_cot[warp];
          }
          const int ni = __popc(bits);
          if (ni == 0) continue;

          // 3a. the box of the cell's i's (a lane an i, then the lanes' extremes)
          float lox = BIG, loy = BIG, loz = BIG, hix = -BIG, hiy = -BIG, hiz = -BIG;
          if (lane < ni) {
            const float4 me = ip[lane];
            lox = hix = me.x;
            loy = hiy = me.y;
            loz = hiz = me.z;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            lox = fminf(lox, __shfl_xor_sync(0xffffffffu, lox, o));
            loy = fminf(loy, __shfl_xor_sync(0xffffffffu, loy, o));
            loz = fminf(loz, __shfl_xor_sync(0xffffffffu, loz, o));
            hix = fmaxf(hix, __shfl_xor_sync(0xffffffffu, hix, o));
            hiy = fmaxf(hiy, __shfl_xor_sync(0xffffffffu, hiy, o));
            hiz = fmaxf(hiz, __shfl_xor_sync(0xffffffffu, hiz, o));
          }
          // 3b. the j's in reach of that box, compacted in order into the
          // warp's list: the 9 runs r = (dx, dy) of three cells along z (lane r
          // reads run r's first place and count), each a lane a j. A j left out
          // is farther than re from every i (with a margin for the roundings of
          // both distances), so each of its pairs would add an exact 0.
          int* const near = reach[warp];
          int kept = 0;
          {
            int rlo = 0, rlen = 0;
            if (lane < 9) {
              const int nb = hc + ((lane / 3 - 1) * HY + lane % 3 - 1) * HZ;
              rlo = first[nb - 1];
              rlen = first[nb + 2] - rlo;
            }
            // a run holds three words of slots at most: 32 j's a lane's first
            // pass, the rest (a second) where the run holds more
#pragma unroll
            for (int r = 0; r < 9; ++r) {
              const int lo = __shfl_sync(0xffffffffu, rlo, r), len = __shfl_sync(0xffffffffu, rlen, r);
#pragma unroll
              for (int p = 0; p < 3 * WORD; p += 32) {
                if (p == 0 || p < len) {  // no branch in a run's first pass: the loads go together
                  const int v = p + lane;
                  const float4 q = spos[lo + max(min(v, len - 1), 0)];
                  const float dx = fmaxf(fmaxf(lox - q.x, q.x - hix), 0.0f);
                  const float dy = fmaxf(fmaxf(loy - q.y, q.y - hiy), 0.0f);
                  const float dz = fmaxf(fmaxf(loz - q.z, q.z - hiz), 0.0f);
                  const bool in = v < len && dx * dx + dy * dy + dz * dz < cut2;
                  const uint32_t ins = __ballot_sync(0xffffffffu, in);
                  if (in) near[kept + __popc(ins & ((1u << lane) - 1u))] = lo + v;
                  kept += __popc(ins);
                }
              }
            }
          }
          __syncwarp();

          float acc[NI][4];
#pragma unroll
          for (int ii = 0; ii < NI; ++ii) acc[ii][0] = acc[ii][1] = acc[ii][2] = acc[ii][3] = 0.0f;
          // 3c. lane l takes the kept j's l, l + 32, ...; for each, the i's IG
          // at a time (their pairs are independent, so they overlap)
          for (int v = lane; v < kept; v += 32) {
            const int e = near[v];
            const float4 q = spos[e], qg = scot[e];
            const int place = e - self;  // the j's place among the i's, if it is one
#pragma unroll
            for (int i0 = 0; i0 < NI; i0 += IG) {
              if (i0 < ni) {
#pragma unroll
                for (int ii = i0; ii < i0 + IG; ++ii) {
                  const float4 me = ip[ii], mine = ic[ii];
                  const float ex = me.x - q.x, ey = me.y - q.y, ez = me.z - q.z;
                  const float sq = ex * ex + ey * ey + ez * ez;
                  const bool coincide = sq < 1e-12f;
                  const float kl = fmaxf(1.0f - sq * inv_re2, 0.0f);
                  const float rs = coincide ? 0.0f : rsqrt_normal(sq);
                  const float kk = q.w * kl * kl * rs;                // m_j k^2 / sqrt(s)
                  const float w = kk * kl;                            // m_j w
                  const float w2 = -kk * (six_re2 + kl * rs * rs);    // m_j 2 w'
                  const float Gx = mine.x - qg.x, Gy = mine.y - qg.y, Gz = mine.z - qg.z;
                  const float rG = ex * Gx + ey * Gy + ez * Gz;
                  const float c = w2 * rG;
                  acc[ii][0] = fmaf(c, ex, fmaf(w, Gx, acc[ii][0]));
                  acc[ii][1] = fmaf(c, ey, fmaf(w, Gy, acc[ii][1]));
                  acc[ii][2] = fmaf(c, ez, fmaf(w, Gz, acc[ii][2]));
                  acc[ii][3] = fmaf(w, rG, acc[ii][3]);
                  if (coincide && place != ii) acc[ii][3] = fmaf(q.w, mine.w + qg.w, acc[ii][3]);
                }
              }
            }
          }

          // 4. each i's sums over the lanes, 8 i's (32 values) at a time in a
          // transposed tree, the last 4 (16 values) where NI is not a multiple
          // of 8; each lane writes the sum it holds
          float* const flat = &acc[0][0];
#pragma unroll
          for (int b = 0; b < NI; b += 8) {
            if (b < ni) {
              const bool whole = NI - b >= 8;
              const float sum = whole ? sum32(flat + 4 * b, lane) : sum16(flat + 4 * b, lane);
              const int at = whole ? lane : lane >> 1;  // the value it holds
              const int ii = b + at / 4, c = at % 4;
              if (ii < ni && (whole || !(lane & 1)) && (c < 3 || dmask)) {
                uint32_t rest = bits;  // the slot of the ii-th i: its cell's ii-th occupied slot
                for (int t = 0; t < ii; ++t) rest &= rest - 1;
                const long long s = (long long)(wi + __ffs(rest) - 1) * C + cell;
                float* const out = c < 3 ? dpos + c * KCC + s : dmask + s;
                const float value = c < 3 ? ip[ii].w * sum : sum;
                if (wj == 0)
                  *out = value;
                else
                  *out += value;
              }
            }
          }
          __syncwarp();  // the lanes have read the i's and the list
        }
      }
    }
  }
}

template <int NI>
int launch(const float* pos, const float* mask, const float* g, float* dpos, float* dmask, int KC,
           int nx, int ny, int nz, float re2, int seed, int ox, int oy, int oz,
           cudaStream_t stream) {
  const size_t smem = shared_bytes(KC);
  // above 48 KB a kernel has to ask for its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(correction_bwd_kernel<NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nz + TZ * TILES - 1) / (TZ * TILES), (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  correction_bwd_kernel<NI><<<grid, THREADS, smem, stream>>>(pos, mask, g, dpos, dmask, KC, nx, ny,
                                                             nz, re2, (uint32_t)seed, ox, oy, oz);
  return (int)cudaGetLastError();
}

// a word of slots staged, with the i buffers and the scan's arrays, inside
// the 227 KB a block may have
static_assert(2 * (HALO * WORD + WORD) * 16 + 2 * WARPS * (WORD + IG) * 16 + WARPS * 27 * WORD * 4 +
                      8 * HALO <= 227 * 1024,
              "a word of staged slots does not fit a block");

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
  if (KC <= 4) return launch<4>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2, seed, ox, oy, oz, st);
  if (KC <= 8) return launch<8>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2, seed, ox, oy, oz, st);
  if (KC <= 12)
    return launch<12>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2, seed, ox, oy, oz, st);
  return launch<WORD>(pos, mask, g, dpos, dmask, KC, nx, ny, nz, re2, seed, ox, oy, oz, st);
}
