// Kernel B: P2G face sums from the slot grid.
//
// Replaces libfluid_tpu/sim/kernels.py:_p2g_kernel (launched through
// p2g_lo_faces_pallas), together with the jnp hi-plane pass
// transfers._p2g_hi_plane that completes it. Computes, for every face of
// u (nx+1, ny, nz), v (nx, ny+1, nz) and w (nx, ny, nz+1), the UNNORMALIZED
// APIC momentum  sum m * W * (v_a + A_a . (x_face - x_p))  and weight
// sum m * W over the K slots of the cells in the face's staggered support,
// W the trilinear hat in cell units. The caller adds the overflow particles
// and normalizes.
//
// Gather form over the (nx+1, ny+1, nz+1) lattice: point (i, j, l) owns the
// lo faces of cell (i, j, l) along each axis that has one there. The face
// along axis a sums the cells b = f - d with d_a in {0, 1} and the two
// transverse d in {-1, 0, 1} (18 of the 27 cells around the point). No
// atomics: the result is the same from run to run.
//
// Bound: bytes. The function must read the mask row of every slot (101 MB
// at 128^3, K = 12), the other 15 rows of the occupied slots and write the
// six face arrays: 0.08 ms at the main path's shapes, against ~3 GFLOP of
// arithmetic. A thread a lattice point walking device memory (the kernel
// this replaces) spent its time on 27 K mask loads a point, most of them
// for empty space, and on 27 loads of every occupied slot's rows.
//
// Design: one block per tile of TX x TY x TZ = 4 x 16 x 16 lattice points,
// one thread per (j, l) column of the tile, which owns the tile's TX points
// along x. The slots are taken a word of 32 at a time (slots 0-31, then
// 32-63, ...: one pass at the main path's 12), steps 1-3 once a word:
//   1. The block reads the word's masks of the tile's cells and their
//      one-cell halo once into an occupancy bit mask per cell. A word with
//      no slot in reach (a tile in the empty part of a dam-break's domain)
//      is skipped: empty space costs one read of the masks.
//   2. A prefix sum over the cells' counts gives every cell's place in one
//      list of the occupied slots, in cell order (x, y, z) and slot order.
//      The list is brought into shared memory in chunks of whole cells, at
//      most CAP slots a chunk, so the shared memory does not limit K or the
//      fill: a chunk holds, per slot, five 16-byte words in five planes
//      (cell coordinates and mass; position and v_x; v_y, v_z and the
//      affine rows), the division by the cell size done once per slot. A
//      cell's list takes an odd number of places, so that the lanes of a
//      warp (z neighbours, which read neighbouring cells) spread over the
//      banks.
//      The slots are loaded a thread a (cell, place in the cell), so that
//      a warp reads neighbouring cells out of one row of the payload and a
//      slot's 16 loads do not wait for each other.
//   3. For each chunk a thread walks the x-planes of cells in it and, per
//      plane, the 3 x 3 cells around its column; a slot it loads feeds the
//      faces of the three points of the column that reach it (x offsets
//      -1, 0, +1), so a slot is loaded 9 times a tile and not 27. The sums
//      stay in registers across chunks. Each point sees its cells in the
//      order x, y, z offset ascending, then slot ascending, whatever the
//      tile's shape or the chunks' cut: the order of the
//      one-thread-per-point kernel, so the bits do not depend on either.
//      Above 32 slots a cell the order is word, then cells, then slot.
// x_face - x_p is formed before it multiplies the affine row (folding
// A . x_p into a constant per slot would cancel at coordinates of ~128).
//
// Shared memory: 5 x 16 B x CAP dynamic (80 KB) and 8 B a cell of the tile
// with its halo (16 KB): two blocks of 256 threads an SM, at any K.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the tile of lattice points, and the cells it reaches
constexpr int TX = 4, TY = 16, TZ = 16, THREADS = TY * TZ;
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int PLANE_CELLS = HY * HZ, HALO_CELLS = HX * PLANE_CELLS;
constexpr int GROUPS = (HALO_CELLS + 31) / 32;  // for the scan over the cells' counts
constexpr int CAP = 1024;                       // slots a chunk
constexpr int WORDS = 5;                        // 16-byte words a slot
constexpr int MASK_BITS = 32;                   // slots an occupancy mask
static_assert(CAP > MASK_BITS, "a chunk holds at least one full cell");

__device__ __forceinline__ float hat(float t) { return fmaxf(1.0f - fabsf(t), 0.0f); }

// places a cell takes in the list: odd, so that neighbouring cells' lists
// start in different banks
__device__ __forceinline__ int places(uint32_t bits) { return bits ? (__popc(bits) | 1) : 0; }

struct Faces {
  float *num_u, *num_v, *num_w, *den_u, *den_v, *den_w;
};

// the faces of lattice point (i, j, l) that exist
__device__ __forceinline__ void store(const Faces& f, int i, int j, int l, int nx, int ny, int nz,
                                      float nu, float du, float nv, float dv, float nw,
                                      float dw) {
  if (i > nx || j > ny || l > nz) return;
  if (j < ny && l < nz) {
    const long long at = ((long long)i * ny + j) * nz + l;
    f.num_u[at] = nu;
    f.den_u[at] = du;
  }
  if (i < nx && l < nz) {
    const long long at = ((long long)i * (ny + 1) + j) * nz + l;
    f.num_v[at] = nv;
    f.den_v[at] = dv;
  }
  if (i < nx && j < ny) {
    const long long at = ((long long)i * ny + j) * (nz + 1) + l;
    f.num_w[at] = nw;
    f.den_w[at] = dw;
  }
}

__global__ void __launch_bounds__(THREADS)
p2g_kernel(const float* __restrict__ data, Faces out, int K, int nx, int ny, int nz, float h,
           float ox, float oy, float oz, int use_affine) {
  extern __shared__ float4 pool[];             // WORDS planes of CAP slots
  __shared__ uint32_t occupied[HALO_CELLS];    // a cell's occupied slots, bit k for slot w0 + k
  __shared__ int first[HALO_CELLS + 1];        // a cell's place in the list of slots
  __shared__ int group_places[GROUPS];
  __shared__ uint32_t seen;                    // the word's slots occupied in any cell
  const long long C = (long long)nx * ny * nz;
  const long long col = (long long)K * C;  // stride between payload rows
  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, t0z = blockIdx.x * TZ;
  const int tj = threadIdx.x / TZ, tl = threadIdx.x % TZ;  // z fastest: stores coalesce
  const int j = t0y + tj, l = t0z + tl;

  // the column's faces: world coordinates of their centres along y and z
  const float fj = (float)j, fl = (float)l;
  const float yj = fj * h + oy, zl = fl * h + oz;
  const float yc = (fj + 0.5f) * h + oy, zc = (fl + 0.5f) * h + oz;
  float nu[TX], du[TX], nv[TX], dv[TX], nw[TX], dw[TX];
#pragma unroll
  for (int i = 0; i < TX; ++i) nu[i] = du[i] = nv[i] = dv[i] = nw[i] = dw[i] = 0.f;

  for (int w0 = 0; w0 < K; w0 += MASK_BITS) {  // the slots w0 ... w0 + 31
    // 1. the word's occupancy of the tile's cells and halo; cells outside the
    // grid hold no slot
    if (threadIdx.x == 0) seen = 0u;
    __syncthreads();
    const int kw = min(K - w0, MASK_BITS);
    uint32_t mine = 0u;
    for (int hc = threadIdx.x; hc < HALO_CELLS; hc += THREADS) {
      const int ci = t0x - 1 + hc / PLANE_CELLS, cj = t0y - 1 + (hc / HZ) % HY,
                cl = t0z - 1 + hc % HZ;
      uint32_t bits = 0;
      if (ci >= 0 && ci < nx && cj >= 0 && cj < ny && cl >= 0 && cl < nz) {
        const float* m = data + 3 * col + (long long)w0 * C + ((long long)ci * ny + cj) * nz + cl;
#pragma unroll 4
        for (int k = 0; k < kw; ++k) bits |= (m[k * C] != 0.0f ? 1u : 0u) << k;
      }
      occupied[hc] = bits;
      mine |= bits;
    }
    if (mine) atomicOr(&seen, mine);
    __syncthreads();
    const uint32_t any_slot = seen;
    __syncthreads();  // every thread has read `seen` before the next word resets it
    if (!any_slot) continue;
    const int most = __popc(any_slot);  // no cell holds more of the word's slots than this

    // 2. every cell's place in the list: the places of each group of 32
    // cells, then each cell's place in its group
    for (int g = threadIdx.x; g < GROUPS; g += THREADS) {
      int sum = 0;
      for (int hc = 32 * g; hc < 32 * g + 32 && hc < HALO_CELLS; ++hc) sum += places(occupied[hc]);
      group_places[g] = sum;
    }
    __syncthreads();
    for (int hc = threadIdx.x; hc < HALO_CELLS; hc += THREADS) {
      int before = 0;
      for (int g = 0; g < hc / 32; ++g) before += group_places[g];
      for (int c = hc & ~31; c < hc; ++c) before += places(occupied[c]);
      first[hc] = before;
      if (hc == HALO_CELLS - 1) first[HALO_CELLS] = before + places(occupied[hc]);
    }
    __syncthreads();
    const int total = first[HALO_CELLS];

    // 3. the list, a chunk of whole cells [c0, c1) at a time
    for (int c0 = 0; c0 < HALO_CELLS;) {
      const int base = first[c0];
      int c1 = HALO_CELLS;
      if (total - base > CAP) {  // the last cell that still fits (one always does)
        int lo = c0 + 1;
        while (lo < c1) {
          const int mid = (lo + c1 + 1) >> 1;
          if (first[mid] - base <= CAP) lo = mid; else c1 = mid - 1;
        }
      }

      // 3a. the chunk's slots, a thread a (cell, place in the cell) pair: the
      // lanes of a warp read neighbouring cells' slots out of one row of the
      // payload, and a slot's 16 loads do not wait for each other
      const int ncell = c1 - c0;
#pragma unroll 1
      for (int t = threadIdx.x; t < ncell * most; t += THREADS) {
        const int hc = c0 + t % ncell, nth = t / ncell;
        uint32_t rest = occupied[hc];
        if (nth >= __popc(rest)) continue;
        for (int n = 0; n < nth; ++n) rest &= rest - 1;  // the cell's nth occupied slot
        const int ci = t0x - 1 + hc / PLANE_CELLS, cj = t0y - 1 + (hc / HZ) % HY,
                  cl = t0z - 1 + hc % HZ;
        const float* s =
            data + (long long)(w0 + __ffs(rest) - 1) * C + ((long long)ci * ny + cj) * nz + cl;
        float4* dst = pool + (first[hc] - base + nth);
        const float px = s[0], py = s[col], pz = s[2 * col];
        // cell coordinates, mass | position, v_x | v_y, v_z, A_xx, A_xy |
        // A_xz, A_yx, A_yy, A_yz | A_zx, A_zy, A_zz
        dst[0] = make_float4((px - ox) / h, (py - oy) / h, (pz - oz) / h, s[3 * col]);
        dst[CAP] = make_float4(px, py, pz, s[4 * col]);
        if (use_affine) {
          dst[2 * CAP] = make_float4(s[5 * col], s[6 * col], s[7 * col], s[8 * col]);
          dst[3 * CAP] = make_float4(s[9 * col], s[10 * col], s[11 * col], s[12 * col]);
          dst[4 * CAP] = make_float4(s[13 * col], s[14 * col], s[15 * col], 0.f);
        } else {
          dst[2 * CAP] = make_float4(s[5 * col], s[6 * col], 0.f, 0.f);
        }
      }
      __syncthreads();

      // 3b. the x-planes of cells in the chunk: plane p holds the cells at
      // x = t0x - 1 + p and feeds point i of the column with x offset
      // p - 1 - i
#pragma unroll
      for (int p = 0; p < HX; ++p) {
        if ((p + 1) * PLANE_CELLS <= c0 || p * PLANE_CELLS >= c1) continue;
        const float cx = (float)(t0x - 1 + p);
#pragma unroll 1
        for (int n = 0; n < 9; ++n) {  // y offset, then z offset
          const int dy = n / 3 - 1, dz = n % 3 - 1;
          const int hc = (p * HY + tj + 1 + dy) * HZ + tl + 1 + dz;
          if (hc < c0 || hc >= c1) continue;
          const int count = __popc(occupied[hc]);
          // a face along axis a reaches cells b with b_a in {f_a - 1, f_a}
          const bool cv = dy != 1, cw = dz != 1;
          const float4* list = pool + (first[hc] - base);
#pragma unroll 1
          for (int e = 0; e < count; ++e) {
            const float4 g = list[e], x = list[CAP + e], c = list[2 * CAP + e];
            float4 d = make_float4(0.f, 0.f, 0.f, 0.f), a = d;
            if (use_affine) {
              d = list[3 * CAP + e];
              a = list[4 * CAP + e];
            }
            const float hy0 = hat(g.y - fj), hy5 = hat(g.y - 0.5f - fj);
            const float hz0 = hat(g.z - fl), hz5 = hat(g.z - 0.5f - fl);
            const float wu = g.w * hy5 * hz5, wv = g.w * hy0 * hz5, ww = g.w * hy5 * hz0;
            const float y0 = yj - x.y, y5 = yc - x.y, z0 = zl - x.z, z5 = zc - x.z;
            // the value at a face without its x term
            const float su = x.w + c.w * y5 + d.x * z5;
            const float sv = c.x + d.z * y0 + d.w * z5;
            const float sw = c.y + a.y * y5 + a.z * z0;
#pragma unroll
            for (int r = 0; r < 3; ++r) {  // x offset r - 1 of the cell from the point
              const int i = p - r;
              if (i < 0 || i >= TX) continue;
              const float fi = cx + (float)(1 - r);
              if (r != 2) {
                const float w = wu * hat(g.x - fi);
                nu[i] += w * (su + c.z * (fi * h + ox - x.x));
                du[i] += w;
              }
              const float hx5 = hat(g.x - 0.5f - fi);
              const float xc = (fi + 0.5f) * h + ox - x.x;
              if (cv) {
                const float w = wv * hx5;
                nv[i] += w * (sv + d.y * xc);
                dv[i] += w;
              }
              if (cw) {
                const float w = ww * hx5;
                nw[i] += w * (sw + a.x * xc);
                dw[i] += w;
              }
            }
          }
        }
      }
      __syncthreads();  // before the next chunk overwrites the pool
      c0 = c1;
    }
  }

#pragma unroll
  for (int i = 0; i < TX; ++i)
    store(out, t0x + i, j, l, nx, ny, nz, nu[i], du[i], nv[i], dv[i], nw[i], dw[i]);
}

constexpr size_t POOL_BYTES = (size_t)WORDS * CAP * sizeof(float4);

}  // namespace

// data: (16, K, nx, ny, nz) f32 slot payload, any K >= 1; outputs: the six
// face arrays.
extern "C" int lf_p2g(const float* data, float* num_u, float* num_v, float* num_w,
                      float* den_u, float* den_v, float* den_w, int K, int nx, int ny,
                      int nz, float h, float ox, float oy, float oz, int use_affine,
                      void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel has to ask for its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(p2g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)POOL_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nz + TZ) / TZ, (ny + TY) / TY, (nx + TX) / TX);  // n + 1 points an axis
  const Faces out{num_u, num_v, num_w, den_u, den_v, den_w};
  p2g_kernel<<<grid, THREADS, POOL_BYTES, (cudaStream_t)stream>>>(
      data, out, K, nx, ny, nz, h, ox, oy, oz, use_affine);
  return (int)cudaGetLastError();
}
