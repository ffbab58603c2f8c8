// Kernel B': the adjoint of kernel B (P2G face sums from the slot grid).
//
// Replaces the backward of libfluid_tpu/sim/kernels.py:_p2g_kernel, which
// the JAX package takes as jax.vjp of its jnp oracle
// (transfers._p2g_bwd over _p2g_slots_jnp). Forward, each face f = c + d of
// axis a (d_a in {0, 1}, the other two d in {-1, 0, 1}) sums over the K
// slots of cell c
//   num_a[f] += m * H * val,   den_a[f] += m * H,
//   H = prod_q hat(t_q),  t_q = (x_q - o_q) / h - shift_q - f_q,
//   val = v_a + sum_q A_aq * (x_face_q - x_q)   (APIC only).
// Backward, every slot gathers the cotangents (gn, gd) of the faces in its
// staggered support and sums
//   d m     = (gn * val + gd) * H
//   d v_a   = gn * m * H
//   d A_aq  = gn * m * H * (x_face_q - x_q)
//   d x_q   = (gn * val + gd) * m * hat'(t_q) * prod_{q' != q} hat(t_q') / h
//             - gn * m * H * A_aq.
// hat' takes the JAX package's subgradients (slope -1 at t = 0, half the
// slope at |t| = 1), so the result equals jax.vjp of the oracle. Empty slots
// get 0. No atomics: each slot's 16 rows are written by one thread, so the
// result is the same from run to run.
//
// Bound: bytes. The cotangent has the payload's size (1.6 GB at 128^3,
// K = 12) and is written once, 0.48 ms of the 0.56; the rest is the mask row,
// the 15 other rows of the occupied slots (some 6 % of all) and the six face
// cotangents read once.
//
// Design: two launches behind one entry point, as the bound has two parts.
//   1. A zero fill of the whole cotangent with 16-byte stores, at the card's
//      store rate (0.50 ms at 128^3; cudaMemsetAsync took 0.49).
//   2. A pass over the occupied slots: one block per tile of
//      TX x TY x TZ = 2 x 2 x 32 cells, a thread a cell with z fastest, which
//      walks the cell's K slots, so that a warp reads and writes one z row of
//      one payload row (128 bytes) at a time and a cell's coordinates are
//      computed once.
//      a. The thread reads its cell's masks, loads that do not wait for each
//         other; a tile without a particle (most of a dam-break's domain)
//         returns.
//      b. Else the block brings the (gn, gd) pairs of the faces its cells
//         reach into shared memory, 11 KB for the three boxes, faces outside
//         an array as zeros (so the bounds are resolved there and not per
//         face).
//      c. For each occupied slot the thread loads the 15 other rows at once
//         and computes, per dimension, the hats, their derivatives and the
//         levers x_face - x at the two aligned and the three half-shifted
//         offsets once (15 hats, not 162), then walks its faces out of shared
//         memory with no branch: a face farther than one cell has a hat of 0
//         and adds 0. Of the three half-shifted offsets of a dimension one is
//         always dead (hat and derivative 0) unless the particle sits exactly
//         on a kink of the hat, so a slot walks 24 faces (2 x 2 x 2 an axis),
//         from windows of two offsets chosen by the tables' own values; a
//         slot with a dimension where both ends are live takes all 54. The
//         face order (axis, then x, y, z offsets ascending) and every face's
//         expressions are those of the one-thread-per-slot kernel this
//         replaces, which skipped dead faces by a test.
// The slots are not compacted: in the fluid a warp's 32 cells at one slot
// number are mostly all occupied or all empty.
// Measured and not kept: both parts as one launch (the pass also storing the
// zeros of the empty slots). Its stores run at the occupancy the pass's
// registers leave: 0.69-0.74 ms for the fill alone against 0.50, and the
// whole no faster than the two launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 2, TY = 2, TZ = 32, THREADS = TX * TY * TZ;  // a thread a cell
// the boxes of faces a tile's cells reach, per face axis: cells + 1 along
// the axis (offsets 0, 1), cells + 2 across it (offsets -1, 0, 1)
constexpr int UY = TY + 2, UZ = TZ + 2, U_N = (TX + 1) * UY * UZ;
constexpr int VY = TY + 1, VZ = TZ + 2, V_N = (TX + 2) * VY * VZ;
constexpr int WY = TY + 2, WZ = TZ + 1, W_N = (TX + 2) * WY * WZ;
constexpr int FILL_THREADS = 256, FILL_BLOCKS = 132 * 8;

__device__ __forceinline__ float hat(float t) { return fmaxf(1.0f - fabsf(t), 0.0f); }

// d hat / dt with the subgradients of jnp.maximum(1 - jnp.abs(t), 0)
__device__ __forceinline__ float dhat(float t) {
  const float y = 1.0f - fabsf(t);
  const float gate = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
  return t >= 0.0f ? -gate : gate;
}

__global__ void __launch_bounds__(FILL_THREADS)
fill_kernel(float4* __restrict__ out, long long count4) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = (long long)blockIdx.x * FILL_THREADS + threadIdx.x; i < count4;
       i += (long long)FILL_BLOCKS * FILL_THREADS)
    out[i] = zero;
}

// Per dimension q of a slot: hat, its derivative and the lever x_face - x at
// the aligned offsets 0, 1 (kind 0: the face axis) and at the half-shifted
// offsets -1, 0, 1 (kind 1: across it); entry [q][kind][i] is the face at box
// coordinate (cell in the tile) + i.
struct Tables {
  float h[3][2][3], dh[3][2][3], lever[3][2][3];
};

struct Sums {
  float m, t[3], x[3], v[3], a[9];
};

// The faces of axis A around one slot, out of the box of that axis: two
// aligned offsets along A and NS half-shifted ones across it, the tables'
// entries 0 ... NS - 1, the first at box coordinate (ix, iy, iz).
template <int A, int NS>
__device__ __forceinline__ void axis_faces(const Tables& tb, const float2* __restrict__ box, int by,
                                           int bz, int ix, int iy, int iz, float m, float va,
                                           const float (&arow)[3], bool use_affine, Sums& s) {
  constexpr int N0 = A == 0 ? 2 : NS, N1 = A == 1 ? 2 : NS, N2 = A == 2 ? 2 : NS;
  constexpr int K0 = A == 0 ? 0 : 1, K1 = A == 1 ? 0 : 1, K2 = A == 2 ? 0 : 1;
#pragma unroll
  for (int i0 = 0; i0 < N0; ++i0) {
#pragma unroll
    for (int i1 = 0; i1 < N1; ++i1) {
#pragma unroll
      for (int i2 = 0; i2 < N2; ++i2) {
        const float2 g = box[((ix + i0) * by + iy + i1) * bz + iz + i2];  // (gn, gd)
        const float h0 = tb.h[0][K0][i0], h1 = tb.h[1][K1][i1], h2 = tb.h[2][K2][i2];
        const float H = h0 * h1 * h2;
        const float lever[3] = {tb.lever[0][K0][i0], tb.lever[1][K1][i1], tb.lever[2][K2][i2]};
        float val = va;
        if (use_affine) {
#pragma unroll
          for (int q = 0; q < 3; ++q) val += arow[q] * lever[q];
        }
        const float gw = g.x * val + g.y;  // cotangent of m * H
        s.m += gw * H;
        const float gwm = gw * m;
        s.t[0] += gwm * tb.dh[0][K0][i0] * h1 * h2;
        s.t[1] += gwm * h0 * tb.dh[1][K1][i1] * h2;
        s.t[2] += gwm * h0 * h1 * tb.dh[2][K2][i2];
        const float gnw = g.x * m * H;  // cotangent of val
        s.v[A] += gnw;
        if (use_affine) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            s.a[3 * A + q] += gnw * lever[q];
            s.x[q] -= gnw * arow[q];
          }
        }
      }
    }
  }
}

struct Cotangents {
  const float *gnu, *gnv, *gnw, *gdu, *gdv, *gdw;
};

// all three axes of one slot; st: the first live half-shifted offset of each
// dimension (entries st ... st + NS - 1 of the tables have been moved to 0 ...);
// row: the slot's payload rows 4 ... 15 (velocity, affine rows)
template <int NS>
__device__ __forceinline__ void slot_faces(const Tables& tb, const float2* __restrict__ box,
                                           const int (&ic)[3], const int (&st)[3],
                                           const float (&row)[12], float m, bool use_affine,
                                           Sums& sum) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float arow[3] = {row[3 + 3 * a], row[4 + 3 * a], row[5 + 3 * a]};
    // the box coordinate of the first face: the cell along the axis, the
    // cell + the window's start across it
    const int jx = ic[0] + (a == 0 ? 0 : st[0]), jy = ic[1] + (a == 1 ? 0 : st[1]),
              jz = ic[2] + (a == 2 ? 0 : st[2]);
    if (a == 0) axis_faces<0, NS>(tb, box, UY, UZ, jx, jy, jz, m, row[0], arow, use_affine, sum);
    if (a == 1)
      axis_faces<1, NS>(tb, box + U_N, VY, VZ, jx, jy, jz, m, row[1], arow, use_affine, sum);
    if (a == 2)
      axis_faces<2, NS>(tb, box + U_N + V_N, WY, WZ, jx, jy, jz, m, row[2], arow, use_affine, sum);
  }
}

__global__ void __launch_bounds__(THREADS)
p2g_bwd_kernel(const float* __restrict__ data, Cotangents cot, float* __restrict__ out, int K,
               int nx, int ny, int nz, float h, float ox, float oy, float oz, int use_affine) {
  __shared__ float2 box[U_N + V_N + W_N];  // (gn, gd) of the u, v, w faces in reach
  const long long C = (long long)nx * ny * nz;
  const long long col = (long long)K * C;  // stride between payload rows
  const int t0x = blockIdx.z * TX, t0y = blockIdx.y * TY, t0z = blockIdx.x * TZ;
  // the thread's cell; z fastest, so a warp is one z row
  const int ic[3] = {(int)threadIdx.x / (TY * TZ), ((int)threadIdx.x / TZ) % TY,
                     (int)threadIdx.x % TZ};
  const int c[3] = {t0x + ic[0], t0y + ic[1], t0z + ic[2]};
  const bool inside = c[0] < nx && c[1] < ny && c[2] < nz;
  const long long cell = ((long long)c[0] * ny + c[1]) * nz + c[2];
  const float* mask = data + 3 * col + cell;

  // 1. the cell's masks (loads that do not wait for each other): is there
  // any particle in the tile?
  int any = 0;
  if (inside) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) any |= mask[k * C] != 0.0f;
  }
  if (!__syncthreads_or(any)) return;  // the fill has stored its zeros

  // 2. the face cotangents in reach; a face outside its array counts 0
  for (int t = threadIdx.x; t < U_N + V_N + W_N; t += THREADS) {
    const int a = t < U_N ? 0 : (t < U_N + V_N ? 1 : 2);
    const int e = t - (a == 0 ? 0 : (a == 1 ? U_N : U_N + V_N));
    const int by = a == 0 ? UY : (a == 1 ? VY : WY), bz = a == 0 ? UZ : (a == 1 ? VZ : WZ);
    // the box starts at the tile's first cell along the face axis and one
    // cell before it across
    const int f0 = t0x + e / (by * bz) - (a != 0), f1 = t0y + (e / bz) % by - (a != 1),
              f2 = t0z + e % bz - (a != 2);
    const int fx = nx + (a == 0), fy = ny + (a == 1), fz = nz + (a == 2);
    float2 g = make_float2(0.f, 0.f);
    if (f0 >= 0 && f0 < fx && f1 >= 0 && f1 < fy && f2 >= 0 && f2 < fz) {
      const long long f = ((long long)f0 * fy + f1) * fz + f2;
      const float* gn = a == 0 ? cot.gnu : (a == 1 ? cot.gnv : cot.gnw);
      const float* gd = a == 0 ? cot.gdu : (a == 1 ? cot.gdv : cot.gdw);
      g = make_float2(gn[f], gd[f]);
    }
    box[t] = g;
  }
  __syncthreads();
  if (!inside) return;

  // 3. the cell's occupied slots, one after the other
  const float o[3] = {ox, oy, oz};
  for (int k = 0; k < K; ++k) {
    const long long s = (long long)k * C + cell;
    const float m = data[3 * col + s];
    if (m == 0.0f) continue;
    // the slot's other rows, loads that do not wait for each other
    float p[3], row[12];
#pragma unroll
    for (int q = 0; q < 3; ++q) p[q] = data[q * col + s];
#pragma unroll
    for (int r = 0; r < 12; ++r) row[r] = (use_affine || r < 3) ? data[(4 + r) * col + s] : 0.0f;

    Tables tb;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float gp = (p[q] - o[q]) / h;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        // aligned offsets 0, 1 (a third entry is never read)
        const float fa = (float)(c[q] + i);
        const float ta = gp - fa;
        tb.h[q][0][i] = hat(ta);
        tb.dh[q][0][i] = dhat(ta);
        tb.lever[q][0][i] = (fa * h + o[q]) - p[q];
        // half-shifted offsets -1, 0, 1
        const float fs = (float)(c[q] + i - 1);
        const float ts = (gp - 0.5f) - fs;
        tb.h[q][1][i] = hat(ts);
        tb.dh[q][1][i] = dhat(ts);
        tb.lever[q][1][i] = ((fs + 0.5f) * h + o[q]) - p[q];
      }
    }

    // Across an axis one end of the three half-shifted offsets is dead
    // unless the particle sits on a kink: a window of two, from the tables.
    int st[3];
    bool wide = false;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const bool dead_lo = tb.h[q][1][0] == 0.0f && tb.dh[q][1][0] == 0.0f;
      const bool dead_hi = tb.h[q][1][2] == 0.0f && tb.dh[q][1][2] == 0.0f;
      st[q] = dead_lo ? 1 : 0;
      wide |= !dead_lo && !dead_hi;
    }
    Sums sum = {};
    if (wide) {
      const int none[3] = {0, 0, 0};
      slot_faces<3>(tb, box, ic, none, row, m, use_affine, sum);
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tb.h[q][1][i] = st[q] ? tb.h[q][1][i + 1] : tb.h[q][1][i];
          tb.dh[q][1][i] = st[q] ? tb.dh[q][1][i + 1] : tb.dh[q][1][i];
          tb.lever[q][1][i] = st[q] ? tb.lever[q][1][i + 1] : tb.lever[q][1][i];
        }
      }
      slot_faces<2>(tb, box, ic, st, row, m, use_affine, sum);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) out[q * col + s] = sum.t[q] / h + sum.x[q];
    out[3 * col + s] = sum.m;
#pragma unroll
    for (int q = 0; q < 3; ++q) out[(4 + q) * col + s] = sum.v[q];
#pragma unroll
    for (int r = 0; r < 9; ++r) out[(7 + r) * col + s] = sum.a[r];
  }
}

}  // namespace

// data: (16, K, nx, ny, nz) f32 slot payload; gn*/gd*: cotangents of the
// num/den face arrays u (nx+1, ny, nz), v (nx, ny+1, nz), w (nx, ny, nz+1);
// out: (16, K, nx, ny, nz) cotangent of the payload, 16-byte aligned.
extern "C" int lf_p2g_bwd(const float* data, const float* gnu, const float* gnv,
                          const float* gnw, const float* gdu, const float* gdv,
                          const float* gdw, float* out, int K, int nx, int ny, int nz, float h,
                          float ox, float oy, float oz, int use_affine, void* stream) {
  const long long total = (long long)K * nx * ny * nz;
  if (total == 0) return 0;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  const Cotangents cot{gnu, gnv, gnw, gdu, gdv, gdw};
  fill_kernel<<<FILL_BLOCKS, FILL_THREADS, 0, st>>>(reinterpret_cast<float4*>(out), total * 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p2g_bwd_kernel<<<grid, THREADS, 0, st>>>(data, cot, out, K, nx, ny, nz, h, ox, oy, oz, use_affine);
  return (int)cudaGetLastError();
}
