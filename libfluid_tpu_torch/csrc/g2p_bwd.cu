// Kernel D': the adjoint of kernel D (PIC/APIC grid-to-particle).
//
// Replaces the backward of G2P, which the JAX package takes by autodiff of
// g2p_from_table (libfluid_tpu/sim/transfers.py:597-641) around its Pallas
// layout kernels _transpose_major and _transpose_rows. Forward, for each
// axis a and each face f around the particle's cell,
//   vel_a   += n0 n1 n2 S_f
//   aff_a,r += (prod_{q != r} n_q) s_r / h * S_f,
// with d_q = coord_q - f_q, n_q = hat(d_q) and s_q the derivative factor on
// the half-open support [-1, 1) (a constant: its own derivative is 0).
// Backward, with cotangents gv (N, 3) and ga (N, 3, 3):
//   S_f bar  = gv_a n0 n1 n2 + sum_r ga_a,r (prod_{q != r} n_q) s_r / h,
//              scattered into u, v, w with atomicAdd;
//   x_q bar += S_f (gv_a n'_q prod_{q' != q} n_q'
//              + sum_{r != q} ga_a,r n'_q s_r prod_{q' != q, r} n_q' / h) / h,
// the second term being the affine rows' dependence on the hats of the
// other two axes. n' takes the JAX package's subgradients (slope -1 at
// d = 0, half the slope at |d| = 1).
//
// Bound: the atomics. The card's L2 adds about one float32 a clock a slice
// (some 1e11 a second), whatever the addresses, so the 24 live samples of
// 2M particles cost 0.5 ms as global atomics, three times the rest of the
// kernel; the bytes (the faces read, their cotangents written, 72 bytes a
// particle) are a fourteenth of the time. The design is kernel D's read
// backwards (csrc/g2p.cu), with the atomics merged in shared memory:
//  - per-axis tables of n, s and n', computed once a particle, with the
//    bounds of a face array resolved there; with P = gv n0 + ga_0 s0 / h,
//    Q = ga_1 n0 / h, R = ga_2 n0 / h per x entry and T = n1 P + s1 Q,
//    U = n1 R per (x, y) pair, a face's cotangent is n2 T + s2 U, and the
//    position cotangent needs the three sums of n2 S, s2 S and n2' S along z;
//  - the window of two live half-shifted offsets per axis (8 faces an array,
//    24 atomics a particle at most, not 54); windows of three where a
//    distance rounds onto an end of the support with a nonzero factor
//    (d = -1 for s, |d| = 1 for n');
//  - a block takes 256 consecutive particles, two a thread. In the
//    substep's rank-major slot order these are consecutive occupied cells:
//    a few rows along z of one x plane. The block finds the (y, z)
//    range of the cells that share the first particle's x plane; if the
//    faces around that range (three x layers of each array) fit the block's
//    box in shared memory, those particles add into the box (shared
//    atomics), and at the end each nonzero entry goes to device memory with
//    one atomic, a warp along z: a face that a dozen of the block's
//    particles reach costs one global atomic, not a dozen. Particles of
//    another plane, and every particle of a block whose range does not fit
//    (particles in no order), add straight into device memory: any order is
//    right, the slot order is fast. Block and box sizes are the fastest of
//    those timed on the 128^3 dam-break (rows of ~62 occupied cells): both a
//    larger and a smaller box were slower there, and with rows twice as long
//    a block's faces no longer fit and its particles take the straight path;
//  - positions in and their cotangents out through shared memory,
//    coalesced; a thread reads its 12 cotangent words itself (staging them
//    a round at a time put two barriers between a thread's particles and
//    cost more than the loads).
//
// The face cotangents are sums of atomicAdds in an order that changes from
// run to run, so their last bits do too (about one float32 rounding per
// contribution, up to ~50 contributions a face).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROUNDS = 2;                 // particles a thread
constexpr int BLOCK = THREADS * ROUNDS;   // particles a block
constexpr int BOX = 4096;                 // floats of a block's box of face cotangents
constexpr int MIN_BLOCKS = 5;             // blocks an SM the registers are held to
// dynamic shared memory: the box, and the block's positions (their
// cotangents on the way out)
constexpr int SMEM_FLOATS = BOX + 3 * BLOCK;

__device__ __forceinline__ float hat(float d) { return fmaxf(1.0f - fabsf(d), 0.0f); }

// the forward's derivative factor (a constant of the backward)
__device__ __forceinline__ float sfac(float d) {
  return (d >= -1.0f && d < 1.0f) ? (d > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

// d hat / dd with the subgradients of jnp.maximum(1 - jnp.abs(d), 0)
__device__ __forceinline__ float dhat(float d) {
  const float y = 1.0f - fabsf(d);
  const float gate = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
  return d >= 0.0f ? -gate : gate;
}

// One axis of one particle, as in kernel D; `triple` also where the distance
// to offset -1 is exactly 1 (n' = -1/2 there).
struct Axis {
  float g, gh;
  int cell;
  bool low, triple;
};

// g: the grid coordinate (x - origin) / h
__device__ __forceinline__ Axis axis_of(float g, int dim) {
  Axis ax;
  ax.g = g;
  const int c = (int)floorf(ax.g);
  ax.cell = c < 0 ? 0 : (c > dim - 1 ? dim - 1 : c);
  ax.gh = ax.g - 0.5f;
  ax.low = ax.gh - (float)ax.cell < 0.0f;
  ax.triple = ax.low ? (ax.cell + 1 < dim && ax.gh - (float)(ax.cell + 1) == -1.0f)
                     : (ax.cell > 0 && ax.gh - (float)(ax.cell - 1) == 1.0f);
  return ax;
}

// entries [0, 2): the face array staggered along this axis (offsets 0, 1);
// entries [2, 2 + W): the window of half-shifted offsets
template <int W>
struct Tab {
  float n[2 + W], s[2 + W], e[2 + W];
  int idx[2 + W];
};

template <int W>
__device__ __forceinline__ Tab<W> tab_of(const Axis& ax, int dim) {
  Tab<W> t;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float d = ax.g - (float)(ax.cell + o);
    t.n[o] = hat(d);
    t.s[o] = sfac(d);
    t.e[o] = dhat(d);
    t.idx[o] = ax.cell + o;
  }
  const int first = ax.cell + ((W == 3 || ax.low) ? -1 : 0);
#pragma unroll
  for (int o = 0; o < W; ++o) {
    const int i = first + o;
    const bool inside = i >= 0 && i < dim;
    const float d = ax.gh - (float)i;
    t.n[2 + o] = inside ? hat(d) : 0.0f;
    t.s[2 + o] = inside ? sfac(d) : 0.0f;
    t.e[2 + o] = inside ? dhat(d) : 0.0f;
    t.idx[2 + o] = i < 0 ? 0 : (i > dim - 1 ? dim - 1 : i);
  }
  return t;
}

// Where a particle's face cotangents go: device memory (the face array's own
// transverse strides) or the block's box (its strides, its origin folded
// into `base`).
struct Target {
  float* base;
  int sy, sz;
};

template <bool BOXED>
__device__ __forceinline__ void add_to(float* p, float v) {
  if (BOXED) {
    asm volatile("red.shared.add.f32 [%0], %1;" ::"r"((unsigned)__cvta_generic_to_shared(p)), "f"(v)
                 : "memory");
  } else {
    atomicAdd(p, v);
  }
}

// Face array A: scatter the cotangents of its faces, and add its share of
// the cotangents gd[3] of the particle's grid coordinates. cv is the
// velocity cotangent of component A, ca0..2 its affine row's over h (caff
// comes divided by h).
template <int A, int W, bool BOXED>
__device__ __forceinline__ void scatter(const float* __restrict__ arr, int fy, int fz,
                                        const Target& to, const Tab<W>& tx, const Tab<W>& ty,
                                        const Tab<W>& tz, float cv, float ca0, float ca1,
                                        float ca2, float* gd) {
  constexpr int X0 = A == 0 ? 0 : 2, XN = A == 0 ? 2 : W;
  constexpr int Y0 = A == 1 ? 0 : 2, YN = A == 1 ? 2 : W;
  constexpr int Z0 = A == 2 ? 0 : 2, ZN = A == 2 ? 2 : W;
#pragma unroll
  for (int i = X0; i < X0 + XN; ++i) {
    const float P = cv * tx.n[i] + ca0 * tx.s[i], Q = ca1 * tx.n[i], R = ca2 * tx.n[i];
#pragma unroll
    for (int j = Y0; j < Y0 + YN; ++j) {
      const float T = ty.n[j] * P + ty.s[j] * Q, U = ty.n[j] * R;
      const float* row = arr + (tx.idx[i] * fy + ty.idx[j]) * fz;
      float* out = to.base + (tx.idx[i] * to.sy + ty.idx[j]) * to.sz;
      float sn = 0.0f, ss = 0.0f, se = 0.0f;
#pragma unroll
      for (int k = Z0; k < Z0 + ZN; ++k) {
        const float S = __ldg(row + tz.idx[k]);
        sn += tz.n[k] * S;
        ss += tz.s[k] * S;
        se += tz.e[k] * S;
        const float gs = tz.n[k] * T + tz.s[k] * U;
        if (gs != 0.0f) add_to<BOXED>(out + tz.idx[k], gs);
      }
      gd[0] += tx.e[i] * (ty.n[j] * (cv * sn + ca2 * ss) + ty.s[j] * (ca1 * sn));
      gd[1] += ty.e[j] * (P * sn + R * ss);
      gd[2] += se * T;
    }
  }
}

struct Faces {
  const float *u, *v, *w;
  int nx, ny, nz;
};

template <int W, bool BOXED>
__device__ __forceinline__ void particle(const Faces& f, const Target* to, const Axis& ax,
                                         const Axis& ay, const Axis& az, float rh,
                                         const float* cvel, const float* caff, float* gpos3) {
  const Tab<W> tx = tab_of<W>(ax, f.nx), ty = tab_of<W>(ay, f.ny), tz = tab_of<W>(az, f.nz);
  float gd[3] = {0.0f, 0.0f, 0.0f};
  scatter<0, W, BOXED>(f.u, f.ny, f.nz, to[0], tx, ty, tz, cvel[0], caff[0], caff[1], caff[2], gd);
  scatter<1, W, BOXED>(f.v, f.ny + 1, f.nz, to[1], tx, ty, tz, cvel[1], caff[3], caff[4], caff[5],
                       gd);
  scatter<2, W, BOXED>(f.w, f.ny, f.nz + 1, to[2], tx, ty, tz, cvel[2], caff[6], caff[7], caff[8],
                       gd);
  gpos3[0] = gd[0] * rh, gpos3[1] = gd[1] * rh, gpos3[2] = gd[2] * rh;
}

__device__ __forceinline__ int cell_of(float g, int dim) {
  const int c = (int)floorf(g);
  return c < 0 ? 0 : (c > dim - 1 ? dim - 1 : c);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
g2p_bwd_kernel(const float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ pos,
               const float* __restrict__ gvel, const float* __restrict__ gaff,
               float* __restrict__ gu, float* __restrict__ gv, float* __restrict__ gw,
               float* __restrict__ gpos, long long n, int nx, int ny, int nz, float h, float ox,
               float oy, float oz, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* box = smem;
  float* sm_pos = box + BOX;  // positions in, then grid coordinates, their cotangents out
  __shared__ int lim[4];  // the y and z range of the cells of the box's x plane
  const long long start = (long long)blockIdx.x * BLOCK;
  const int count = (int)(n - start < BLOCK ? n - start : BLOCK);
  const int t = threadIdx.x;
  stage_in<THREADS>(sm_pos, pos + 3 * start, 3 * count, vec & 1);
  if (t == 0) lim[0] = INT_MAX, lim[1] = -1, lim[2] = INT_MAX, lim[3] = -1;
  __syncthreads();

  // positions to grid coordinates, in place
  for (int p = t; p < count; p += THREADS) {
    sm_pos[3 * p] = (sm_pos[3 * p] - ox) / h;
    sm_pos[3 * p + 1] = (sm_pos[3 * p + 1] - oy) / h;
    sm_pos[3 * p + 2] = (sm_pos[3 * p + 2] - oz) / h;
  }
  __syncthreads();

  // 1. the box: the faces around the cells that share the first particle's
  // x plane, if they fit
  const int x0 = cell_of(sm_pos[0], nx);
  int ylo = INT_MAX, yhi = -1, zlo = INT_MAX, zhi = -1;
  for (int p = t; p < count; p += THREADS) {
    if (cell_of(sm_pos[3 * p], nx) != x0) continue;
    const int cy = cell_of(sm_pos[3 * p + 1], ny), cz = cell_of(sm_pos[3 * p + 2], nz);
    ylo = min(ylo, cy), yhi = max(yhi, cy), zlo = min(zlo, cz), zhi = max(zhi, cz);
  }
  ylo = __reduce_min_sync(0xffffffffu, ylo), yhi = __reduce_max_sync(0xffffffffu, yhi);
  zlo = __reduce_min_sync(0xffffffffu, zlo), zhi = __reduce_max_sync(0xffffffffu, zhi);
  if ((t & 31) == 0) {
    atomicMin(&lim[0], ylo), atomicMax(&lim[1], yhi), atomicMin(&lim[2], zlo), atomicMax(&lim[3], zhi);
  }
  __syncthreads();
  // faces x0 - 1 .. x0 + 1, lim[0] - 1 .. lim[1] + 1, lim[2] - 1 .. lim[3] + 1 of each array
  const int by0 = lim[0] - 1, bz0 = lim[2] - 1;
  const int ey = lim[1] - by0 + 2, ez = lim[3] - bz0 + 2;
  const int plane = ey * ez;
  const bool boxed = 9 * plane <= BOX;
  if (boxed) {
    for (int i = t; i < 9 * plane; i += THREADS) box[i] = 0.0f;
  }
  __syncthreads();

  const Faces faces = {u, v, w, nx, ny, nz};
  const Target direct[3] = {{gu, ny, nz}, {gv, ny + 1, nz}, {gw, ny, nz + 1}};
  Target inbox[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    inbox[a].base = box + a * 3 * plane - (((x0 - 1) * ey + by0) * ez + bz0);
    inbox[a].sy = ey, inbox[a].sz = ez;
  }
  const float rh = 1.0f / h;

  // 2. the particles, each thread its own; a thread reads its 12 cotangent
  // words straight from device memory, so no barrier stands between two
  // particles of a thread
  for (int p = t; p < count; p += THREADS) {
    float* mine = sm_pos + 3 * p;
    const Axis ax = axis_of(mine[0], nx), ay = axis_of(mine[1], ny), az = axis_of(mine[2], nz);
    const bool three = ax.triple || ay.triple || az.triple;
    float cvel[3], caff[9];
#pragma unroll
    for (int q = 0; q < 3; ++q) cvel[q] = __ldg(gvel + 3 * (start + p) + q);
#pragma unroll
    for (int q = 0; q < 9; ++q) caff[q] = __ldg(gaff + 9 * (start + p) + q) * rh;
    if (boxed && ax.cell == x0) {
      if (three) particle<3, true>(faces, inbox, ax, ay, az, rh, cvel, caff, mine);
      else particle<2, true>(faces, inbox, ax, ay, az, rh, cvel, caff, mine);
    } else {
      if (three) particle<3, false>(faces, direct, ax, ay, az, rh, cvel, caff, mine);
      else particle<2, false>(faces, direct, ax, ay, az, rh, cvel, caff, mine);
    }
  }
  __syncthreads();
  stage_out<THREADS>(gpos + 3 * start, sm_pos, 3 * count, vec & 2);

  // 3. the box's nonzero entries into device memory, a warp along z
  if (!boxed) return;
  for (int a = 0; a < 3; ++a) {
    float* garr = direct[a].base;
    const int fy = direct[a].sy, fz = direct[a].sz;
    for (int row = t >> 5; row < 3 * ey; row += THREADS / 32) {
      const int ix = x0 - 1 + row / ey, iy = by0 + row % ey;
      const float* from = box + (a * 3 * ey + row) * ez;
      for (int k = t & 31; k < ez; k += 32) {
        const float sum = from[k];
        if (sum != 0.0f) atomicAdd(garr + (ix * fy + iy) * fz + bz0 + k, sum);
      }
    }
  }
}

}  // namespace

// u: (nx+1, ny, nz), v: (nx, ny+1, nz), w: (nx, ny, nz+1), pos: (n, 3),
// gvel: (n, 3), gaff: (n, 3, 3) f32; gu, gv, gw: face cotangents, zeroed by
// the caller and accumulated here; gpos: (n, 3) position cotangent. Every
// face array has fewer than 2^31 elements (the caller checks).
extern "C" int lf_g2p_bwd(const float* u, const float* v, const float* w, const float* pos,
                          const float* gvel, const float* gaff, float* gu, float* gv,
                          float* gw, float* gpos, long long n, int nx, int ny, int nz,
                          float h, float ox, float oy, float oz, void* stream) {
  if (n == 0) return 0;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(g2p_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  const int vec = aligned16(pos) | aligned16(gpos) << 1;
  g2p_bwd_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      u, v, w, pos, gvel, gaff, gu, gv, gw, gpos, n, nx, ny, nz, h, ox, oy, oz, vec);
  return (int)cudaGetLastError();
}
