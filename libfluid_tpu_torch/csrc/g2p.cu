// Kernel D: G2P (PIC/APIC grid-to-particle).
//
// Replaces libfluid_tpu/sim/transfers.py:_transpose_major and
// _transpose_rows, the two Pallas kernels of the TPU's G2P. They only pin
// memory layouts around a (C, 64) per-cell sample table and its row gather,
// which the TPU needs to gather fast; this kernel computes what the whole
// of g2p_pic computes, with no table. Per particle: clamp its cell, read the
// face samples around it straight from u, v, w (zero outside the face
// array's transverse extent), and sum the trilinear velocity and the three
// APIC gradient rows. The derivative factor uses the half-open support
// d in [-1, 1) with sign -1 for d > 0.
//
// Bound: instruction throughput, then the latency of the scattered face loads;
// the bytes (the faces once, 60 bytes a particle) are a twentieth of the
// time. What the design does about it:
//  - The weights are separable. Per axis a particle has two tables of hat
//    and derivative factors, one for the face array staggered along that
//    axis (offsets 0, 1 from its cell) and one for the other two arrays
//    (offsets -1, 0, 1 at a half-cell shift), computed once; the bounds of
//    a face array are resolved there (weight 0, index clamped). A sample
//    then costs its load and two multiply-adds, the rest is shared along
//    the loops, and 1/h multiplies the three gradient sums once at the end.
//  - Of the three half-shifted offsets one always has weight 0: -1 when the
//    particle sits in the upper half of its cell, +1 in the lower half. The
//    window of two live offsets is picked per axis, so a face array gives 8
//    samples, not 18 (24 loads a particle, not 54). One case needs all
//    three: the distance to offset +1 rounds to exactly -1, where the hat is
//    0 but the half-open derivative factor is not. Such a particle takes
//    the same code with windows of three (W = 3).
//  - A block's positions, velocities and affine rows are contiguous ranges
//    of their arrays: they pass through shared memory with coalesced loads
//    and stores (16 bytes a thread where the pointers allow), each thread
//    reading and writing its own 3 and 9 words there (odd strides, no bank
//    conflicts).
//  - All loops are unrolled and indices are 32 bits, so the 24 loads of a
//    thread are in flight together on the read-only path. Particles arrive
//    in rank-major slot order (consecutive threads in consecutive occupied
//    cells along z), so a warp's load falls into one or two lines; the
//    kernel is right for any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float hat(float d) { return fmaxf(1.0f - fabsf(d), 0.0f); }

__device__ __forceinline__ float dhat(float d) {
  return (d >= -1.0f && d < 1.0f) ? (d > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

// One axis of one particle: its clamped cell, the grid coordinate at the
// half-cell shift, and whether the window of two live offsets starts at -1.
struct Axis {
  float g, gh;
  int cell;
  bool low;     // offsets {-1, 0} are live, else {0, +1}
  bool triple;  // offset +1 rounds onto the closed end of the half-open support
};

__device__ __forceinline__ Axis axis_of(float x, float origin, float h, int dim) {
  Axis ax;
  ax.g = (x - origin) / h;
  const int c = (int)floorf(ax.g);
  ax.cell = c < 0 ? 0 : (c > dim - 1 ? dim - 1 : c);
  ax.gh = ax.g - 0.5f;
  ax.low = ax.gh - (float)ax.cell < 0.0f;
  ax.triple = ax.low && ax.cell + 1 < dim && ax.gh - (float)(ax.cell + 1) == -1.0f;
  return ax;
}

// The tables of one axis: entries [0, 2) for the face array staggered along
// it (offsets 0, 1), entries [2, 2 + W) for the other two (the window of W
// half-shifted offsets). idx holds each entry's index along the axis.
template <int W>
struct Tab {
  float n[2 + W], s[2 + W];
  int idx[2 + W];
};

template <int W>
__device__ __forceinline__ Tab<W> tab_of(const Axis& ax, int dim) {
  Tab<W> t;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float d = ax.g - (float)(ax.cell + o);
    t.n[o] = hat(d);
    t.s[o] = dhat(d);
    t.idx[o] = ax.cell + o;
  }
  const int first = ax.cell + ((W == 3 || ax.low) ? -1 : 0);
#pragma unroll
  for (int o = 0; o < W; ++o) {
    const int i = first + o;
    const bool inside = i >= 0 && i < dim;
    const float d = ax.gh - (float)i;
    t.n[2 + o] = inside ? hat(d) : 0.0f;
    t.s[2 + o] = inside ? dhat(d) : 0.0f;
    t.idx[2 + o] = i < 0 ? 0 : (i > dim - 1 ? dim - 1 : i);
  }
  return t;
}

// The velocity component and gradient row of face array A (of transverse
// strides fy * fz, fz, 1) from the three axes' tables.
template <int A, int W>
__device__ __forceinline__ void gather(const float* __restrict__ arr, int fy, int fz,
                                       const Tab<W>& tx, const Tab<W>& ty, const Tab<W>& tz,
                                       float* out4) {
  constexpr int X0 = A == 0 ? 0 : 2, XN = A == 0 ? 2 : W;
  constexpr int Y0 = A == 1 ? 0 : 2, YN = A == 1 ? 2 : W;
  constexpr int Z0 = A == 2 ? 0 : 2, ZN = A == 2 ? 2 : W;
  float val = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
  for (int i = X0; i < X0 + XN; ++i) {
    float c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll
    for (int j = Y0; j < Y0 + YN; ++j) {
      const float* row = arr + (tx.idx[i] * fy + ty.idx[j]) * fz;
      float sn = 0.0f, ss = 0.0f;
#pragma unroll
      for (int k = Z0; k < Z0 + ZN; ++k) {
        const float sample = __ldg(row + tz.idx[k]);
        sn += tz.n[k] * sample;
        ss += tz.s[k] * sample;
      }
      c1 += ty.n[j] * sn;
      c2 += ty.s[j] * sn;
      c3 += ty.n[j] * ss;
    }
    val += tx.n[i] * c1;
    g0 += tx.s[i] * c1;
    g1 += tx.n[i] * c2;
    g2 += tx.n[i] * c3;
  }
  out4[0] = val;
  out4[1] = g0;
  out4[2] = g1;
  out4[3] = g2;
}

template <int W>
__device__ __forceinline__ void particle(const float* __restrict__ u, const float* __restrict__ v,
                                         const float* __restrict__ w, const Axis& ax,
                                         const Axis& ay, const Axis& az, int nx, int ny, int nz,
                                         float rh, float* vel3, float* aff9) {
  const Tab<W> tx = tab_of<W>(ax, nx), ty = tab_of<W>(ay, ny), tz = tab_of<W>(az, nz);
  float r[4];
  gather<0, W>(u, ny, nz, tx, ty, tz, r);
  vel3[0] = r[0], aff9[0] = r[1] * rh, aff9[1] = r[2] * rh, aff9[2] = r[3] * rh;
  gather<1, W>(v, ny + 1, nz, tx, ty, tz, r);
  vel3[1] = r[0], aff9[3] = r[1] * rh, aff9[4] = r[2] * rh, aff9[5] = r[3] * rh;
  gather<2, W>(w, ny, nz + 1, tx, ty, tz, r);
  vel3[2] = r[0], aff9[6] = r[1] * rh, aff9[7] = r[2] * rh, aff9[8] = r[3] * rh;
}

__global__ void __launch_bounds__(THREADS)
g2p_kernel(const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ pos, float* __restrict__ vel, float* __restrict__ aff,
           long long n, int nx, int ny, int nz, float h, float ox, float oy, float oz, int vec) {
  __shared__ __align__(16) float sm_vel[3 * THREADS];  // positions in, velocities out
  __shared__ __align__(16) float sm_aff[9 * THREADS];
  const long long start = (long long)blockIdx.x * THREADS;
  const int count = (int)(n - start < THREADS ? n - start : THREADS);
  const int t = threadIdx.x;
  stage_in<THREADS>(sm_vel, pos + 3 * start, 3 * count, vec & 1);
  __syncthreads();
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (t < count) x = sm_vel[3 * t], y = sm_vel[3 * t + 1], z = sm_vel[3 * t + 2];
  __syncthreads();
  if (t < count) {
    const Axis ax = axis_of(x, ox, h, nx), ay = axis_of(y, oy, h, ny), az = axis_of(z, oz, h, nz);
    const float rh = 1.0f / h;
    if (ax.triple || ay.triple || az.triple)
      particle<3>(u, v, w, ax, ay, az, nx, ny, nz, rh, sm_vel + 3 * t, sm_aff + 9 * t);
    else
      particle<2>(u, v, w, ax, ay, az, nx, ny, nz, rh, sm_vel + 3 * t, sm_aff + 9 * t);
  }
  __syncthreads();
  stage_out<THREADS>(vel + 3 * start, sm_vel, 3 * count, vec & 2);
  stage_out<THREADS>(aff + 9 * start, sm_aff, 9 * count, vec & 4);
}

}  // namespace

// u: (nx+1, ny, nz), v: (nx, ny+1, nz), w: (nx, ny, nz+1), pos: (n, 3) f32;
// vel: (n, 3), aff: (n, 3, 3) f32 outputs. Every face array has fewer than
// 2^31 elements (the caller checks).
extern "C" int lf_g2p(const float* u, const float* v, const float* w, const float* pos,
                      float* vel, float* aff, long long n, int nx, int ny, int nz, float h,
                      float ox, float oy, float oz, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  const int vec = aligned16(pos) | aligned16(vel) << 1 | aligned16(aff) << 2;
  g2p_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      u, v, w, pos, vel, aff, n, nx, ny, nz, h, ox, oy, oz, vec);
  return (int)cudaGetLastError();
}
