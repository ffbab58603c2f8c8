// P2G's overflow merge and normalisation, the two launches after kernel B.
//
// Replaces the overflow scatter and _normalize of
// libfluid_tpu/sim/transfers.py:p2g_slots (jnp there, no Pallas kernel).
// Kernel B (p2g.cu) sums the slots of the slot grid; the particles past a
// cell's slot capacity ("overflow" rows) are merged afterwards, up to
// p2g_overflow_capacity of them, and every face is normalised by its weight.
//
// p2g_overflow: the scatter. One thread per (window row, axis, corner): cap
// x 3 x 8 threads, the 24 of a row next to each other so that a warp reads
// one or two rows. A row of the window is n_kept + r (slotsort parks the
// overflow rows at [n_kept, n_kept + n_overflow); n_kept is read here from
// device memory, so the host never waits for it) or, where the caller found
// the overflow rows itself, rows[r]. A row past n, not flagged overflow or
// not active adds nothing, nor does a corner outside the face array. The
// thread computes its corner's hat weight and APIC value
// v_a + A_a . (x_face - x_p) in cell units as the plain scatter does
// (x_face - x_p is formed before it multiplies the affine row, as in
// kernel B) and adds both to kernel B's own sums with atomicAdd: the order
// of the additions, and so the last bits, vary from run to run, as with the
// plain version's index_add_ on the card.
//
// p2g_normalize: one thread per face of the three arrays, num / den where
// den > 1e-6, else 0 (_normalize's rule, with the same division).
//
// Bound: launch latency. At the 128^3 main path the window is 4,096 rows
// (~0.2 MB read) and the normalisation moves the six sums and the three
// velocities once (~75 MB, ~22 us at 3.35 TB/s); the eager version spent
// ~730 launches and 63 blocking copies of small host tensors on the same
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kWeightEps = 1e-6f;  // transfers._WEIGHT_EPS
constexpr int kThreads = 256;

// Per-axis values are picked with selects, not indexed: an array indexed by
// a value the compiler cannot unroll away would live in local memory.
template <typename T>
__device__ __forceinline__ T pick(int a, T x, T y, T z) {
  return a == 0 ? x : (a == 1 ? y : z);
}

__global__ void p2g_overflow_kernel(const int* __restrict__ start, const int* __restrict__ rows,
                                    const uint8_t* __restrict__ overflow,
                                    const uint8_t* __restrict__ active,
                                    const float* __restrict__ position,
                                    const float* __restrict__ velocity,
                                    const float* __restrict__ affine, float* num_u, float* num_v,
                                    float* num_w, float* den_u, float* den_v, float* den_w,
                                    int cap, long long n, int nx, int ny, int nz, float h,
                                    float ox, float oy, float oz, int use_affine) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 24LL * cap) return;
  const int corner = (int)(t & 7), axis = (int)((t >> 3) % 3);
  const long long r = t / 24;
  const long long row = rows ? (long long)rows[r] : (long long)start[0] + r;
  if (row < 0 || row >= n || !overflow[row] || !active[row]) return;

  int idx[3], dims[3];
  float w = 1.0f, dot = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float o = pick(k, ox, oy, oz), x = position[3 * row + k];
    const float shift = k == axis ? 0.0f : 0.5f;
    const float c = (x - o) / h - shift;  // face index coordinate
    const float base = floorf(c);
    const float frac = c - base;
    const int off = (corner >> (2 - k)) & 1;
    idx[k] = (int)base + off;
    dims[k] = pick(k, nx, ny, nz) + (k == axis);
    if (idx[k] < 0 || idx[k] >= dims[k]) return;
    w *= off ? frac : 1.0f - frac;
    if (use_affine) {  // A_a . (x_face - x_p), the face's world coordinate less the particle's
      const float d = ((o + shift * h) + (float)idx[k] * h) - x;
      dot += affine[9 * row + 3 * axis + k] * d;
    }
  }
  const float val = velocity[3 * row + axis] + dot;
  const long long at = ((long long)idx[0] * dims[1] + idx[1]) * dims[2] + idx[2];
  atomicAdd(pick(axis, num_u, num_v, num_w) + at, w * val);
  atomicAdd(pick(axis, den_u, den_v, den_w) + at, w);
}

__global__ void p2g_normalize_kernel(const float* __restrict__ num_u,
                                     const float* __restrict__ num_v,
                                     const float* __restrict__ num_w,
                                     const float* __restrict__ den_u,
                                     const float* __restrict__ den_v,
                                     const float* __restrict__ den_w, float* __restrict__ u,
                                     float* __restrict__ v, float* __restrict__ w, long long su,
                                     long long sv, long long sw) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int a = 0;
  if (i >= su) {
    i -= su;
    a = 1;
    if (i >= sv) {
      i -= sv;
      a = 2;
      if (i >= sw) return;
    }
  }
  const float den = pick(a, den_u, den_v, den_w)[i];
  const float num = pick(a, num_u, num_v, num_w)[i];
  pick(a, u, v, w)[i] = den > kWeightEps ? num / fmaxf(den, kWeightEps) : 0.0f;
}

}  // namespace

// start: the window's first row (int32 scalar), or rows: its cap rows
// (int32, n where none), the other null; overflow, active: (n,) bool;
// position, velocity: (n, 3) f32; affine: (n, 3, 3) f32, null unless
// use_affine; the six face sums of kernel B, added to in place.
extern "C" int lf_p2g_overflow(const int* start, const int* rows, const uint8_t* overflow,
                               const uint8_t* active, const float* position,
                               const float* velocity, const float* affine, float* num_u,
                               float* num_v, float* num_w, float* den_u, float* den_v,
                               float* den_w, int cap, long long n, int nx, int ny, int nz,
                               float h, float ox, float oy, float oz, int use_affine,
                               void* stream) {
  if ((start == nullptr) == (rows == nullptr)) return (int)cudaErrorInvalidValue;
  if (cap <= 0 || n <= 0) return 0;
  const long long blocks = (24LL * cap + kThreads - 1) / kThreads;
  p2g_overflow_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      start, rows, overflow, active, position, velocity, affine, num_u, num_v, num_w, den_u,
      den_v, den_w, cap, n, nx, ny, nz, h, ox, oy, oz, use_affine);
  return (int)cudaGetLastError();
}

// the six face sums (read) and u, v, w (written), of su, sv, sw faces
extern "C" int lf_p2g_normalize(const float* num_u, const float* num_v, const float* num_w,
                                const float* den_u, const float* den_v, const float* den_w,
                                float* u, float* v, float* w, long long su, long long sv,
                                long long sw, void* stream) {
  const long long total = su + sv + sw;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  p2g_normalize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      num_u, num_v, num_w, den_u, den_v, den_w, u, v, w, su, sv, sw);
  return (int)cudaGetLastError();
}
