// Kernel C, fused: the multigrid V-cycle of the pressure preconditioner in a
// handful of launches, in float32 ("mg") and in bfloat16 ("mg16").
//
// Replaces libfluid_tpu/sim/multigrid.py:_stencil_kernel (launched through
// _stencil_pass) together with the jnp code the TPU package runs between its
// passes: _smooth, residual, _restrict, _prolong and v_cycle. The TPU kernel
// is one stencil pass per launch (float32 only: the JAX package's bfloat16
// cycle of pressure._cg's "mg16" branch runs all of it in XLA); on this card
// a pass at 128^3 moves 76 MB in ~25 us, and a cycle cut into 32 passes and
// ~250 small tensor ops is bound by their launches, not by memory. The cycle
// is cut here by what has to leave the chip instead:
//
//   lf_mg_pre       fine level, down leg: the two pre-sweeps from x = 0,
//                   masked. The first sweep is pointwise (damp * inv_diag *
//                   b), so the second reads it off b and inv_diag of the six
//                   neighbours and no intermediate is stored.
//   lf_mg_restrict  fine level, down leg: the residual (b - A x) * fluid of
//                   a tile of fine cells into shared memory, then R = P^T/8
//                   in gather form, one thread per coarse cell over its
//                   4x4x4 support with the separable weights (1/4, 3/4, 3/4,
//                   1/4) and the edge fold, masked by the coarse fluid. The
//                   residual never reaches device memory. No atomics.
//   lf_mg_up        fine level, up leg: x + P(ec) * fluid (trilinear,
//                   edge-clamped) on a tile with a two-cell halo in shared
//                   memory, then both post-sweeps (temporal blocking: the
//                   first on tile + 1, the second on the tile), masked.
//   lf_mg_coarse    every level from the first small one down: the whole
//                   sub-cycle, the coarsest level's sweeps included, in one
//                   block with __syncthreads() between the passes; the
//                   arrays are small enough to stay in L1/L2.
//
// lf_mg16_pre, lf_mg16_restrict, lf_mg16_up and lf_mg16_coarse are the same
// four kernels with bfloat16 storage: every array, the shared-memory tiles
// and the coarse kernel's scratch hold bfloat16, and every arithmetic result
// is rounded to bfloat16 (round to nearest even) where PyTorch's bfloat16
// operations round it, in the plain version's order, as kernel "stencil16"
// (csrc/stencil.cu) does for one pass. The two instances are one template
// on the storage type; in float32 the rounding is the identity.
//
// Bound: bytes. As a function a cycle reads b and each level's masks once
// and writes x once (~76 MB at 128^3 in float32, half in bfloat16, plus 1/7
// for the coarser levels).
//
// Arithmetic: every expression has the operation order of the plain PyTorch
// stage functions in libfluid_tpu_torch/sim/multigrid.py, and the file is
// built with -fmad=false, so no multiply-add is contracted and the results
// agree with the plain versions to rounding of identical operations. A
// neighbour's x is not multiplied by its fluid mask: the coupling of a face
// is 1 only between two fluid cells, so couple * (x * fluid) = couple * x.
// Cells outside the grid read as coupling 0 and value 0; odd axes restrict
// as if zero-padded to even size and prolong cropped. A term that the plain
// version adds as 0 (a shifted row past the edge of the restriction) is left
// out: adding 0 to a value of the storage type is exact, in bfloat16 too.
//
// The sweep counts are fixed by the caller's constants (2 pre, 2 post); the
// wrappers refuse other counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Storage of one instance: load to float, store from float, and the rounding
// of an arithmetic result to the storage type.
template <class T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float ld(float v) { return v; }
  static __device__ __forceinline__ float st(float v) { return v; }
  static __device__ __forceinline__ float r(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 st(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// One rounded operation of the storage type.
template <class T>
__device__ __forceinline__ float mul(float a, float b) {
  return Num<T>::r(a * b);
}
template <class T>
__device__ __forceinline__ float add(float a, float b) {
  return Num<T>::r(a + b);
}
template <class T>
__device__ __forceinline__ float sub(float a, float b) {
  return Num<T>::r(a - b);
}

template <class T>
struct Level {
  const T* diag;
  const T* inv_diag;
  const T* fluid;
  const T* cu;  // (nx+1, ny, nz)
  const T* cv;  // (nx, ny+1, nz)
  const T* cw;  // (nx, ny, nz+1)
  int nx, ny, nz;
  float scale;
};

template <class T>
__device__ __forceinline__ float ld(const T* p, int i) {
  return Num<T>::ld(p[i]);
}

template <class T>
__device__ __forceinline__ int cell_index(const Level<T>& L, int i, int j, int k) {
  return (i * L.ny + j) * L.nz + k;
}

// A x at cell (i, j, k), inside the grid; xf(i, j, k) gives x at a cell
// inside the grid, xc is x at the cell itself.
// scale * (diag * (x * fluid) - nbr) * fluid, neighbours in the order of the
// plain version's slice adds (nbr starts at 0, one rounded add each).
template <class T, class XF>
__device__ __forceinline__ float apply_at(const Level<T>& L, int i, int j, int k, float xc,
                                          float f, XF xf) {
  const int c = cell_index(L, i, j, k);
  const int syz = L.ny * L.nz;
  const int fu = c;                                  // u face i of the cell
  const int fv = (i * (L.ny + 1) + j) * L.nz + k;    // v face j
  const int fw = (i * L.ny + j) * (L.nz + 1) + k;    // w face k
  float nbr = 0.0f;
  if (i > 0) nbr = add<T>(nbr, mul<T>(ld(L.cu, fu), xf(i - 1, j, k)));
  if (i < L.nx - 1) nbr = add<T>(nbr, mul<T>(ld(L.cu, fu + syz), xf(i + 1, j, k)));
  if (j > 0) nbr = add<T>(nbr, mul<T>(ld(L.cv, fv), xf(i, j - 1, k)));
  if (j < L.ny - 1) nbr = add<T>(nbr, mul<T>(ld(L.cv, fv + L.nz), xf(i, j + 1, k)));
  if (k > 0) nbr = add<T>(nbr, mul<T>(ld(L.cw, fw), xf(i, j, k - 1)));
  if (k < L.nz - 1) nbr = add<T>(nbr, mul<T>(ld(L.cw, fw + 1), xf(i, j, k + 1)));
  return mul<T>(mul<T>(L.scale, sub<T>(mul<T>(ld(L.diag, c), mul<T>(xc, f)), nbr)), f);
}

// x + damp * inv_diag * (b - A x)
template <class T, class XF>
__device__ __forceinline__ float jacobi_at(const Level<T>& L, const T* b, int i, int j, int k,
                                           float xc, float damp, XF xf) {
  const int c = cell_index(L, i, j, k);
  const float ax = apply_at(L, i, j, k, xc, ld(L.fluid, c), xf);
  return add<T>(xc, mul<T>(mul<T>(damp, ld(L.inv_diag, c)), sub<T>(ld(b, c), ax)));
}

// One axis of R's transpose-of-prolongation: coarse row J of nc from the
// fine rows f0 = F[2J-1], f1 = F[2J], f2 = F[2J+1], f3 = F[2J+2] (rows
// outside the padded fine axis are not read), edge fold included, in the
// plain version's order of adds.
template <class T>
__device__ __forceinline__ float restrict_row(float f0, float f1, float f2, float f3, int J,
                                              int nc) {
  float t = mul<T>(0.75f, add<T>(f1, f2));
  if (J < nc - 1) t = add<T>(t, mul<T>(0.25f, f3));
  if (J == 0) t = add<T>(t, mul<T>(0.25f, f1));
  if (J > 0) t = add<T>(t, mul<T>(0.25f, f0));
  if (J == nc - 1) t = add<T>(t, mul<T>(0.25f, f2));
  return t;
}

// One axis of P: fine row i from coarse rows; gives the two coarse indices
// (the near one weighs 0.75, the far one 0.25, edge-clamped).
__device__ __forceinline__ void prolong_rows(int i, int nc, int* near, int* far) {
  const int J = i >> 1;
  *near = J;
  *far = (i & 1) ? min(J + 1, nc - 1) : max(J - 1, 0);
}

// P(ec) at fine cell (i, j, k): axis 0 first, then 1, then 2, as the plain
// version interpolates. ec is (cx, cy, cz).
template <class T>
__device__ __forceinline__ float prolong_at(const T* ec, int cx, int cy, int cz, int i, int j,
                                            int k) {
  int in, if_, jn, jf, kn, kf;
  prolong_rows(i, cx, &in, &if_);
  prolong_rows(j, cy, &jn, &jf);
  prolong_rows(k, cz, &kn, &kf);
  const int js[2] = {jn, jf};
  const int ks[2] = {kn, kf};
  float e2[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float e1[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float vn = ld(ec, (in * cy + js[a]) * cz + ks[b]);
      const float vf = ld(ec, (if_ * cy + js[a]) * cz + ks[b]);
      e1[a] = add<T>(mul<T>(0.75f, vn), mul<T>(0.25f, vf));
    }
    e2[b] = add<T>(mul<T>(0.75f, e1[0]), mul<T>(0.25f, e1[1]));
  }
  return add<T>(mul<T>(0.75f, e2[0]), mul<T>(0.25f, e2[1]));
}

// ---------------------------------------------------------------------------
// lf_mg_pre: x = (two damped-Jacobi sweeps from 0) * fluid
// ---------------------------------------------------------------------------

template <class T>
__global__ void mg_pre_kernel(Level<T> L, const T* __restrict__ b, T* __restrict__ out,
                              float damp) {
  const int total = L.nx * L.ny * L.nz;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= total) return;
  const int k = c % L.nz;
  const int j = (c / L.nz) % L.ny;
  const int i = c / (L.ny * L.nz);
  // the first sweep from x = 0: 0 + damp * inv_diag * (b - 0)
  auto x1 = [&](int a, int bb, int cc) {
    const int n = cell_index(L, a, bb, cc);
    return mul<T>(mul<T>(damp, ld(L.inv_diag, n)), ld(b, n));
  };
  const float x1c = x1(i, j, k);
  out[c] = Num<T>::st(mul<T>(jacobi_at(L, b, i, j, k, x1c, damp, x1), ld(L.fluid, c)));
}

// ---------------------------------------------------------------------------
// lf_mg_restrict: rc = R((b - A x) * fluid) * fluid_c
// ---------------------------------------------------------------------------

constexpr int RCX = 4, RCY = 4, RCZ = 16;  // coarse cells of a block
constexpr int RFX = 2 * RCX + 2, RFY = 2 * RCY + 2, RFZ = 2 * RCZ + 2;  // its fine support

template <class T>
__global__ void mg_restrict_kernel(Level<T> L, const T* __restrict__ x, const T* __restrict__ b,
                                   const T* __restrict__ fluid_c, T* __restrict__ rc, int cx,
                                   int cy, int cz) {
  __shared__ T r[RFX * RFY * RFZ];
  const int c0x = blockIdx.z * RCX, c0y = blockIdx.y * RCY, c0z = blockIdx.x * RCZ;
  const int f0x = 2 * c0x - 1, f0y = 2 * c0y - 1, f0z = 2 * c0z - 1;
  auto xg = [&](int a, int bb, int cc) { return ld(x, cell_index(L, a, bb, cc)); };
  for (int t = threadIdx.x; t < RFX * RFY * RFZ; t += blockDim.x) {
    const int lk = t % RFZ, lj = (t / RFZ) % RFY, li = t / (RFZ * RFY);
    const int i = f0x + li, j = f0y + lj, k = f0z + lk;
    float v = 0.0f;  // outside the grid, and the zero pad of an odd axis
    if (i >= 0 && i < L.nx && j >= 0 && j < L.ny && k >= 0 && k < L.nz) {
      const int c = cell_index(L, i, j, k);
      const float f = ld(L.fluid, c);
      v = mul<T>(sub<T>(ld(b, c), apply_at(L, i, j, k, ld(x, c), f, xg)), f);
    }
    r[t] = Num<T>::st(v);
  }
  __syncthreads();
  const int lk = threadIdx.x % RCZ, lj = (threadIdx.x / RCZ) % RCY, li = threadIdx.x / (RCZ * RCY);
  const int ci = c0x + li, cj = c0y + lj, ck = c0z + lk;
  if (ci >= cx || cj >= cy || ck >= cz) return;
  float w[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {  // fine z row 2 ck - 1 + a
    float v[4];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {  // fine y row 2 cj - 1 + bb
      const T* p = &r[((2 * li) * RFY + (2 * lj + bb)) * RFZ + (2 * lk + a)];
      v[bb] = restrict_row<T>(ld(p, 0), ld(p, RFY * RFZ), ld(p, 2 * RFY * RFZ),
                              ld(p, 3 * RFY * RFZ), ci, cx);
    }
    w[a] = restrict_row<T>(v[0], v[1], v[2], v[3], cj, cy);
  }
  const int cc = (ci * cy + cj) * cz + ck;
  rc[cc] = Num<T>::st(
      mul<T>(mul<T>(restrict_row<T>(w[0], w[1], w[2], w[3], ck, cz), 0.125f), ld(fluid_c, cc)));
}

// ---------------------------------------------------------------------------
// lf_mg_up: x' = (two sweeps of (x + P(ec) * fluid)) * fluid
// ---------------------------------------------------------------------------

constexpr int UX = 8, UY = 8, UZ = 32;  // output cells of a block
constexpr int U0X = UX + 4, U0Y = UY + 4, U0Z = UZ + 4;
constexpr int U1X = UX + 2, U1Y = UY + 2, U1Z = UZ + 2;

template <class T>
__global__ void mg_up_kernel(Level<T> L, const T* __restrict__ x, const T* __restrict__ ec,
                             const T* __restrict__ b, T* __restrict__ out, int cx, int cy, int cz,
                             float damp) {
  __shared__ T s0[U0X * U0Y * U0Z];  // x + P(ec) * fluid, tile + 2
  __shared__ T s1[U1X * U1Y * U1Z];  // after the first sweep, tile + 1
  const int t0x = blockIdx.z * UX, t0y = blockIdx.y * UY, t0z = blockIdx.x * UZ;
  auto inside = [&](int i, int j, int k) {
    return i >= 0 && i < L.nx && j >= 0 && j < L.ny && k >= 0 && k < L.nz;
  };
  for (int t = threadIdx.x; t < U0X * U0Y * U0Z; t += blockDim.x) {
    const int lk = t % U0Z, lj = (t / U0Z) % U0Y, li = t / (U0Z * U0Y);
    const int i = t0x - 2 + li, j = t0y - 2 + lj, k = t0z - 2 + lk;
    float v = 0.0f;
    if (inside(i, j, k)) {
      const int c = cell_index(L, i, j, k);
      v = add<T>(ld(x, c), mul<T>(prolong_at(ec, cx, cy, cz, i, j, k), ld(L.fluid, c)));
    }
    s0[t] = Num<T>::st(v);
  }
  __syncthreads();
  auto x0 = [&](int a, int bb, int cc) {
    return Num<T>::ld(s0[((a - t0x + 2) * U0Y + (bb - t0y + 2)) * U0Z + (cc - t0z + 2)]);
  };
  for (int t = threadIdx.x; t < U1X * U1Y * U1Z; t += blockDim.x) {
    const int lk = t % U1Z, lj = (t / U1Z) % U1Y, li = t / (U1Z * U1Y);
    const int i = t0x - 1 + li, j = t0y - 1 + lj, k = t0z - 1 + lk;
    s1[t] = Num<T>::st(inside(i, j, k) ? jacobi_at(L, b, i, j, k, x0(i, j, k), damp, x0) : 0.0f);
  }
  __syncthreads();
  auto x1 = [&](int a, int bb, int cc) {
    return Num<T>::ld(s1[((a - t0x + 1) * U1Y + (bb - t0y + 1)) * U1Z + (cc - t0z + 1)]);
  };
  for (int t = threadIdx.x; t < UX * UY * UZ; t += blockDim.x) {
    const int lk = t % UZ, lj = (t / UZ) % UY, li = t / (UZ * UY);
    const int i = t0x + li, j = t0y + lj, k = t0z + lk;
    if (!inside(i, j, k)) continue;
    const int c = cell_index(L, i, j, k);
    out[c] = Num<T>::st(mul<T>(jacobi_at(L, b, i, j, k, x1(i, j, k), damp, x1), ld(L.fluid, c)));
  }
}

// ---------------------------------------------------------------------------
// lf_mg_coarse: the sub-cycle of the small levels in one block
// ---------------------------------------------------------------------------

constexpr int MAX_COARSE_LEVELS = 6;

template <class T>
struct CoarseLevel {
  Level<T> op;
  const T* b;  // right-hand side: the input on the first level, else scratch
  T* xa;       // scratch, a level's cells each
  T* xb;
};

template <class T>
struct CoarseArgs {
  CoarseLevel<T> lv[MAX_COARSE_LEVELS];
  int n;
};

// `iters` sweeps from x = 0, masked; returns the buffer that holds the
// result. The buffers are read and written through plain pointers: they
// change between the block's barriers.
template <class T>
__device__ T* coarse_smooth0(const CoarseLevel<T>& C, int iters, float damp) {
  const Level<T>& L = C.op;
  const int total = L.nx * L.ny * L.nz;
  T* cur = C.xa;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const float v = mul<T>(mul<T>(damp, ld(L.inv_diag, c)), ld(C.b, c));
    cur[c] = Num<T>::st(iters == 1 ? mul<T>(v, ld(L.fluid, c)) : v);
  }
  __syncthreads();
  for (int s = 1; s < iters; ++s) {
    T* dst = cur == C.xa ? C.xb : C.xa;
    const T* src = cur;
    auto xs = [&](int a, int bb, int cc) { return ld(src, cell_index(L, a, bb, cc)); };
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      const int k = c % L.nz, j = (c / L.nz) % L.ny, i = c / (L.ny * L.nz);
      const float v = jacobi_at(L, C.b, i, j, k, ld(src, c), damp, xs);
      dst[c] = Num<T>::st(s == iters - 1 ? mul<T>(v, ld(L.fluid, c)) : v);
    }
    __syncthreads();
    cur = dst;
  }
  return cur;
}

template <class T>
__global__ void mg_coarse_kernel(CoarseArgs<T> A, T* out, int pre, int post, int coarse_iters,
                                 float damp) {
  T* xs[MAX_COARSE_LEVELS];  // each level's current x
  // down leg
  for (int l = 0; l < A.n - 1; ++l) {
    const CoarseLevel<T>& C = A.lv[l];
    const Level<T>& L = C.op;
    const CoarseLevel<T>& N = A.lv[l + 1];
    T* x = coarse_smooth0(C, pre, damp);
    xs[l] = x;
    // the residual goes to the level's free buffer
    T* r = x == C.xa ? C.xb : C.xa;
    const int total = L.nx * L.ny * L.nz;
    auto xg = [&](int a, int bb, int cc) { return ld(x, cell_index(L, a, bb, cc)); };
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      const int k = c % L.nz, j = (c / L.nz) % L.ny, i = c / (L.ny * L.nz);
      const float f = ld(L.fluid, c);
      r[c] = Num<T>::st(mul<T>(sub<T>(ld(C.b, c), apply_at(L, i, j, k, ld(x, c), f, xg)), f));
    }
    __syncthreads();
    const int cx = N.op.nx, cy = N.op.ny, cz = N.op.nz;
    T* nb = const_cast<T*>(N.b);
    auto rf = [&](int i, int j, int k) {  // zero pad of an odd axis
      return (i < L.nx && j < L.ny && k < L.nz) ? ld(r, cell_index(L, i, j, k)) : 0.0f;
    };
    for (int cc = threadIdx.x; cc < cx * cy * cz; cc += blockDim.x) {
      const int ck = cc % cz, cj = (cc / cz) % cy, ci = cc / (cy * cz);
      // the four fine rows 2J-1 .. 2J+2 of an axis, clamped where the fold
      // does not read them
      const int i0 = max(2 * ci - 1, 0), i3 = min(2 * ci + 2, 2 * cx - 1);
      const int j0 = max(2 * cj - 1, 0), j3 = min(2 * cj + 2, 2 * cy - 1);
      const int k0 = max(2 * ck - 1, 0), k3 = min(2 * ck + 2, 2 * cz - 1);
      const int is[4] = {i0, 2 * ci, 2 * ci + 1, i3};
      const int js[4] = {j0, 2 * cj, 2 * cj + 1, j3};
      const int ks[4] = {k0, 2 * ck, 2 * ck + 1, k3};
      float w[4];
      for (int a = 0; a < 4; ++a) {
        float v[4];
        for (int bb = 0; bb < 4; ++bb) {
          v[bb] = restrict_row<T>(rf(is[0], js[bb], ks[a]), rf(is[1], js[bb], ks[a]),
                                  rf(is[2], js[bb], ks[a]), rf(is[3], js[bb], ks[a]), ci, cx);
        }
        w[a] = restrict_row<T>(v[0], v[1], v[2], v[3], cj, cy);
      }
      nb[cc] = Num<T>::st(mul<T>(mul<T>(restrict_row<T>(w[0], w[1], w[2], w[3], ck, cz), 0.125f),
                                 ld(N.op.fluid, cc)));
    }
    __syncthreads();
  }
  // the coarsest level
  xs[A.n - 1] = coarse_smooth0(A.lv[A.n - 1], coarse_iters, damp);
  // up leg
  for (int l = A.n - 2; l >= 0; --l) {
    const CoarseLevel<T>& C = A.lv[l];
    const Level<T>& L = C.op;
    const Level<T>& N = A.lv[l + 1].op;
    const T* ec = xs[l + 1];
    T* cur = xs[l];
    T* dst = cur == C.xa ? C.xb : C.xa;
    const int total = L.nx * L.ny * L.nz;
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      const int k = c % L.nz, j = (c / L.nz) % L.ny, i = c / (L.ny * L.nz);
      dst[c] = Num<T>::st(
          add<T>(ld(cur, c), mul<T>(prolong_at(ec, N.nx, N.ny, N.nz, i, j, k), ld(L.fluid, c))));
    }
    __syncthreads();
    cur = dst;
    for (int s = 0; s < post; ++s) {
      dst = cur == C.xa ? C.xb : C.xa;
      const T* src = cur;
      auto xg = [&](int a, int bb, int cc) { return ld(src, cell_index(L, a, bb, cc)); };
      for (int c = threadIdx.x; c < total; c += blockDim.x) {
        const int k = c % L.nz, j = (c / L.nz) % L.ny, i = c / (L.ny * L.nz);
        const float v = jacobi_at(L, C.b, i, j, k, ld(src, c), damp, xg);
        dst[c] = Num<T>::st(s == post - 1 ? mul<T>(v, ld(L.fluid, c)) : v);
      }
      __syncthreads();
      cur = dst;
    }
    xs[l] = cur;
  }
  const Level<T>& L0 = A.lv[0].op;
  const T* res = xs[0];
  for (int c = threadIdx.x; c < L0.nx * L0.ny * L0.nz; c += blockDim.x) out[c] = res[c];
}

template <class T>
Level<T> make_level(const T* diag, const T* inv_diag, const T* fluid, const T* cu, const T* cv,
                    const T* cw, int nx, int ny, int nz, float scale) {
  Level<T> L;
  L.diag = diag;
  L.inv_diag = inv_diag;
  L.fluid = fluid;
  L.cu = cu;
  L.cv = cv;
  L.cw = cw;
  L.nx = nx;
  L.ny = ny;
  L.nz = nz;
  L.scale = scale;
  return L;
}

// The launchers of both instances.

template <class T>
int launch_pre(const T* b, const T* diag, const T* inv_diag, const T* fluid, const T* cu,
               const T* cv, const T* cw, T* out, int nx, int ny, int nz, float damp, float scale,
               void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  mg_pre_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale), b, out, damp);
  return (int)cudaGetLastError();
}

template <class T>
int launch_restrict(const T* x, const T* b, const T* diag, const T* inv_diag, const T* fluid,
                    const T* cu, const T* cv, const T* cw, const T* fluid_c, T* rc, int nx, int ny,
                    int nz, float scale, void* stream) {
  const int cx = (nx + 1) / 2, cy = (ny + 1) / 2, cz = (nz + 1) / 2;
  if ((long long)nx * ny * nz == 0) return 0;
  const dim3 grid((cz + RCZ - 1) / RCZ, (cy + RCY - 1) / RCY, (cx + RCX - 1) / RCX);
  mg_restrict_kernel<T><<<grid, RCX * RCY * RCZ, 0, (cudaStream_t)stream>>>(
      make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale), x, b, fluid_c, rc, cx, cy,
      cz);
  return (int)cudaGetLastError();
}

template <class T>
int launch_up(const T* x, const T* ec, const T* b, const T* diag, const T* inv_diag,
              const T* fluid, const T* cu, const T* cv, const T* cw, T* out, int nx, int ny,
              int nz, float damp, float scale, void* stream) {
  const int cx = (nx + 1) / 2, cy = (ny + 1) / 2, cz = (nz + 1) / 2;
  if ((long long)nx * ny * nz == 0) return 0;
  const dim3 grid((nz + UZ - 1) / UZ, (ny + UY - 1) / UY, (nx + UX - 1) / UX);
  mg_up_kernel<T><<<grid, 256, 0, (cudaStream_t)stream>>>(
      make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale), x, ec, b, out, cx, cy, cz,
      damp);
  return (int)cudaGetLastError();
}

template <class T>
int launch_coarse(const T* b, const void* const* arrays, const int* dims, const float* scales,
                  int n, T* scratch, T* out, int pre, int post, int coarse_iters, float damp,
                  void* stream) {
  if (n < 1 || n > MAX_COARSE_LEVELS || pre < 1 || post < 1 || coarse_iters < 1)
    return (int)cudaErrorInvalidValue;
  CoarseArgs<T> A;
  A.n = n;
  T* s = scratch;
  for (int l = 0; l < n; ++l) {
    const void* const* a = arrays + 6 * l;
    const int nx = dims[3 * l], ny = dims[3 * l + 1], nz = dims[3 * l + 2];
    const long long cells = (long long)nx * ny * nz;
    A.lv[l].op = make_level((const T*)a[0], (const T*)a[1], (const T*)a[2], (const T*)a[3],
                            (const T*)a[4], (const T*)a[5], nx, ny, nz, scales[l]);
    A.lv[l].xa = s;
    A.lv[l].xb = s + cells;
    s += 2 * cells;
    if (l == 0) {
      A.lv[l].b = b;
    } else {
      A.lv[l].b = s;
      s += cells;
    }
  }
  mg_coarse_kernel<T><<<1, 1024, 0, (cudaStream_t)stream>>>(A, out, pre, post, coarse_iters, damp);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 ("mg"). b, out and the level's diag, inv_diag, fluid: (nx, ny, nz);
// cu: (nx+1, ny, nz); cv: (nx, ny+1, nz); cw: (nx, ny, nz+1).
extern "C" int lf_mg_pre(const float* b, const float* diag, const float* inv_diag,
                         const float* fluid, const float* cu, const float* cv, const float* cw,
                         float* out, int nx, int ny, int nz, float damp, float scale,
                         void* stream) {
  return launch_pre(b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, damp, scale, stream);
}

// x, b and the fine level's arrays as above; fluid_c, rc: (cx, cy, cz) with
// cx = ceil(nx / 2) and so on.
extern "C" int lf_mg_restrict(const float* x, const float* b, const float* diag,
                              const float* inv_diag, const float* fluid, const float* cu,
                              const float* cv, const float* cw, const float* fluid_c, float* rc,
                              int nx, int ny, int nz, float scale, void* stream) {
  return launch_restrict(x, b, diag, inv_diag, fluid, cu, cv, cw, fluid_c, rc, nx, ny, nz, scale,
                         stream);
}

// x, b, out and the fine level's arrays as above; ec: (cx, cy, cz).
extern "C" int lf_mg_up(const float* x, const float* ec, const float* b, const float* diag,
                        const float* inv_diag, const float* fluid, const float* cu,
                        const float* cv, const float* cw, float* out, int nx, int ny, int nz,
                        float damp, float scale, void* stream) {
  return launch_up(x, ec, b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, damp, scale,
                   stream);
}

// The sub-cycle of `n` levels (at most 6), finest first. Host arrays of n
// entries each: `arrays` holds 6 device pointers a level (diag, inv_diag,
// fluid, cu, cv, cw), `dims` 3 ints a level, `scales` a float a level.
// `b` and `out` have the first level's shape; `scratch` holds, level after
// level, xa and xb (a level's cells each) and, from the second level on, the
// level's right-hand side.
extern "C" int lf_mg_coarse(const float* b, const void* const* arrays, const int* dims,
                            const float* scales, int n, float* scratch, float* out, int pre,
                            int post, int coarse_iters, float damp, void* stream) {
  return launch_coarse(b, arrays, dims, scales, n, scratch, out, pre, post, coarse_iters, damp,
                       stream);
}

// bfloat16 ("mg16"): the same four entry points with every array, the
// scratch included, in bfloat16; `damp` is the bfloat16 damping weight.
extern "C" int lf_mg16_pre(const __nv_bfloat16* b, const __nv_bfloat16* diag,
                           const __nv_bfloat16* inv_diag, const __nv_bfloat16* fluid,
                           const __nv_bfloat16* cu, const __nv_bfloat16* cv,
                           const __nv_bfloat16* cw, __nv_bfloat16* out, int nx, int ny, int nz,
                           float damp, float scale, void* stream) {
  return launch_pre(b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, damp, scale, stream);
}

extern "C" int lf_mg16_restrict(const __nv_bfloat16* x, const __nv_bfloat16* b,
                                const __nv_bfloat16* diag, const __nv_bfloat16* inv_diag,
                                const __nv_bfloat16* fluid, const __nv_bfloat16* cu,
                                const __nv_bfloat16* cv, const __nv_bfloat16* cw,
                                const __nv_bfloat16* fluid_c, __nv_bfloat16* rc, int nx, int ny,
                                int nz, float scale, void* stream) {
  return launch_restrict(x, b, diag, inv_diag, fluid, cu, cv, cw, fluid_c, rc, nx, ny, nz, scale,
                         stream);
}

extern "C" int lf_mg16_up(const __nv_bfloat16* x, const __nv_bfloat16* ec,
                          const __nv_bfloat16* b, const __nv_bfloat16* diag,
                          const __nv_bfloat16* inv_diag, const __nv_bfloat16* fluid,
                          const __nv_bfloat16* cu, const __nv_bfloat16* cv,
                          const __nv_bfloat16* cw, __nv_bfloat16* out, int nx, int ny, int nz,
                          float damp, float scale, void* stream) {
  return launch_up(x, ec, b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, damp, scale,
                   stream);
}

extern "C" int lf_mg16_coarse(const __nv_bfloat16* b, const void* const* arrays, const int* dims,
                              const float* scales, int n, __nv_bfloat16* scratch,
                              __nv_bfloat16* out, int pre, int post, int coarse_iters, float damp,
                              void* stream) {
  return launch_coarse(b, arrays, dims, scales, n, scratch, out, pre, post, coarse_iters, damp,
                       stream);
}
