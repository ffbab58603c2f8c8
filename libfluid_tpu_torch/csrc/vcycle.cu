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
//                   edge-clamped), then both post-sweeps, masked. A block
//                   marches a column of cells along x through rings of
//                   planes in shared memory (the halo is paid in y and z
//                   only); its coarse region is staged once and P runs
//                   separably (x, y, then z); the operator a thread sweeps
//                   twice is loaded once, into its registers.
//   lf_mg_coarse    every level from the first small one down: the whole
//                   sub-cycle, the coarsest level's sweeps included, in one
//                   block with __syncthreads() between the passes; the
//                   levels live in shared memory for the whole cycle
//                   (route "shared"), or, a last level too large for that,
//                   in device memory (route "device").
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
// for the coarser levels). lf_mg_coarse moves a few hundred kB: what bounds
// it is its chain of dependent passes (19 at 128^3), each a barrier and a
// round of shared-memory loads.
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

// Fine row q (0-3) of the four, 2J-1 .. 2J+2, that coarse row J of nc
// reads in the restriction, clamped where the edge fold does not read it.
__device__ __forceinline__ int fold_row(int J, int q, int nc) {
  const int r = 2 * J + q - 1;
  return q == 0 ? max(r, 0) : q == 3 ? min(r, 2 * nc - 1) : r;
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
// Arithmetic on the storage type's own values (lf_mg_up, lf_mg_coarse)
// ---------------------------------------------------------------------------
//
// float for float32. For bfloat16 the values stay __nv_bfloat16: a product
// of two bfloat16 values is exact in float32, so the card's bfloat16
// multiply, which rounds once, gives PyTorch's product; a sum or difference
// is formed in float32 and rounded once to bfloat16, as PyTorch does (no
// bfloat16 add). Every constant used here (0.75, 0.25, 0.125, 4^-l, the
// bfloat16 damping weight) is exact in the storage type.

template <class T>
struct Ar;

template <>
struct Ar<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
  static __device__ __forceinline__ float of(float v) { return v; }
  static __device__ __forceinline__ float add0(float v) { return 0.0f + v; }  // add(+0, v)
  // a small non-negative integer d < 2^7, exactly, without a conversion
  static __device__ __forceinline__ float small(unsigned d) {
    return __uint_as_float(0x4B000000u | d) - 8388608.0f;
  }
};

template <>
struct Ar<__nv_bfloat16> {
  using B = __nv_bfloat16;
  static __device__ __forceinline__ B mul(B a, B b) { return __hmul(a, b); }
  static __device__ __forceinline__ B add(B a, B b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  static __device__ __forceinline__ B sub(B a, B b) {
    return __float2bfloat16_rn(__bfloat162float(a) - __bfloat162float(b));
  }
  static __device__ __forceinline__ B of(float v) { return __float2bfloat16_rn(v); }
  // add(+0, v): v, but +0 for -0
  static __device__ __forceinline__ B add0(B v) {
    return __bfloat16_as_ushort(v) == 0x8000u ? __ushort_as_bfloat16((unsigned short)0) : v;
  }
  static __device__ __forceinline__ B small(unsigned d) {  // (128 + d) - 128, both exact
    return __hsub(__ushort_as_bfloat16((unsigned short)(0x4300u | d)),
                  __ushort_as_bfloat16((unsigned short)0x4300u));
  }
};

// ---------------------------------------------------------------------------
// lf_mg_up: x' = (two sweeps of (x + P(ec) * fluid)) * fluid
// ---------------------------------------------------------------------------
//
// A block owns a column of TY x UZ cells in (y, z) and marches along x over
// `planes` output planes. Each x plane of the column is computed once a
// stage, into a ring of three planes in shared memory: x0 = x + P(ec) *
// fluid on the column + 2, the first sweep s1 on the column + 1, the second
// sweep into `out`; the halo is paid in y and z only. The block's coarse
// region of ec is staged once; P runs separably through shared memory (a
// fine plane's rows along x and y from the staged region, then along z as
// x0 is formed), the plain version's operations in its order. Each thread
// owns fixed points of each stage (the index math is done once); the
// operator of the cell a thread sweeps twice (b, inv_diag, diag, fluid and
// its six faces) is loaded once into its registers and kept from the first
// sweep to the second; every load of a plane is issued before the stages
// that wait on it. Cells outside the grid read as value 0: their products
// with the faces of the edge are zeros, and adding a zero to the neighbour
// sum, which starts at +0 and so is never -0, changes no bit.

constexpr int UZ = 32;   // z cells of a block's column: a warp a row
constexpr int UCX = 16;  // the most output planes a block marches over

template <int TY>
struct UpTile {
  static constexpr int NT = TY * UZ;                  // threads, one per cell of the column
  static constexpr int R0Y = TY + 4, R0Z = UZ + 4;    // x0: the column + 2
  static constexpr int R1Y = TY + 2, R1Z = UZ + 2;    // s1: the column + 1
  static constexpr int EX = UCX / 2 + 5, EY = TY / 2 + 4, EZ = UZ / 2 + 4;  // the coarse region
  static constexpr int H0 = R0Y * R0Z - NT;           // x0 points of the halo ring
  static constexpr int H1 = R1Y * R1Z - NT;           // s1 points of the halo ring
  static_assert(H0 <= NT && H1 <= NT && R0Y * EZ <= NT, "one halo point a thread");
};

// Point `h` of the ring of width w around the TY x UZ column in a region of
// RY x RZ points: (ly, lz) in the region.
__device__ __forceinline__ void ring_point(int h, int RY, int RZ, int w, int* ly, int* lz) {
  const int band = w * RZ;
  if (h < 2 * band) {  // the w rows below the column, then the w rows above
    const int r = h / RZ;
    *ly = r < w ? r : RY - 2 * w + r;
    *lz = h - r * RZ;
    return;
  }
  h -= 2 * band;  // the w points on either side of each row of the column
  const int r = h / (2 * w), c = h - r * 2 * w;
  *ly = w + r;
  *lz = c < w ? c : RZ - 2 * w + c;
}

// The operator of one cell: b, inv_diag, diag, fluid and its six faces.
template <class T>
struct CellOp {
  T b, inv, d, f, cul, cuh, cvl, cvh, cwl, cwh;
};

// A point of the first sweep: where its cell and its faces are in a plane,
// and where it sits in the x0 and s1 regions.
struct SweepPoint {
  int g, gw;   // in-plane offset of the cell (and of its v face), of its w face
  int c0, c1;  // index in the x0 region, in the s1 region
  bool in;     // inside the grid
};

template <class T>
__device__ __forceinline__ CellOp<T> load_op(const Level<T>& L, const T* __restrict__ b, int p,
                                             const SweepPoint& s) {
  const int syz = L.ny * L.nz;
  const int c = p * syz + s.g;
  const int fv = p * (syz + L.nz) + s.g;
  const int fw = p * (syz + L.ny) + s.gw;
  CellOp<T> o;
  o.b = b[c];
  o.inv = L.inv_diag[c];
  o.d = L.diag[c];
  o.f = L.fluid[c];
  o.cul = L.cu[c];
  o.cuh = L.cu[c + syz];
  o.cvl = L.cv[fv];
  o.cvh = L.cv[fv + L.nz];
  o.cwl = L.cw[fw];
  o.cwh = L.cw[fw + 1];
  return o;
}

// jacobi_at on a cell whose operator is `o`, x at the cell xc and at its
// neighbours below and above along x, y and z.
template <class T>
__device__ __forceinline__ T sweep_at(const CellOp<T>& o, T xc, T xm, T xp, T ym, T yp, T zm,
                                      T zp, T scale, T damp) {
  using A = Ar<T>;
  T nbr = A::add0(A::mul(o.cul, xm));
  nbr = A::add(nbr, A::mul(o.cuh, xp));
  nbr = A::add(nbr, A::mul(o.cvl, ym));
  nbr = A::add(nbr, A::mul(o.cvh, yp));
  nbr = A::add(nbr, A::mul(o.cwl, zm));
  nbr = A::add(nbr, A::mul(o.cwh, zp));
  const T ax = A::mul(A::mul(scale, A::sub(A::mul(o.d, A::mul(xc, o.f)), nbr)), o.f);
  return A::add(xc, A::mul(A::mul(damp, o.inv), A::sub(o.b, ax)));
}

template <class T, int TY>
__global__ void __launch_bounds__(TY * UZ, 2) mg_up_kernel(Level<T> L, const T* __restrict__ x,
                                                        const T* __restrict__ ec,
                                                        const T* __restrict__ b,
                                                        T* __restrict__ out, int cx, int cy,
                                                        int cz, int planes, float damp_f) {
  using U = UpTile<TY>;
  using A = Ar<T>;
  __shared__ T se[U::EX * U::EY * U::EZ];  // the block's coarse region of ec
  __shared__ T sp[U::R0Y * U::EZ];         // P along x and y of one fine plane
  __shared__ T s0[3][U::R0Y * U::R0Z];     // x0, three planes
  __shared__ T s1[3][U::R1Y * U::R1Z];     // s1, three planes
  const int tid = threadIdx.x;
  const int nx = L.nx, ny = L.ny, nz = L.nz, syz = ny * nz;
  const int z0 = blockIdx.x * UZ, y0 = blockIdx.y * TY, xa = blockIdx.z * planes;
  const int xe = min(xa + planes, nx);  // output planes [xa, xe)
  // the coarse region: every row that P reads for fine rows [xa - 2, xe + 1]
  // and the column + 2
  const int ex0 = ((xa - 2) >> 1) - 1, ey0 = (y0 >> 1) - 2, ez0 = (z0 >> 1) - 2;
  const T zero = A::of(0.0f), k75 = A::of(0.75f), k25 = A::of(0.25f);
  const T scale = A::of(L.scale), damp = A::of(damp_f);

  for (int t = tid; t < U::EY * U::EZ; t += U::NT) {
    const int ly = t / U::EZ, lz = t - ly * U::EZ;
    const int J = ey0 + ly, K = ez0 + lz;
    const bool in = J >= 0 && J < cy && K >= 0 && K < cz;
#pragma unroll
    for (int lx = 0; lx < U::EX; ++lx) {
      const int I = ex0 + lx;
      se[(lx * U::EY + ly) * U::EZ + lz] =
          in && I >= 0 && I < cx ? ec[(I * cy + J) * cz + K] : zero;
    }
  }

  // Each thread's points, fixed for the march.
  // (a) P along x and y: fine row j of the region, coarse row K
  const bool has_p = tid < U::R0Y * U::EZ;
  int p_n = 0, p_f = 0;  // offsets of the near and far coarse y rows in a plane of se
  bool p_in = false;
  {
    const int ly = tid / U::EZ, lz = tid - ly * U::EZ;
    const int j = y0 - 2 + ly, K = ez0 + lz;
    p_in = has_p && j >= 0 && j < ny && K >= 0 && K < cz;
    int jn = 0, jf = 0;
    if (p_in) prolong_rows(j, cy, &jn, &jf);
    p_n = (jn - ey0) * U::EZ + lz;
    p_f = (jf - ey0) * U::EZ + lz;
  }
  // (b) x0: the thread's cell of the column and, for the first H0 threads,
  // a point of the ring around it
  const int ty = tid / UZ, tz = tid - ty * UZ;
  struct X0Point {
    int g, sh, bn, bf;
    bool in;
  } xp[2];
  const int nxp = tid < U::H0 ? 2 : 1;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    int ly = ty + 2, lz = tz + 2;
    if (a == 1) ring_point(tid < U::H0 ? tid : 0, U::R0Y, U::R0Z, 2, &ly, &lz);
    const int j = y0 - 2 + ly, k = z0 - 2 + lz;
    X0Point& P = xp[a];
    P.in = j >= 0 && j < ny && k >= 0 && k < nz;
    P.g = j * nz + k;
    P.sh = ly * U::R0Z + lz;
    int kn = 0, kf = 0;
    if (P.in) prolong_rows(k, cz, &kn, &kf);
    P.bn = ly * U::EZ + (kn - ez0);
    P.bf = ly * U::EZ + (kf - ez0);
  }
  // (c) s1: the thread's cell and, for the last H1 threads, a point of the ring
  SweepPoint sw[2];
  const bool has_ring1 = tid >= U::NT - U::H1;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    int ly = ty + 1, lz = tz + 1;
    if (a == 1) ring_point(has_ring1 ? tid - (U::NT - U::H1) : 0, U::R1Y, U::R1Z, 1, &ly, &lz);
    const int j = y0 - 1 + ly, k = z0 - 1 + lz;
    SweepPoint& S = sw[a];
    S.in = j >= 0 && j < ny && k >= 0 && k < nz;
    S.g = j * nz + k;
    S.gw = j * (nz + 1) + k;
    S.c0 = (ly + 1) * U::R0Z + (lz + 1);
    S.c1 = ly * U::R1Z + lz;
  }
  // (d) the output: the thread's cell, sw[0]

  CellOp<T> op_cur, op_out;  // the thread's cell at the s1 plane, at the output plane
  op_cur.f = zero;
  int xm = 0, xc = 1, xq = 2;  // ring slots of x0 planes q - 2, q - 1, q
  int sm = 0, sc = 1, sq = 2;  // of s1 planes q - 3, q - 2, q - 1
  __syncthreads();
  for (int q = xa - 2; q <= xe + 1; ++q) {
    {  // the slot of plane q - 3 takes plane q
      const int t0 = xm;
      xm = xc;
      xc = xq;
      xq = t0;
      const int t1 = sm;
      sm = sc;
      sc = sq;
      sq = t1;
    }
    const bool q_in = q >= 0 && q < nx;
    const int p1 = q - 1, p2 = q - 2;  // the planes of s1 and of the output
    const bool do1 = p1 >= xa - 1, p1_in = do1 && p1 >= 0 && p1 < nx;
    const bool do2 = p2 >= xa;
    // this iteration's loads, issued before the stages that wait on them
    T xv[2] = {zero, zero}, fv[2] = {zero, zero};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a < nxp && q_in && xp[a].in) {
        xv[a] = x[q * syz + xp[a].g];
        fv[a] = L.fluid[q * syz + xp[a].g];
      }
    }
    op_out = op_cur;
    if (p1_in && sw[0].in) op_cur = load_op(L, b, p1, sw[0]);
    CellOp<T> op_ring = op_cur;
    if (has_ring1 && p1_in && sw[1].in) op_ring = load_op(L, b, p1, sw[1]);

    // P of plane q along x (the staged coarse planes) and y
    if (q_in && p_in) {
      int in_, if_;
      prolong_rows(q, cx, &in_, &if_);
      const T* cn = se + (in_ - ex0) * (U::EY * U::EZ);
      const T* cf = se + (if_ - ex0) * (U::EY * U::EZ);
      const T en = A::add(A::mul(k75, cn[p_n]), A::mul(k25, cf[p_n]));
      const T ef = A::add(A::mul(k75, cn[p_f]), A::mul(k25, cf[p_f]));
      sp[tid] = A::add(A::mul(k75, en), A::mul(k25, ef));
    }
    __syncthreads();
    // x0 of plane q: P along z, then x + P * fluid
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a < nxp) {
        T v = zero;
        if (q_in && xp[a].in) {
          const T e = A::add(A::mul(k75, sp[xp[a].bn]), A::mul(k25, sp[xp[a].bf]));
          v = A::add(xv[a], A::mul(e, fv[a]));
        }
        s0[xq][xp[a].sh] = v;
      }
    }
    __syncthreads();
    // the first sweep of plane p1
    if (do1) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a == 0 || has_ring1) {
          const SweepPoint& S = sw[a];
          T v = zero;
          if (p1_in && S.in) {
            const T* m = s0[xc];
            v = sweep_at<T>(a == 0 ? op_cur : op_ring, m[S.c0], s0[xm][S.c0], s0[xq][S.c0],
                            m[S.c0 - U::R0Z], m[S.c0 + U::R0Z], m[S.c0 - 1], m[S.c0 + 1], scale,
                            damp);
          }
          s1[sq][S.c1] = v;
        }
      }
    }
    __syncthreads();
    // the second sweep of plane p2, masked, out
    if (do2 && sw[0].in) {
      const SweepPoint& S = sw[0];
      const T* m = s1[sc];
      const T v = sweep_at<T>(op_out, m[S.c1], s1[sm][S.c1], s1[sq][S.c1], m[S.c1 - U::R1Z],
                              m[S.c1 + U::R1Z], m[S.c1 - 1], m[S.c1 + 1], scale, damp);
      out[p2 * syz + S.g] = A::mul(v, op_out.f);
    }
  }
}

// ---------------------------------------------------------------------------
// lf_mg_coarse: the sub-cycle of the small levels in one block
// ---------------------------------------------------------------------------
//
// One block runs every pass of the sub-cycle (at 128^3, on 16^3 and 8^3: 2
// pre-sweeps, the residual, the restriction, 12 sweeps, the prolongation
// and 2 post-sweeps: 19, as 21 passes here) with a barrier between passes; the
// first sweep from x = 0 is pointwise and runs in the pass that makes the
// level's b (the staging, or the restriction from the level above), and
// the last post-sweep writes `out`.
//
// Route "shared" (the launcher's choice, from a byte count the caller
// makes): every level lives in dynamic shared memory for the whole cycle:
// inv_diag, b and two x buffers in the storage type, and a 16-bit word a
// cell with its fluid bit, a bit for each of its six faces that joins it
// to a neighbour inside the level with coupling 1, and its diag (exact for
// the operator's 0/1 masks and integer diagonal, as _operator_from_types
// builds them). A sweep then reads one word and adds the neighbours whose
// bit is set: a face of coupling 1 multiplies exactly, and the plain
// version's product with a face of coupling 0 is a zero whose add changes
// no bit of the sum (for finite x). No index math in the sweeps.
//
// Route "device": a level too large for that (only the last level of a
// thin hierarchy) keeps its arrays and the scratch in device memory and
// runs the same passes there, apply_at's bounds tests and face loads
// included.

constexpr int MAX_COARSE_LEVELS = 6;
// threads of the block: route "shared" keeps more registers a thread (its
// passes are short chains on shared memory); route "device" more threads
// for its loads from device memory
template <bool RES>
constexpr int COARSE_THREADS = RES ? 512 : 1024;
constexpr int BATCH = 8;  // cells whose loads a thread issues before it stores any

template <class T>
struct CoarseLevel {
  Level<T> op;
  const T* b;      // the input on the first level; route "device": scratch below
  T* xa;           // route "device": scratch, a level's cells each
  T* xb;
  float rz, ryz;   // 1 / nz and 1 / (ny nz), for the cell index's decode
};

template <class T>
struct CoarseArgs {
  CoarseLevel<T> lv[MAX_COARSE_LEVELS];
  int n;
};

// (i, j, k) of cell c without an integer division: the quotients in float
// are exact for c + nz < 2^22 (the levels here have at most 2^15 cells).
__device__ __forceinline__ void decode(int c, int nz, int syz, float rz, float ryz, int* i,
                                       int* j, int* k) {
  *i = (int)(((float)c + 0.5f) * ryz);
  const int r = c - *i * syz;
  *j = (int)(((float)r + 0.5f) * rz);
  *k = r - *j * nz;
}

// route "shared": a cell's word
constexpr unsigned W_FLUID = 1u, W_XM = 2u, W_XP = 4u, W_YM = 8u, W_YP = 16u, W_ZM = 32u,
                   W_ZP = 64u;
constexpr int W_DIAG = 8;  // diag in bits 8-11

// A level as the passes see it: in shared memory (RES) or in device memory.
template <class T, bool RES>
struct CView {
  Level<T> op;            // the device arrays
  const uint16_t* w;      // route "shared": the cells' words
  const T* inv;
  T* b;
  T* xa;
  T* xb;
  int syz;
  float rz, ryz;
  __device__ __forceinline__ int cells() const { return op.nx * syz; }
  __device__ __forceinline__ void at(int c, int* i, int* j, int* k) const {
    decode(c, op.nz, syz, rz, ryz, i, j, k);
  }
  __device__ __forceinline__ T* other(const T* x) const { return x == xa ? xb : xa; }
  __device__ __forceinline__ T fluid(int c) const {
    if constexpr (RES) return (w[c] & W_FLUID) ? Ar<T>::of(1.0f) : Ar<T>::of(0.0f);
    else return op.fluid[c];
  }
  // A x at cell c (x read from `x`, xc = x[c], f its fluid), apply_at's
  // order
  __device__ __forceinline__ T ax(const T* x, int c, T xc, T f) const {
    using A = Ar<T>;
    if constexpr (RES) {
      return ax_word(x, c, w[c], xc, f);
    } else {
      T nbr = A::of(0.0f);
      int i, j, k;
      at(c, &i, &j, &k);
      const int fv = c + i * op.nz, fw = c + i * op.ny + j;
      if (i > 0) nbr = A::add(nbr, A::mul(op.cu[c], x[c - syz]));
      if (i < op.nx - 1) nbr = A::add(nbr, A::mul(op.cu[c + syz], x[c + syz]));
      if (j > 0) nbr = A::add(nbr, A::mul(op.cv[fv], x[c - op.nz]));
      if (j < op.ny - 1) nbr = A::add(nbr, A::mul(op.cv[fv + op.nz], x[c + op.nz]));
      if (k > 0) nbr = A::add(nbr, A::mul(op.cw[fw], x[c - 1]));
      if (k < op.nz - 1) nbr = A::add(nbr, A::mul(op.cw[fw + 1], x[c + 1]));
      return A::mul(A::mul(A::of(op.scale), A::sub(A::mul(op.diag[c], A::mul(xc, f)), nbr)), f);
    }
  }
  // route "shared": A x at cell c whose word is m
  __device__ __forceinline__ T ax_word(const T* x, int c, unsigned m, T xc, T f) const {
    using A = Ar<T>;
    T nbr = A::of(0.0f);
    if (m & W_XM) nbr = A::add0(x[c - syz]);
    if (m & W_XP) nbr = A::add(nbr, x[c + syz]);
    if (m & W_YM) nbr = A::add(nbr, x[c - op.nz]);
    if (m & W_YP) nbr = A::add(nbr, x[c + op.nz]);
    if (m & W_ZM) nbr = A::add(nbr, x[c - 1]);
    if (m & W_ZP) nbr = A::add(nbr, x[c + 1]);
    const T d = A::small(m >> W_DIAG);
    return A::mul(A::mul(A::of(op.scale), A::sub(A::mul(d, A::mul(xc, f)), nbr)), f);
  }
};

template <class T, bool RES>
__device__ CView<T, RES> coarse_view(const CoarseArgs<T>& A, int l, unsigned char* smem) {
  const CoarseLevel<T>& C = A.lv[l];
  CView<T, RES> V;
  V.op = C.op;
  V.syz = C.op.ny * C.op.nz;
  V.rz = C.rz;
  V.ryz = C.ryz;
  if constexpr (RES) {
    // T arrays of every level (inv_diag, b, xa, xb), then the words
    int before = 0, all = 0;
    for (int m = 0; m < A.n; ++m) {
      const int cells = A.lv[m].op.nx * A.lv[m].op.ny * A.lv[m].op.nz;
      before += m < l ? cells : 0;
      all += cells;
    }
    const int cells = C.op.nx * V.syz;
    T* s = reinterpret_cast<T*>(smem) + 4 * before;
    V.inv = s;
    V.b = s + cells;
    V.xa = s + 2 * cells;
    V.xb = s + 3 * cells;
    V.w = reinterpret_cast<const uint16_t*>(smem + 4 * all * (int)sizeof(T)) + before;
  } else {
    V.w = nullptr;
    V.inv = C.op.inv_diag;
    V.b = const_cast<T*>(C.b);
    V.xa = C.xa;
    V.xb = C.xb;
  }
  return V;
}

// The first of `iters` sweeps from x = 0 at cell c, whose b is bv: into xa,
// masked if it is the last.
template <class T, bool RES>
__device__ __forceinline__ void first_sweep(const CView<T, RES>& V, int c, T bv, int iters,
                                            T damp) {
  using A = Ar<T>;
  const T v = A::mul(A::mul(damp, V.inv[c]), bv);
  V.xa[c] = iters == 1 ? A::mul(v, V.fluid(c)) : v;
}

// Sweeps `from` .. `iters` - 1 of a level from x in `cur`, the last masked
// (and written to `last_out` if given, with no barrier after it). Returns
// where the result is.
template <class T, bool RES>
__device__ T* coarse_sweeps(const CView<T, RES>& V, T* cur, int from, int iters, T damp,
                            T* last_out) {
  using A = Ar<T>;
  if constexpr (RES) {
    if (V.cells() <= COARSE_THREADS<RES>) {
      // a cell a thread at most: its word, inv_diag, b and x stay in
      // registers from sweep to sweep
      const int c = threadIdx.x;
      const bool own = c < V.cells();
      unsigned m = 0;
      T inv = A::of(0.0f), bv = inv, xc = inv, f = inv;
      if (own) {
        m = V.w[c];
        inv = V.inv[c];
        bv = V.b[c];
        xc = cur[c];
        f = (m & W_FLUID) ? A::of(1.0f) : A::of(0.0f);
      }
      const T di = A::mul(damp, inv);
      for (int s = from; s < iters; ++s) {
        const bool last = s == iters - 1;
        T* dst = last && last_out ? last_out : V.other(cur);
        if (own) {
          const T v = A::add(xc, A::mul(di, A::sub(bv, V.ax_word(cur, c, m, xc, f))));
          xc = last ? A::mul(v, f) : v;
          dst[c] = xc;
        }
        if (!(last && last_out)) __syncthreads();
        cur = dst;
      }
      return cur;
    }
  }
  for (int s = from; s < iters; ++s) {
    const bool last = s == iters - 1;
    T* dst = last && last_out ? last_out : V.other(cur);
#pragma unroll 4
    for (int c = threadIdx.x; c < V.cells(); c += COARSE_THREADS<RES>) {
      const T xc = cur[c], f = V.fluid(c);
      const T ax = V.ax(cur, c, xc, f);
      const T v = A::add(xc, A::mul(A::mul(damp, V.inv[c]), A::sub(V.b[c], ax)));
      dst[c] = last ? A::mul(v, f) : v;
    }
    if (!(last && last_out)) __syncthreads();
    cur = dst;
  }
  return cur;
}

// restrict_row in the storage type's arithmetic.
template <class T>
__device__ __forceinline__ T restrict_row_t(T f0, T f1, T f2, T f3, int J, int nc) {
  using A = Ar<T>;
  const T q = A::of(0.25f);
  T t = A::mul(A::of(0.75f), A::add(f1, f2));
  if (J < nc - 1) t = A::add(t, A::mul(q, f3));
  if (J == 0) t = A::add(t, A::mul(q, f1));
  if (J > 0) t = A::add(t, A::mul(q, f0));
  if (J == nc - 1) t = A::add(t, A::mul(q, f2));
  return t;
}

template <class T, bool RES>
__device__ void coarse_run(const CoarseArgs<T>& A, T* out, int pre, int post, int coarse_iters,
                           T damp, unsigned char* smem) {
  using R = Ar<T>;
  const int n = A.n;
  // one pass: stage every level's words and inv_diag (route "shared"), and
  // level 0's b with its first sweep; a thread loads BATCH cells before it
  // stores any, so that their loads are in flight together
  for (int l = 0; l < n; ++l) {
    const CView<T, RES> V = coarse_view<T, RES>(A, l, smem);
    const Level<T>& L = V.op;
    const int iters0 = n == 1 ? coarse_iters : pre;
    for (int c0 = threadIdx.x; c0 < V.cells(); c0 += BATCH * COARSE_THREADS<RES>) {
      if constexpr (RES) {
        T g[BATCH][10];
        unsigned edge[BATCH];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int c = c0 + q * COARSE_THREADS<RES>;
          if (c >= V.cells()) break;
          int i, j, k;
          V.at(c, &i, &j, &k);
          const int fv = c + i * L.nz, fw = c + i * L.ny + j;
          const T* src[10] = {L.cu + c, L.cu + c + V.syz, L.cv + fv, L.cv + fv + L.nz, L.cw + fw,
                              L.cw + fw + 1, L.fluid + c, L.diag + c, L.inv_diag + c,
                              A.lv[0].b + c};
#pragma unroll
          for (int e = 0; e < 10; ++e) g[q][e] = e < 9 || l == 0 ? __ldg(src[e]) : R::of(0.0f);
          edge[q] = (i > 0 ? W_XM : 0u) | (i < L.nx - 1 ? W_XP : 0u) | (j > 0 ? W_YM : 0u) |
                    (j < L.ny - 1 ? W_YP : 0u) | (k > 0 ? W_ZM : 0u) |
                    (k < L.nz - 1 ? W_ZP : 0u);
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int c = c0 + q * COARSE_THREADS<RES>;
          if (c >= V.cells()) break;
          auto set = [](T v) { return Num<T>::ld(v) != 0.0f; };
          unsigned m = 0;
#pragma unroll
          for (int e = 0; e < 6; ++e) m |= set(g[q][e]) ? (W_XM << e) : 0u;
          m = (m & edge[q]) | (set(g[q][6]) ? W_FLUID : 0u) |
              (unsigned)(int)Num<T>::ld(g[q][7]) << W_DIAG;
          const_cast<uint16_t*>(V.w)[c] = (uint16_t)m;
          const_cast<T*>(V.inv)[c] = g[q][8];
          if (l == 0) {
            V.b[c] = g[q][9];
            const T v = R::mul(R::mul(damp, g[q][8]), g[q][9]);
            V.xa[c] = iters0 == 1 ? R::mul(v, g[q][6]) : v;
          }
        }
      } else if (l == 0) {
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int c = c0 + q * COARSE_THREADS<RES>;
          if (c < V.cells()) first_sweep(V, c, A.lv[0].b[c], iters0, damp);
        }
      }
    }
  }
  __syncthreads();
  T* xs[MAX_COARSE_LEVELS];  // each level's x after its pre-sweeps
  for (int l = 0; l < n - 1; ++l) {  // down leg
    const CView<T, RES> V = coarse_view<T, RES>(A, l, smem);
    const CView<T, RES> N = coarse_view<T, RES>(A, l + 1, smem);
    const Level<T>& L = V.op;
    T* x = coarse_sweeps(V, V.xa, 1, pre, damp, (T*)nullptr);
    xs[l] = x;
    // the residual, into the level's free buffer
    T* r = V.other(x);
    for (int c = threadIdx.x; c < V.cells(); c += COARSE_THREADS<RES>) {
      const T f = V.fluid(c);
      r[c] = R::mul(R::sub(V.b[c], V.ax(x, c, x[c], f)), f);
    }
    __syncthreads();
    // the restriction R = P^T / 8, separably in restrict_row's order: along
    // x and y into the next level's two x buffers (contiguous; a value a
    // coarse (ci, cj) and fine k), then along z into the next level's b;
    // then the next level's first sweep
    const int cx = N.op.nx, cy = N.op.ny, cz = N.op.nz;
    const T zero = R::of(0.0f);
    T* rxy = N.xa;
    const float rnz = 1.0f / (float)L.nz, rcy = 1.0f / (float)cy;
    for (int t = threadIdx.x; t < cx * cy * L.nz; t += COARSE_THREADS<RES>) {
      const int row = (int)(((float)t + 0.5f) * rnz), k = t - row * L.nz;
      const int ci = (int)(((float)row + 0.5f) * rcy), cj = row - ci * cy;
      // the four fine rows of x and y as offsets into r; -1 where a row is
      // the zero pad of an odd axis
      int oi[4], oj[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = fold_row(ci, q, cx), j = fold_row(cj, q, cy);
        oi[q] = i < L.nx ? i * V.syz : -1;
        oj[q] = j < L.ny ? j * L.nz : -1;
      }
      auto rf = [&](int q, int bb) {
        return (oi[q] | oj[bb]) < 0 ? zero : r[oi[q] + oj[bb] + k];
      };
      T v[4];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        v[bb] = restrict_row_t<T>(rf(0, bb), rf(1, bb), rf(2, bb), rf(3, bb), ci, cx);
      rxy[t] = restrict_row_t<T>(v[0], v[1], v[2], v[3], cj, cy);
    }
    __syncthreads();
    for (int cc = threadIdx.x; cc < N.cells(); cc += COARSE_THREADS<RES>) {
      int ci, cj, ck;
      N.at(cc, &ci, &cj, &ck);
      const T* row = rxy + (ci * cy + cj) * L.nz;
      T w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = fold_row(ck, q, cz);
        w[q] = k < L.nz ? row[k] : zero;
      }
      N.b[cc] = R::mul(R::mul(restrict_row_t<T>(w[0], w[1], w[2], w[3], ck, cz), R::of(0.125f)),
                       N.fluid(cc));
    }
    __syncthreads();
    const int next_iters = l + 1 == n - 1 ? coarse_iters : pre;
    for (int cc = threadIdx.x; cc < N.cells(); cc += COARSE_THREADS<RES>)
      first_sweep(N, cc, N.b[cc], next_iters, damp);
    __syncthreads();
  }
  // the coarsest level
  {
    const CView<T, RES> V = coarse_view<T, RES>(A, n - 1, smem);
    xs[n - 1] = coarse_sweeps(V, V.xa, 1, coarse_iters, damp, n == 1 ? out : (T*)nullptr);
  }
  // up leg: P separably, axis 0, then 1, then 2, as the plain version
  // interpolates: along x and y into the level's free buffer, a value a fine
  // row (i, j) and coarse K; then along z, added to x in place (each cell
  // reads and writes only itself)
  const T k75 = R::of(0.75f), k25 = R::of(0.25f);
  for (int l = n - 2; l >= 0; --l) {
    const CView<T, RES> V = coarse_view<T, RES>(A, l, smem);
    const Level<T>& L = V.op;
    const int cx = A.lv[l + 1].op.nx, cy = A.lv[l + 1].op.ny, cz = A.lv[l + 1].op.nz;
    const T* ec = xs[l + 1];
    T* cur = xs[l];
    T* pxy = V.other(cur);
    const float rcz = 1.0f / (float)cz, rny = 1.0f / (float)L.ny;
    for (int t = threadIdx.x; t < L.nx * L.ny * cz; t += COARSE_THREADS<RES>) {
      const int row = (int)(((float)t + 0.5f) * rcz), K = t - row * cz;
      const int i = (int)(((float)row + 0.5f) * rny), j = row - i * L.ny;
      int in, if_, jn, jf;
      prolong_rows(i, cx, &in, &if_);
      prolong_rows(j, cy, &jn, &jf);
      const T* n0 = ec + in * cy * cz + K;
      const T* f0 = ec + if_ * cy * cz + K;
      const T en = R::add(R::mul(k75, n0[jn * cz]), R::mul(k25, f0[jn * cz]));
      const T ef = R::add(R::mul(k75, n0[jf * cz]), R::mul(k25, f0[jf * cz]));
      pxy[t] = R::add(R::mul(k75, en), R::mul(k25, ef));
    }
    __syncthreads();
#pragma unroll 4
    for (int c = threadIdx.x; c < V.cells(); c += COARSE_THREADS<RES>) {
      int i, j, k;
      V.at(c, &i, &j, &k);
      int kn, kf;
      prolong_rows(k, cz, &kn, &kf);
      const int row = (i * L.ny + j) * cz;
      const T e = R::add(R::mul(k75, pxy[row + kn]), R::mul(k25, pxy[row + kf]));
      cur[c] = R::add(cur[c], R::mul(e, V.fluid(c)));
    }
    __syncthreads();
    xs[l] = coarse_sweeps(V, cur, 0, post, damp, l == 0 ? out : (T*)nullptr);
  }
  // with no sweep left to write it (one level of one iteration), copy
  if (xs[0] != out) {
    const CView<T, RES> V = coarse_view<T, RES>(A, 0, smem);
    for (int c = threadIdx.x; c < V.cells(); c += COARSE_THREADS<RES>) out[c] = xs[0][c];
  }
}

template <class T, bool RES>
__global__ void __launch_bounds__(COARSE_THREADS<RES>)
    mg_coarse_kernel(CoarseArgs<T> A, T* out, int pre, int post, int coarse_iters, float damp) {
  extern __shared__ __align__(16) unsigned char coarse_smem[];
  coarse_run<T, RES>(A, out, pre, post, coarse_iters, Ar<T>::of(damp), coarse_smem);
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

// The march of "mg_up": a column of 16 rows on a grid of 2^20 cells or more,
// else 8, and as few planes a block (at most UCX) as keep the blocks within
// UP_BLOCKS, one wave at two blocks an SM.
constexpr int UP_BLOCKS = 2 * 132;

template <class T>
int launch_up(const T* x, const T* ec, const T* b, const T* diag, const T* inv_diag,
              const T* fluid, const T* cu, const T* cv, const T* cw, T* out, int nx, int ny,
              int nz, float damp, float scale, void* stream) {
  const int cx = (nx + 1) / 2, cy = (ny + 1) / 2, cz = (nz + 1) / 2;
  const long long cells = (long long)nx * ny * nz;
  if (cells == 0) return 0;
  const int ty = cells >= (1 << 20) ? 16 : 8;
  const int columns = ((ny + ty - 1) / ty) * ((nz + UZ - 1) / UZ);
  const int chunks = max(1, UP_BLOCKS / columns);
  const int planes = max(1, min(UCX, (nx + chunks - 1) / chunks));
  const dim3 grid((nz + UZ - 1) / UZ, (ny + ty - 1) / ty, (nx + planes - 1) / planes);
  const Level<T> L = make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale);
  if (ty == 16)
    mg_up_kernel<T, 16><<<grid, 16 * UZ, 0, (cudaStream_t)stream>>>(L, x, ec, b, out, cx, cy, cz,
                                                                    planes, damp);
  else
    mg_up_kernel<T, 8><<<grid, 8 * UZ, 0, (cudaStream_t)stream>>>(L, x, ec, b, out, cx, cy, cz,
                                                                  planes, damp);
  return (int)cudaGetLastError();
}

// `smem_bytes` 0: route "device", the levels and `scratch` in device memory;
// else route "shared": the bytes the levels take resident, which must be
// (4 * sizeof(T) + 2) a cell of every level, and `scratch` is not read.
template <class T>
int launch_coarse(const T* b, const void* const* arrays, const int* dims, const float* scales,
                  int n, T* scratch, T* out, int pre, int post, int coarse_iters, float damp,
                  int smem_bytes, void* stream) {
  if (n < 1 || n > MAX_COARSE_LEVELS || pre < 1 || post < 1 || coarse_iters < 1 ||
      smem_bytes < 0 || (smem_bytes == 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  CoarseArgs<T> A;
  A.n = n;
  T* s = scratch;
  long long all = 0;
  for (int l = 0; l < n; ++l) {
    const void* const* a = arrays + 6 * l;
    const int nx = dims[3 * l], ny = dims[3 * l + 1], nz = dims[3 * l + 2];
    const long long cells = (long long)nx * ny * nz;
    CoarseLevel<T>& C = A.lv[l];
    C.op = make_level((const T*)a[0], (const T*)a[1], (const T*)a[2], (const T*)a[3],
                      (const T*)a[4], (const T*)a[5], nx, ny, nz, scales[l]);
    C.rz = 1.0f / (float)nz;
    C.ryz = 1.0f / (float)(ny * nz);
    C.b = l == 0 ? b : nullptr;
    C.xa = C.xb = nullptr;
    if (smem_bytes == 0) {
      C.xa = s;
      C.xb = s + cells;
      s += 2 * cells;
      if (l > 0) {
        C.b = s;
        s += cells;
      }
    }
    all += cells;
  }
  if (smem_bytes == 0) {
    mg_coarse_kernel<T, false><<<1, COARSE_THREADS<false>, 0, (cudaStream_t)stream>>>(
        A, out, pre, post, coarse_iters, damp);
    return (int)cudaGetLastError();
  }
  if (smem_bytes != all * (4 * (long long)sizeof(T) + 2)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      mg_coarse_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  mg_coarse_kernel<T, true><<<1, COARSE_THREADS<true>, smem_bytes, (cudaStream_t)stream>>>(
      A, out, pre, post, coarse_iters, damp);
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
// `b` and `out` have the first level's shape. `smem_bytes` > 0 keeps every
// level in shared memory (route "shared": the bytes, (4 * 4 + 2) a cell of
// every level; `scratch` may be null); 0 runs the passes in device memory
// (route "device"): `scratch` holds, level after level, xa and xb (a
// level's cells each) and, from the second level on, the level's b.
extern "C" int lf_mg_coarse(const float* b, const void* const* arrays, const int* dims,
                            const float* scales, int n, float* scratch, float* out, int pre,
                            int post, int coarse_iters, float damp, int smem_bytes,
                            void* stream) {
  return launch_coarse(b, arrays, dims, scales, n, scratch, out, pre, post, coarse_iters, damp,
                       smem_bytes, stream);
}

// bfloat16 ("mg16"): the same four entry points with every array, the
// scratch included, in bfloat16 (route "shared": (4 * 2 + 2) bytes a cell);
// `damp` is the bfloat16 damping weight.
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
                              int smem_bytes, void* stream) {
  return launch_coarse(b, arrays, dims, scales, n, scratch, out, pre, post, coarse_iters, damp,
                       smem_bytes, stream);
}
