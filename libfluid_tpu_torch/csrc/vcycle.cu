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
//                   neighbours and no intermediate is stored (float32; the
//                   bfloat16 instance marches, below).
//   lf_mg_restrict  fine level, down leg: the residual (b - A x) * fluid,
//                   then R = P^T/8 with the separable weights (1/4, 3/4,
//                   3/4, 1/4) and the edge fold, masked by the coarse fluid.
//                   A block marches a column of coarse cells along x: x is
//                   staged once into a ring of planes in shared memory, the
//                   residual is formed once a point and kept in registers,
//                   and R runs as three passes of rows (x, y, then z), each
//                   row formed once. The residual never reaches device
//                   memory. No atomics.
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
// four stages with bfloat16 storage: every array, the shared-memory tiles
// and the coarse kernel's scratch hold bfloat16, and every arithmetic result
// is rounded to bfloat16 (round to nearest even) where PyTorch's bfloat16
// operations round it, in the plain version's order, as kernel "stencil16"
// (csrc/stencil.cu) does for one pass. Each stage is one template in two
// instances, except the pre-sweeps: lf_mg16_pre marches a column along x
// as lf_mg_up does and forms the first sweep's x1 once a point
// (mg_pre_march), where lf_mg_pre keeps a thread a cell (mg_pre_kernel,
// float32 code only), which is faster in float32. mg_pre_march and
// mg_restrict_march compute in the card's own
// arithmetic of the storage type (Hw: in bfloat16 the bfloat16 multiply,
// add and subtract); mg_up and mg_coarse in Ar (sums in float32).
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

// A value of the storage type as float (the coarse kernel's mask words).
template <class T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float ld(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
};

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

__device__ __forceinline__ int cell_index(const Level<float>& L, int i, int j, int k) {
  return (i * L.ny + j) * L.nz + k;
}

// A x at cell (i, j, k) of a float32 level, inside the grid; xf(i, j, k)
// gives x at a cell inside the grid, xc is x at the cell itself.
// scale * (diag * (x * fluid) - nbr) * fluid, neighbours in the order of the
// plain version's slice adds (nbr starts at 0).
template <class XF>
__device__ __forceinline__ float apply_at(const Level<float>& L, int i, int j, int k, float xc,
                                          float f, XF xf) {
  const int c = cell_index(L, i, j, k);
  const int syz = L.ny * L.nz;
  const int fu = c;                                  // u face i of the cell
  const int fv = (i * (L.ny + 1) + j) * L.nz + k;    // v face j
  const int fw = (i * L.ny + j) * (L.nz + 1) + k;    // w face k
  float nbr = 0.0f;
  if (i > 0) nbr = nbr + L.cu[fu] * xf(i - 1, j, k);
  if (i < L.nx - 1) nbr = nbr + L.cu[fu + syz] * xf(i + 1, j, k);
  if (j > 0) nbr = nbr + L.cv[fv] * xf(i, j - 1, k);
  if (j < L.ny - 1) nbr = nbr + L.cv[fv + L.nz] * xf(i, j + 1, k);
  if (k > 0) nbr = nbr + L.cw[fw] * xf(i, j, k - 1);
  if (k < L.nz - 1) nbr = nbr + L.cw[fw + 1] * xf(i, j, k + 1);
  return L.scale * (L.diag[c] * (xc * f) - nbr) * f;
}

// x + damp * inv_diag * (b - A x)
template <class XF>
__device__ __forceinline__ float jacobi_at(const Level<float>& L, const float* b, int i, int j,
                                           int k, float xc, float damp, XF xf) {
  const int c = cell_index(L, i, j, k);
  const float ax = apply_at(L, i, j, k, xc, L.fluid[c], xf);
  return xc + damp * L.inv_diag[c] * (b[c] - ax);
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
// lf_mg_pre: x = (two damped-Jacobi sweeps from 0) * fluid, float32
// ---------------------------------------------------------------------------

__global__ void mg_pre_kernel(Level<float> L, const float* __restrict__ b,
                              float* __restrict__ out, float damp) {
  const int total = L.nx * L.ny * L.nz;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= total) return;
  const int k = c % L.nz;
  const int j = (c / L.nz) % L.ny;
  const int i = c / (L.ny * L.nz);
  // the first sweep from x = 0: 0 + damp * inv_diag * (b - 0)
  auto x1 = [&](int a, int bb, int cc) {
    const int n = cell_index(L, a, bb, cc);
    return damp * L.inv_diag[n] * b[n];
  };
  const float x1c = x1(i, j, k);
  out[c] = jacobi_at(L, b, i, j, k, x1c, damp, x1) * L.fluid[c];
}

// ---------------------------------------------------------------------------
// Arithmetic on the storage type's own values (lf_mg_up, lf_mg_coarse)
// ---------------------------------------------------------------------------
//
// float for float32. For bfloat16 the values stay __nv_bfloat16: a product
// of two bfloat16 values is exact in float32, so the card's bfloat16
// multiply, which rounds once, gives PyTorch's product; a sum or difference
// is formed in float32 and rounded once to bfloat16, as PyTorch does (the
// card's bfloat16 add gives the same bits, Hw below; lf_mg16_up and
// lf_mg16_coarse have not moved to it). Every constant used here (0.75,
// 0.25, 0.125, 4^-l, the bfloat16 damping weight) is exact in the storage
// type.

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

// The card's own arithmetic of the storage type (mg_pre_march,
// mg_restrict_march): for bfloat16 its bfloat16 multiply, add and subtract.
// Each rounds the exact result once, as PyTorch's bfloat16 operations do: a
// sum or difference of two bfloat16 values rounded to float32's 24 bits
// (>= 2 * 8 + 2) and then to bfloat16 has the bits of one rounding.
// chip_smoke.py holds the three and their paired forms against one rounding
// of the float32 result over all 2^32 pairs (csrc/bf16_check.cu), and
// tests/test_torch_bf16_rounding.py PyTorch's against one rounding of the
// exact result. Not fused: the file is built with -fmad=false.
template <class T>
struct Hw : Ar<T> {};

template <>
struct Hw<__nv_bfloat16> : Ar<__nv_bfloat16> {
  using B = __nv_bfloat16;
  static __device__ __forceinline__ B add(B a, B b) { return __hadd(a, b); }
  static __device__ __forceinline__ B sub(B a, B b) { return __hsub(a, b); }
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

template <int TY, int TZ = UZ>
struct UpTile {
  static constexpr int NT = TY * TZ;                  // threads, one per cell of the column
  static constexpr int R0Y = TY + 4, R0Z = TZ + 4;    // x0: the column + 2
  static constexpr int R1Y = TY + 2, R1Z = TZ + 2;    // s1: the column + 1
  static constexpr int EX = UCX / 2 + 5, EY = TY / 2 + 4, EZ = TZ / 2 + 4;  // the coarse region
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

// apply_at on a cell whose operator is `o`, x at the cell xc and at its
// neighbours below and above along x, y and z, in the arithmetic A.
template <class T, class A = Ar<T>>
__device__ __forceinline__ T ax_at(const CellOp<T>& o, T xc, T xm, T xp, T ym, T yp, T zm, T zp,
                                   T scale) {
  T nbr = A::add0(A::mul(o.cul, xm));
  nbr = A::add(nbr, A::mul(o.cuh, xp));
  nbr = A::add(nbr, A::mul(o.cvl, ym));
  nbr = A::add(nbr, A::mul(o.cvh, yp));
  nbr = A::add(nbr, A::mul(o.cwl, zm));
  nbr = A::add(nbr, A::mul(o.cwh, zp));
  return A::mul(A::mul(scale, A::sub(A::mul(o.d, A::mul(xc, o.f)), nbr)), o.f);
}

// jacobi_at on a cell whose operator is `o`, x as for ax_at.
template <class T, class A = Ar<T>>
__device__ __forceinline__ T sweep_at(const CellOp<T>& o, T xc, T xm, T xp, T ym, T yp, T zm,
                                      T zp, T scale, T damp) {
  const T ax = ax_at<T, A>(o, xc, xm, xp, ym, yp, zm, zp, scale);
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

// One axis of R's transpose-of-prolongation, in the arithmetic A: coarse
// row J of nc from the fine rows f0 = F[2J-1], f1 = F[2J], f2 = F[2J+1], f3
// = F[2J+2] (rows outside the padded fine axis are not read), edge fold
// included, in the plain version's order of adds.
template <class T, class A = Ar<T>>
__device__ __forceinline__ T restrict_row(T f0, T f1, T f2, T f3, int J, int nc) {
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
        v[bb] = restrict_row<T>(rf(0, bb), rf(1, bb), rf(2, bb), rf(3, bb), ci, cx);
      rxy[t] = restrict_row<T>(v[0], v[1], v[2], v[3], cj, cy);
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
      N.b[cc] = R::mul(R::mul(restrict_row<T>(w[0], w[1], w[2], w[3], ck, cz), R::of(0.125f)),
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

// ---------------------------------------------------------------------------
// lf_mg16_pre: x = (two damped-Jacobi sweeps from 0) * fluid, marching
// ---------------------------------------------------------------------------
//
// A block owns a column of TY x TZ cells in (y, z) and marches along x over
// `planes` planes. The first sweep from x = 0 is pointwise, x1 = damp *
// inv_diag * b, and is formed once a point: on the column + 1, a plane at a
// time, into a ring of three planes in shared memory. The second sweep of
// plane q - 1 reads its neighbours' x1 along y and z from the ring and
// along x from the thread's registers (x1 of its cell at planes q - 2, q -
// 1, q). A thread loads b and inv_diag of its cell once, for x1, and keeps
// them for the sweep of that plane; the face of cu between two planes is
// loaded once; each iteration issues the next one's loads before it uses
// its own. One barrier a plane: with three slots, plane q's x1 is written
// while no thread can still read the slot it takes.

// The loads of one iteration of mg_pre_march, q: b and inv_diag of plane q
// at the thread's cell and ring point, the u face below plane q, and the
// rest of the operator of the cell at plane q - 1.
template <class T>
struct PreLoads {
  T b, inv, br, ir, cu, d, f, cvl, cvh, cwl, cwh;
};

template <class T, int TY, int TZ>
__global__ void __launch_bounds__(TY * TZ, 2) mg_pre_march(Level<T> L, const T* __restrict__ b,
                                                         T* __restrict__ out, int planes,
                                                         float damp_f) {
  using U = UpTile<TY, TZ>;
  using A = Hw<T>;
  __shared__ T s1[3][U::R1Y * U::R1Z];  // x1 on the column + 1, three planes
  const int tid = threadIdx.x;
  const int nx = L.nx, ny = L.ny, nz = L.nz, syz = ny * nz;
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, xa = blockIdx.z * planes;
  const int xe = min(xa + planes, nx);  // output planes [xa, xe)
  const T zero = A::of(0.0f), scale = A::of(L.scale), damp = A::of(damp_f);
  // the thread's cell of the column and, for the last H1 threads, a point of
  // the ring around it
  const int ty = tid / TZ, tz = tid - ty * TZ;
  const bool has_ring = tid >= U::NT - U::H1;
  SweepPoint sw[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    int ly = ty + 1, lz = tz + 1;
    if (a == 1) ring_point(has_ring ? tid - (U::NT - U::H1) : 0, U::R1Y, U::R1Z, 1, &ly, &lz);
    const int j = y0 - 1 + ly, k = z0 - 1 + lz;
    SweepPoint& S = sw[a];
    S.in = j >= 0 && j < ny && k >= 0 && k < nz;
    S.g = j * nz + k;
    S.gw = j * (nz + 1) + k;
    S.c0 = 0;
    S.c1 = ly * U::R1Z + lz;
  }
  const SweepPoint& S = sw[0];
  auto load = [&](int q) {  // 0 where a value is outside the grid or not needed
    PreLoads<T> v;
    v.b = v.inv = v.br = v.ir = v.cu = v.d = v.f = v.cvl = v.cvh = v.cwl = v.cwh = zero;
    const bool q_in = q >= 0 && q < nx;
    const int p = q - 1;
    if (q_in && S.in) {
      v.b = b[q * syz + S.g];
      v.inv = L.inv_diag[q * syz + S.g];
    }
    if (q >= 0 && q <= nx && S.in) v.cu = L.cu[q * syz + S.g];
    if (has_ring && q_in && sw[1].in) {
      v.br = b[q * syz + sw[1].g];
      v.ir = L.inv_diag[q * syz + sw[1].g];
    }
    if (p >= xa && S.in) {
      const int fv = p * (syz + nz) + S.g;
      const int fw = p * (syz + ny) + S.gw;
      v.d = L.diag[p * syz + S.g];
      v.f = L.fluid[p * syz + S.g];
      v.cvl = L.cv[fv];
      v.cvh = L.cv[fv + nz];
      v.cwl = L.cw[fw];
      v.cwh = L.cw[fw + 1];
    }
    return v;
  };
  CellOp<T> o;  // the cell's operator at plane q - 1
  o.b = o.inv = o.d = o.f = o.cul = o.cuh = o.cvl = o.cvh = o.cwl = o.cwh = zero;
  T x1m = zero, x1c = zero;  // the cell's x1 at planes q - 2, q - 1
  int sm = 0, sc = 1, sq = 2;  // ring slots of planes q - 2, q - 1, q
  PreLoads<T> next = load(xa - 1);
  for (int q = xa - 1; q <= xe; ++q) {
    {  // the slot of plane q - 3 takes plane q
      const int t = sm;
      sm = sc;
      sc = sq;
      sq = t;
    }
    const PreLoads<T> v = next;
    if (q < xe) next = load(q + 1);
    const bool sweep = q - 1 >= xa && S.in;  // the sweep of plane p = q - 1
    o.cul = o.cuh;
    o.cuh = v.cu;
    o.d = v.d;
    o.f = v.f;
    o.cvl = v.cvl;
    o.cvh = v.cvh;
    o.cwl = v.cwl;
    o.cwh = v.cwh;
    // x1 of plane q (0 outside the grid)
    const T x1q = A::mul(A::mul(damp, v.inv), v.b);
    s1[sq][S.c1] = x1q;
    if (has_ring) s1[sq][sw[1].c1] = A::mul(A::mul(damp, v.ir), v.br);
    __syncthreads();
    // the second sweep of plane p, masked, out
    if (sweep) {
      const T* m = s1[sc];
      const T w = sweep_at<T, A>(o, x1c, x1m, x1q, m[S.c1 - U::R1Z], m[S.c1 + U::R1Z], m[S.c1 - 1],
                                 m[S.c1 + 1], scale, damp);
      out[(q - 1) * syz + S.g] = A::mul(w, o.f);
    }
    x1m = x1c;
    x1c = x1q;
    o.b = v.b;
    o.inv = v.inv;
  }
}

// ---------------------------------------------------------------------------
// lf_mg_restrict, lf_mg16_restrict: rc = R((b - A x) * fluid) * fluid_c,
// marching
// ---------------------------------------------------------------------------
//
// A block owns a column of TY/2 x UZ/2 coarse cells in (y, z), TY x UZ
// fine, and marches along x over `planes` coarse planes. Coarse plane I
// reads the fine residual planes 2I - 1 .. 2I + 2, so a step makes two new
// ones. x is staged once, on the fine column + 2, two planes a step, into a
// ring of four planes in shared memory. The residual is formed once a
// point, on the fine column + 1, from the staged x: a thread a point (the
// column's cells, then the ring's), so that no thread forms two while the
// others wait at the barrier, and a thread's operator for the two planes
// of a step fits its registers. Each thread keeps its point's residual at
// the four planes in registers, so that R along x is a row of registers,
// written once into shared memory. R along y reads those rows, and R along
// z, times 1/8 and fluid_c, writes rc: each row of the three passes is
// formed once, in restrict_row's order, as _restrict_axis runs the axes
// one after another. Two barriers a step: the z pass of coarse plane I
// runs in step I + 1, beside its residual. Each thread's points, and so
// its index math, are fixed for the march.

// The threads of mg_restrict_march<T, TY>: one a point of the fine column
// + 1 (the column's TY x UZ cells, then the H1 points of its ring), in
// whole warps, so that no thread forms the residual at two points.
template <int TY>
struct RestrictThreads {
  static constexpr int NT = (TY * UZ + UpTile<TY>::H1 + 31) / 32 * 32;
};

// Point h of the column + w of a TY x UZ column: its cells first, then the
// ring of width w; (ly, lz) in the region.
template <int TY>
__device__ __forceinline__ void column_point(int h, int w, int* ly, int* lz) {
  if (h < TY * UZ) {
    *ly = h / UZ + w;
    *lz = h - (h / UZ) * UZ + w;
  } else {
    ring_point(h - TY * UZ, TY + 2 * w, UZ + 2 * w, w, ly, lz);
  }
}

template <class T, int TY>
__global__ void __launch_bounds__(RestrictThreads<TY>::NT, 2)
    mg_restrict_march(Level<T> L, const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ fluid_c, T* __restrict__ rc, int cx, int cy, int cz,
                      int planes) {
  using U = UpTile<TY>;
  using A = Hw<T>;
  constexpr int NT = RestrictThreads<TY>::NT;
  constexpr int CY = TY / 2, CZ = UZ / 2;  // coarse cells of the column
  constexpr int X0 = U::R0Y * U::R0Z, R1 = U::R1Y * U::R1Z;
  static_assert(X0 <= 2 * NT && CY * U::R1Z <= NT, "two x points and a row a thread");
  __shared__ T sx[4][X0];                  // x on the column + 2, four planes
  __shared__ T sr[R1];                     // R along x, on the column + 1
  __shared__ T sy[CY * U::R1Z];            // R along x and y
  const int tid = threadIdx.x;
  const int nx = L.nx, ny = L.ny, nz = L.nz, syz = ny * nz;
  const int z0 = blockIdx.x * UZ, y0 = blockIdx.y * TY;
  const int ia = blockIdx.z * planes, ie = min(ia + planes, cx);  // coarse planes [ia, ie)
  const T zero = A::of(0.0f), scale = A::of(L.scale), k125 = A::of(0.125f);
  // (a) x: points tid and tid + NT of the column + 2
  struct XPoint {
    int g, sh;
    bool in;
  } xp[2];
  const int nxp = tid + NT < X0 ? 2 : 1;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    int ly, lz;
    column_point<TY>(a == 0 || nxp == 2 ? tid + a * NT : 0, 2, &ly, &lz);
    const int j = y0 - 2 + ly, k = z0 - 2 + lz;
    xp[a].in = j >= 0 && j < ny && k >= 0 && k < nz;
    xp[a].g = j * nz + k;
    xp[a].sh = ly * U::R0Z + lz;
  }
  // (b) the residual: point tid of the column + 1
  const bool has_r = tid < R1;
  SweepPoint P;
  {
    int ly, lz;
    column_point<TY>(has_r ? tid : 0, 1, &ly, &lz);
    const int j = y0 - 1 + ly, k = z0 - 1 + lz;
    P.in = has_r && j >= 0 && j < ny && k >= 0 && k < nz;
    P.g = j * nz + k;
    P.gw = j * (nz + 1) + k;
    P.c0 = (ly + 1) * U::R0Z + (lz + 1);
    P.c1 = ly * U::R1Z + lz;
  }
  // (c) R along y: coarse row yJ of the column, fine column yk of the region
  const bool has_y = tid < CY * U::R1Z;
  const int yj = tid / U::R1Z, yk = tid - yj * U::R1Z;
  const int yJ = y0 / 2 + yj;
  // (d) R along z: a coarse cell of the column
  const int zj = tid / CZ, zk = tid - zj * CZ;
  const int zJ = y0 / 2 + zj, zK = z0 / 2 + zk;
  const bool has_z = tid < CY * CZ && zJ < cy && zK < cz;

  auto load_x = [&](int p, T* v) {  // x of the thread's points at plane p, 0 outside the grid
    const bool in = p >= 0 && p < nx;
#pragma unroll
    for (int a = 0; a < 2; ++a) v[a] = a < nxp && in && xp[a].in ? x[p * syz + xp[a].g] : zero;
  };
  auto store_x = [&](int p, const T* v) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
      if (a < nxp) sx[p & 3][xp[a].sh] = v[a];
  };
  auto z_pass = [&](int I, T fc) {
    const T* w = sy + zj * U::R1Z + 2 * zk;
    rc[(I * cy + zJ) * cz + zK] =
        A::mul(A::mul(restrict_row<T, A>(w[0], w[1], w[2], w[3], zK, cz), k125), fc);
  };

  T r[4] = {zero, zero, zero, zero};  // the residual at fine planes 2s - 1 .. 2s + 2
  {
    T v0[2], v1[2];
    load_x(2 * ia - 2, v0);
    load_x(2 * ia - 1, v1);
    store_x(2 * ia - 2, v0);
    store_x(2 * ia - 1, v1);
  }
  // step s makes the residual of fine planes 2s + 1 and 2s + 2; from s = ia
  // on, R of coarse plane s
  for (int s = ia - 1; s < ie; ++s) {
    const int p1 = 2 * s + 1;
    // this step's loads: x of planes p1 + 1 and p1 + 2, the operator of the
    // residual point at planes p1 and p1 + 1, fluid_c of the z pass
    T v0[2], v1[2];
    load_x(p1 + 1, v0);
    load_x(p1 + 2, v1);
    CellOp<T> op[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p1 + h;
      op[h].b = op[h].d = op[h].f = zero;
      op[h].cul = op[h].cuh = op[h].cvl = op[h].cvh = op[h].cwl = op[h].cwh = zero;
      if (p >= 0 && p < nx && P.in) op[h] = load_op(L, b, p, P);
    }
    const bool zo = s > ia && has_z;  // the z pass of coarse plane s - 1
    const T fc = zo ? fluid_c[((s - 1) * cy + zJ) * cz + zK] : zero;
    store_x(p1 + 1, v0);
    store_x(p1 + 2, v1);
    __syncthreads();
    if (zo) z_pass(s - 1, fc);
    if (has_r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p1 + h;
        T v = zero;
        if (p >= 0 && p < nx && P.in) {
          const T* m = sx[p & 3];
          const T ax = ax_at<T, A>(op[h], m[P.c0], sx[(p - 1) & 3][P.c0], sx[(p + 1) & 3][P.c0],
                                   m[P.c0 - U::R0Z], m[P.c0 + U::R0Z], m[P.c0 - 1], m[P.c0 + 1],
                                   scale);
          v = A::mul(A::sub(op[h].b, ax), op[h].f);
        }
        r[2 + h] = v;
      }
      if (s >= ia) sr[P.c1] = restrict_row<T, A>(r[0], r[1], r[2], r[3], s, cx);
      r[0] = r[2];
      r[1] = r[3];
    }
    __syncthreads();
    if (s >= ia && has_y) {
      const T* col = sr + 2 * yj * U::R1Z + yk;
      sy[yj * U::R1Z + yk] = restrict_row<T, A>(col[0], col[U::R1Z], col[2 * U::R1Z],
                                                col[3 * U::R1Z], yJ, cy);
    }
  }
  __syncthreads();
  if (has_z) z_pass(ie - 1, fluid_c[((ie - 1) * cy + zJ) * cz + zK]);
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

// The launchers: lf_mg_pre's (float32 only), then those of both instances.

int launch_pre(const float* b, const float* diag, const float* inv_diag, const float* fluid,
               const float* cu, const float* cv, const float* cw, float* out, int nx, int ny,
               int nz, float damp, float scale, void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  mg_pre_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale), b, out, damp);
  return (int)cudaGetLastError();
}

// The marches of "mg16_pre" and "mg_restrict" / "mg16_restrict": "mg_up"'s
// columns (16 rows of fine cells on a grid of 2^20 cells or more, else 8;
// 32 cells along z), and for "mg16_pre" a column of 16 x 16 where nz <= 16;
// as many planes a block as keep the blocks within one wave: UP_BLOCKS
// blocks (two an SM) for the restriction, and for the pre-sweeps as many
// blocks as have the threads of UP_BLOCKS blocks of 512.
constexpr int UP_BLOCKS = 2 * 132;

// The planes a block marches over on a grid of n planes and `columns`
// columns: as few as keep the blocks within `blocks`.
inline int march_planes(int n, int columns, int blocks) {
  const int chunks = max(1, blocks / columns);
  return (n + chunks - 1) / chunks;
}

template <class T, int TY, int TZ>
void launch_pre_tile(const Level<T>& L, const T* b, T* out, float damp, void* stream) {
  const int columns = ((L.ny + TY - 1) / TY) * ((L.nz + TZ - 1) / TZ);
  const int planes = march_planes(L.nx, columns, UP_BLOCKS * 512 / (TY * TZ));
  const dim3 grid((L.nz + TZ - 1) / TZ, (L.ny + TY - 1) / TY, (L.nx + planes - 1) / planes);
  mg_pre_march<T, TY, TZ><<<grid, TY * TZ, 0, (cudaStream_t)stream>>>(L, b, out, planes, damp);
}

template <class T>
int launch_pre_march(const T* b, const T* diag, const T* inv_diag, const T* fluid, const T* cu,
                     const T* cv, const T* cw, T* out, int nx, int ny, int nz, float damp,
                     float scale, void* stream) {
  const long long cells = (long long)nx * ny * nz;
  if (cells == 0) return 0;
  const Level<T> L = make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale);
  if (nz <= 16)
    launch_pre_tile<T, 16, 16>(L, b, out, damp, stream);
  else if (cells >= (1 << 20))
    launch_pre_tile<T, 16, UZ>(L, b, out, damp, stream);
  else
    launch_pre_tile<T, 8, UZ>(L, b, out, damp, stream);
  return (int)cudaGetLastError();
}

template <class T>
int launch_restrict_march(const T* x, const T* b, const T* diag, const T* inv_diag,
                          const T* fluid, const T* cu, const T* cv, const T* cw, const T* fluid_c,
                          T* rc, int nx, int ny, int nz, float scale, void* stream) {
  const int cx = (nx + 1) / 2, cy = (ny + 1) / 2, cz = (nz + 1) / 2;
  const long long cells = (long long)nx * ny * nz;
  if (cells == 0) return 0;
  const int ty = cells >= (1 << 20) ? 16 : 8;
  const int ccy = ty / 2, ccz = UZ / 2;  // coarse cells of a column
  const int columns = ((cy + ccy - 1) / ccy) * ((cz + ccz - 1) / ccz);
  const int planes = march_planes(cx, columns, UP_BLOCKS);
  const dim3 grid((cz + ccz - 1) / ccz, (cy + ccy - 1) / ccy, (cx + planes - 1) / planes);
  const Level<T> L = make_level(diag, inv_diag, fluid, cu, cv, cw, nx, ny, nz, scale);
  if (ty == 16)
    mg_restrict_march<T, 16><<<grid, RestrictThreads<16>::NT, 0, (cudaStream_t)stream>>>(
        L, x, b, fluid_c, rc, cx, cy, cz, planes);
  else
    mg_restrict_march<T, 8><<<grid, RestrictThreads<8>::NT, 0, (cudaStream_t)stream>>>(
        L, x, b, fluid_c, rc, cx, cy, cz, planes);
  return (int)cudaGetLastError();
}

// The march of "mg_up": a column of 16 rows on a grid of 2^20 cells or more,
// else 8, and as few planes a block (at most UCX) as keep the blocks within
// UP_BLOCKS.
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
  return launch_restrict_march(x, b, diag, inv_diag, fluid, cu, cv, cw, fluid_c, rc, nx, ny, nz,
                               scale, stream);
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
  return launch_pre_march(b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, damp, scale,
                          stream);
}

extern "C" int lf_mg16_restrict(const __nv_bfloat16* x, const __nv_bfloat16* b,
                                const __nv_bfloat16* diag, const __nv_bfloat16* inv_diag,
                                const __nv_bfloat16* fluid, const __nv_bfloat16* cu,
                                const __nv_bfloat16* cv, const __nv_bfloat16* cw,
                                const __nv_bfloat16* fluid_c, __nv_bfloat16* rc, int nx, int ny,
                                int nz, float scale, void* stream) {
  return launch_restrict_march(x, b, diag, inv_diag, fluid, cu, cv, cw, fluid_c, rc, nx, ny, nz,
                               scale, stream);
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
