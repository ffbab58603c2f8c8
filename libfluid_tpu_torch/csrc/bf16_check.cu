// A check of the card's bfloat16 arithmetic, not a kernel of any path: over
// every ordered pair of bfloat16 bit patterns (a, b), the card's __hmul,
// __hadd and __hsub against __float2bfloat16_rn of the float32 product, sum
// and difference, and the paired forms __hmul2, __hadd2, __hsub2 on the
// pairs (a, b) and (b, a) in the two halves. A NaN matches any NaN; every
// other result must have the same bits, subnormals and signed zeros
// included. The fused V-cycle's mg16_pre and mg16_restrict (csrc/vcycle.cu)
// use the card's bfloat16 multiply, add and subtract in place of a float32
// operation rounded once; chip_smoke.py runs this check and fails on a
// mismatch in any of them.
//
// 2^32 pairs: a block per a (65536 blocks), its 256 threads over b, each
// thread's counts summed over the warp and added to `counts` by lane 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHECK_OPS = 6;  // hmul, hadd, hsub, hmul2, hadd2, hsub2

__device__ __forceinline__ bool is_nan(unsigned short v) { return (v & 0x7fffu) > 0x7f80u; }

// 1 unless `got` is `want` bit for bit, or both are NaN
__device__ __forceinline__ unsigned differs(__nv_bfloat16 got, __nv_bfloat16 want) {
  const unsigned short g = __bfloat16_as_ushort(got), w = __bfloat16_as_ushort(want);
  return (is_nan(g) && is_nan(w)) || g == w ? 0u : 1u;
}

__global__ void __launch_bounds__(256) bf16_check_kernel(unsigned long long* counts) {
  const __nv_bfloat16 a = __ushort_as_bfloat16((unsigned short)blockIdx.x);
  const float fa = __bfloat162float(a);
  unsigned n[CHECK_OPS] = {0, 0, 0, 0, 0, 0};
  for (unsigned bits = threadIdx.x; bits < 65536u; bits += blockDim.x) {
    const __nv_bfloat16 b = __ushort_as_bfloat16((unsigned short)bits);
    const float fb = __bfloat162float(b);
    const __nv_bfloat16 mul = __float2bfloat16_rn(fa * fb);
    const __nv_bfloat16 add = __float2bfloat16_rn(fa + fb);
    const __nv_bfloat16 sub = __float2bfloat16_rn(fa - fb);
    const __nv_bfloat16 bus = __float2bfloat16_rn(fb - fa);
    n[0] += differs(__hmul(a, b), mul);
    n[1] += differs(__hadd(a, b), add);
    n[2] += differs(__hsub(a, b), sub);
    const __nv_bfloat162 ab = __halves2bfloat162(a, b), ba = __halves2bfloat162(b, a);
    const __nv_bfloat162 m2 = __hmul2(ab, ba), a2 = __hadd2(ab, ba), s2 = __hsub2(ab, ba);
    n[3] += differs(__low2bfloat16(m2), mul) + differs(__high2bfloat16(m2), mul);
    n[4] += differs(__low2bfloat16(a2), add) + differs(__high2bfloat16(a2), add);
    n[5] += differs(__low2bfloat16(s2), sub) + differs(__high2bfloat16(s2), bus);
  }
#pragma unroll
  for (int op = 0; op < CHECK_OPS; ++op) {
    unsigned v = n[op];
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(counts + op, (unsigned long long)v);
  }
}

}  // namespace

// counts: 6 zeroed 64-bit counters on the card, the mismatches of __hmul,
// __hadd, __hsub, __hmul2, __hadd2 and __hsub2 (a paired form counts each
// half).
extern "C" int lf_bf16_check(unsigned long long* counts, void* stream) {
  bf16_check_kernel<<<65536, 256, 0, (cudaStream_t)stream>>>(counts);
  return (int)cudaGetLastError();
}
