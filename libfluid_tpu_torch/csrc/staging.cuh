// Contiguous ranges of float32 between device and shared memory, by all
// THREADS threads of a block: neighbouring threads on neighbouring addresses,
// 16 bytes a thread where `vec` says the device pointer is 16-byte aligned
// (the shared one always is) and the count allows, else 4 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

template <int THREADS>
__device__ __forceinline__ void stage_in(float* sm, const float* __restrict__ src, int count,
                                         bool vec) {
  if (vec && (count & 3) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* sm4 = reinterpret_cast<float4*>(sm);
    for (int i = threadIdx.x; i < count / 4; i += THREADS) sm4[i] = __ldg(src4 + i);
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) sm[i] = __ldg(src + i);
  }
}

template <int THREADS>
__device__ __forceinline__ void stage_out(float* __restrict__ dst, const float* sm, int count,
                                          bool vec) {
  if (vec && (count & 3) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4* sm4 = reinterpret_cast<const float4*>(sm);
    for (int i = threadIdx.x; i < count / 4; i += THREADS) dst4[i] = sm4[i];
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = sm[i];
  }
}

inline int aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
