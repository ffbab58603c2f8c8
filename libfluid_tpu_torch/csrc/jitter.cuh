// The coincident-pair jitter of the position correction:
// libfluid_tpu_torch/sim/jitterhash.py's hash of (seed, global cell, slot,
// component) in uint32 arithmetic (logical shifts), for kernels E and E'.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t srl_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// jitterhash.jitter_value: the int32 hash bits scaled by 2^-31
__device__ __forceinline__ float jitter_value(uint32_t seed, int gx, int gy, int gz, int k,
                                              int c) {
  uint32_t t = (uint32_t)gx * 198491317u + (uint32_t)gy * 6542989u + (uint32_t)gz * 362437u +
               (uint32_t)k * 87178291u + (uint32_t)c * 1299709u;
  const uint32_t b = srl_mix(srl_mix(t ^ seed));
  return (float)(int32_t)b * (1.0f / 2147483648.0f);
}
