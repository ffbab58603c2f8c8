// Kernel A: slot-grid expand.
//
// Replaces libfluid_tpu/sim/slotsort.py:_expand_kernel (launched through
// _expand_impl). The TPU kernel expands the rank-major sorted payload into
// the slot grid with a log-step masked lane shift, because a gather is slow
// there. On Hopper the expand is the gather it stands for: slot
// j = rank * num_c + cell reads sorted payload row ins[j] when the cell holds
// more than `rank` particles, and 0 otherwise.
//
// Bound: device-memory bandwidth (16 x 4 B read and written per slot, no
// arithmetic). One thread per slot j: the 16 column writes are coalesced
// across j, and the reads are nearly so because ins[j] is non-decreasing
// in j within a rank segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 16;  // payload columns (slots.WIDTH)

__global__ void expand_kernel(const float* __restrict__ payT,
                              const int* __restrict__ ins,
                              const int* __restrict__ counts,
                              float* __restrict__ out, long long pay_stride,
                              int num_c, long long total) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int rank = (int)(j / num_c);
  const int cell = (int)(j - (long long)rank * num_c);
  const bool valid = counts[cell] > rank;
  const long long src = valid ? (long long)ins[j] : 0;
#pragma unroll
  for (int c = 0; c < kWidth; ++c) {
    out[c * total + j] = valid ? payT[c * pay_stride + src] : 0.0f;
  }
}

}  // namespace

// payT: (16, pay_stride) f32; ins: (k * num_c,) i32; counts: (num_c,) i32;
// out: (16, k * num_c) f32.
extern "C" int lf_expand(const float* payT, const int* ins, const int* counts,
                         float* out, long long pay_stride, int k, int num_c,
                         void* stream) {
  const long long total = (long long)k * num_c;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      payT, ins, counts, out, pay_stride, num_c, total);
  return (int)cudaGetLastError();
}
