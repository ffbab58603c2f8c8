// Kernel B: P2G face sums from the slot grid.
//
// Replaces libfluid_tpu/sim/kernels.py:_p2g_kernel (launched through
// p2g_lo_faces_pallas), together with the jnp hi-plane pass
// transfers._p2g_hi_plane that completes it. Computes, for every face of
// u (nx+1, ny, nz), v (nx, ny+1, nz) and w (nx, ny, nz+1), the UNNORMALIZED
// APIC momentum  sum m * W * (v_a + A_a . (x_face - x_p))  and weight
// sum m * W over the K slots of the cells in the face's staggered support,
// W the trilinear hat in cell units. The caller adds the overflow particles
// and normalizes.
//
// Gather form: one thread per point (i, j, l) of the (nx+1, ny+1, nz+1)
// lattice computes the lo faces of cell (i, j, l) along each axis that has
// one there. The face along axis a sums the cells b = f - d with d_a in
// {0, 1} and the two transverse d in {-1, 0, 1} (18 cells); the thread
// walks the 27 cells around it once and feeds each face from the cells in
// its support, so each slot is read once per thread. No atomics: the result
// is the same from run to run.
//
// Bound: memory traffic of the slot payload (16 x K x C floats, 1.6 GB at
// 128^3 / K=12) re-read by up to 27 neighbouring threads; neighbouring
// threads read neighbouring addresses (z fastest), so the re-reads hit the
// caches. Empty slots (mask 0) are skipped after one load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float hat(float t) { return fmaxf(1.0f - fabsf(t), 0.0f); }

__global__ void p2g_kernel(const float* __restrict__ data, float* __restrict__ num_u,
                           float* __restrict__ num_v, float* __restrict__ num_w,
                           float* __restrict__ den_u, float* __restrict__ den_v,
                           float* __restrict__ den_w, int K, int nx, int ny, int nz,
                           float h, float ox, float oy, float oz, int use_affine) {
  const long long ex = nx + 1, ey = ny + 1, ez = nz + 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ex * ey * ez) return;
  const int l = (int)(t % ez);
  const int j = (int)((t / ez) % ey);
  const int i = (int)(t / (ez * ey));
  const bool has_u = j < ny && l < nz;
  const bool has_v = i < nx && l < nz;
  const bool has_w = i < nx && j < ny;

  const long long C = (long long)nx * ny * nz;
  const long long col = (long long)K * C;  // stride between payload columns
  const float fi = (float)i, fj = (float)j, fl = (float)l;
  // world coordinates of the three faces' centres
  const float xi = fi * h + ox, yj = fj * h + oy, zl = fl * h + oz;
  const float xc = (fi + 0.5f) * h + ox, yc = (fj + 0.5f) * h + oy, zc = (fl + 0.5f) * h + oz;

  float nu = 0.f, du = 0.f, nv = 0.f, dv = 0.f, nw = 0.f, dw = 0.f;
  for (int dx = -1; dx <= 1; ++dx) {
    const int bx = i + dx;
    if (bx < 0 || bx >= nx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int by = j + dy;
      if (by < 0 || by >= ny) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int bz = l + dz;
        if (bz < 0 || bz >= nz) continue;
        // a face along axis a reaches cells b with b_a in {f_a - 1, f_a}
        const bool cu = has_u && dx != 1;
        const bool cv = has_v && dy != 1;
        const bool cw = has_w && dz != 1;
        if (!(cu || cv || cw)) continue;
        const long long cell = ((long long)bx * ny + by) * nz + bz;
        for (int k = 0; k < K; ++k) {
          const long long s = (long long)k * C + cell;
          const float m = data[3 * col + s];
          if (m == 0.0f) continue;
          const float px = data[s], py = data[col + s], pz = data[2 * col + s];
          const float gx = (px - ox) / h, gy = (py - oy) / h, gz = (pz - oz) / h;
          if (cu) {
            const float w = m * hat(gx - fi) * hat(gy - 0.5f - fj) * hat(gz - 0.5f - fl);
            float val = data[4 * col + s];
            if (use_affine) {
              val = val + data[7 * col + s] * (xi - px) + data[8 * col + s] * (yc - py) +
                    data[9 * col + s] * (zc - pz);
            }
            nu += w * val;
            du += w;
          }
          if (cv) {
            const float w = m * hat(gx - 0.5f - fi) * hat(gy - fj) * hat(gz - 0.5f - fl);
            float val = data[5 * col + s];
            if (use_affine) {
              val = val + data[10 * col + s] * (xc - px) + data[11 * col + s] * (yj - py) +
                    data[12 * col + s] * (zc - pz);
            }
            nv += w * val;
            dv += w;
          }
          if (cw) {
            const float w = m * hat(gx - 0.5f - fi) * hat(gy - 0.5f - fj) * hat(gz - fl);
            float val = data[6 * col + s];
            if (use_affine) {
              val = val + data[13 * col + s] * (xc - px) + data[14 * col + s] * (yc - py) +
                    data[15 * col + s] * (zl - pz);
            }
            nw += w * val;
            dw += w;
          }
        }
      }
    }
  }
  if (has_u) {
    const long long f = ((long long)i * ny + j) * nz + l;
    num_u[f] = nu;
    den_u[f] = du;
  }
  if (has_v) {
    const long long f = ((long long)i * (ny + 1) + j) * nz + l;
    num_v[f] = nv;
    den_v[f] = dv;
  }
  if (has_w) {
    const long long f = ((long long)i * ny + j) * (nz + 1) + l;
    num_w[f] = nw;
    den_w[f] = dw;
  }
}

}  // namespace

// data: (16, K, nx, ny, nz) f32 slot payload; outputs: the six face arrays.
extern "C" int lf_p2g(const float* data, float* num_u, float* num_v, float* num_w,
                      float* den_u, float* den_v, float* den_w, int K, int nx, int ny,
                      int nz, float h, float ox, float oy, float oz, int use_affine,
                      void* stream) {
  const long long total = (long long)(nx + 1) * (ny + 1) * (nz + 1);
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  p2g_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      data, num_u, num_v, num_w, den_u, den_v, den_w, K, nx, ny, nz, h, ox, oy, oz,
      use_affine);
  return (int)cudaGetLastError();
}
