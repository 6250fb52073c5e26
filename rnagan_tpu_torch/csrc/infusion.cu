// Fused RNA-infusion noise: uniforms -> + z_mean -> batch standardization.
//
// Replaces the TPU kernel rnagan_tpu/ops/infusion.py::pallas_infused_noise
// (body _infusion_kernel). out = standardize(U(-r, r) + z) over the batch,
// per column, with the ddof=1 variance and +1e-12 inside the sqrt
// (losses/rna_infusion.py::standardize_batch). With pop_mean/pop_std given it
// normalizes with those population statistics instead
// (infused_noise_population: (u + z - pop_mean) / sqrt(pop_std^2 + var_u)).
//
// Uniforms come from one of two places:
//   * u != nullptr: read u[i, c], already scaled to [-r, r] (exact parity mode);
//   * u == nullptr: Philox4x32-10 (Random123), counter (row, col, 0, 0),
//     key (seed, 0); the top 24 bits of word 0 map to [0, 1), as the TPU
//     kernel maps its on-core random bits.
//
// Bound on the H100: at N=128, D=2048 it reads z (1 MiB) and writes out
// (1 MiB), 0.6 us at 3.35 TB/s, far under one launch: the kernel is
// launch-bound. Design: one block per strip of 32 columns; 8 warps split the
// rows of the strip, so a column's reduction is 8 partial sums combined in
// shared memory. Pass 1 writes x = u + z into out and sums it; pass 2 re-reads
// its own rows (L1/L2-resident) for the centered variance (no E[x^2]-E[x]^2);
// pass 3 normalizes in place. Each thread reads back only what it wrote.
// Loads and stores are coalesced along the column strip. No FMA contraction
// on the uniform mapping (__fmul_rn/__fadd_rn), so the kernel and the plain
// PyTorch version agree on every uniform bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;      // columns per block (one warp wide)
constexpr int kRowGroups = 8;  // warps per block, each over every 8th row

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1, uint32_t key0) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
  uint32_t c2 = 0u, c3 = 0u, k0 = key0, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) { k0 += W0; k1 += W1; }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  return c0;
}

__global__ void __launch_bounds__(kCols * kRowGroups)
infused_noise_kernel(const float* __restrict__ z, long long z_row_stride,
                     const float* __restrict__ u, const float* __restrict__ pop_mean,
                     const float* __restrict__ pop_std, float* __restrict__ out,
                     int n, int d, uint32_t seed, float noise_range, float var_u) {
  __shared__ float partial[kRowGroups][kCols];
  __shared__ float stat[kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const bool live = col < d;

  float sum = 0.f;
  if (live) {
    for (int i = ty; i < n; i += kRowGroups) {
      float ui;
      if (u != nullptr) {
        ui = u[(long long)i * d + col];
      } else {
        const float u01 = (float)(philox_word0((uint32_t)i, (uint32_t)col, seed) >> 8) *
                          (1.0f / 16777216.0f);
        ui = __fmul_rn(__fadd_rn(__fmul_rn(u01, 2.0f), -1.0f), noise_range);
      }
      const float x = __fadd_rn(ui, z[(long long)i * z_row_stride + col]);
      if (pop_mean != nullptr) {
        const float s = pop_std[col];
        out[(long long)i * d + col] =
            __fdiv_rn(__fsub_rn(x, pop_mean[col]), sqrtf(__fadd_rn(__fmul_rn(s, s), var_u)));
      } else {
        out[(long long)i * d + col] = x;
        sum += x;
      }
    }
  }
  if (pop_mean != nullptr) return;  // uniform across the block: no barrier is skipped unevenly

  partial[ty][tx] = sum;
  __syncthreads();
  if (ty == 0) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) s += partial[g][tx];
    stat[tx] = s / (float)n;
  }
  __syncthreads();
  const float mean = stat[tx];

  float sq = 0.f;
  if (live) {
    for (int i = ty; i < n; i += kRowGroups) {
      const float c = out[(long long)i * d + col] - mean;
      sq = __fmaf_rn(c, c, sq);
    }
  }
  __syncthreads();  // every read of stat[] (mean) is done before it is reused
  partial[ty][tx] = sq;
  __syncthreads();
  if (ty == 0) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) s += partial[g][tx];
    stat[tx] = sqrtf(s / fmaxf((float)(n - 1), 1.0f) + 1e-12f);
  }
  __syncthreads();
  const float denom = stat[tx];

  if (live) {
    for (int i = ty; i < n; i += kRowGroups) {
      const long long k = (long long)i * d + col;
      out[k] = __fdiv_rn(out[k] - mean, denom);
    }
  }
}

}  // namespace

extern "C" int rnagan_infused_noise(const float* z, long long z_row_stride, const float* u,
                                    const float* pop_mean, const float* pop_std, float* out,
                                    int n, int d, unsigned int seed, float noise_range,
                                    float var_u, void* stream) {
  const dim3 block(kCols, kRowGroups);
  const dim3 grid((d + kCols - 1) / kCols);
  infused_noise_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      z, z_row_stride, u, pop_mean, pop_std, out, n, d, seed, noise_range, var_u);
  return (int)cudaGetLastError();
}
