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
//     kernel maps its on-core random bits. The seed is a launch argument, or
//     with seed_ptr != nullptr the low 32 bits of an int32 or int64 in device
//     memory (the TPU kernel's seed_ref in SMEM): a training step captured in
//     a CUDA graph reads each step's seed from a table the host fills once,
//     and draws the stream the same seed gives as an argument.
//
// Bound on the H100: at N=128, D=2048 it reads z (1 MiB) and writes out
// (1 MiB), 0.6 us at 3.35 TB/s, under the ~2 us of a launch replayed from a
// CUDA graph: the kernel is bound by latency, not bytes, so the design
// removes dependent steps.
//
// One-pass kernel (N <= 32 * 8 rows): a block owns a strip of 16 columns
// (128 blocks at D = 2048), 32 threads share a column and each keeps its
// R = 1, 2, 4 or 8 rows (a template parameter the wrapper picks from N) in
// registers: one read of z (and u), all R loads in flight at once; the
// column sum and then the centered sum of squares (two-pass variance, from
// registers, never E[x^2]-E[x]^2) each reduce by one warp shuffle (the two
// row groups of a warp share columns) and one shared-memory step over the 16
// warps; one write of out. Two block barriers in all. Seeded, the Philox
// draws are the kernel's largest cost: 32 threads a column (16 warps an SM)
// hide their dependent multiplies better than 16 (a chip call timed 16, 32
// and 64 at N = 128; 32 was fastest).
// Loop kernel (larger N): one block per strip of 32 columns, 8 warps over the
// rows; pass 1 writes x = u + z into out and sums it, pass 2 re-reads its own
// rows (L1/L2-resident) for the centered variance, pass 3 normalizes in place.
// Both sum x - z[0, col] and add z[0, col] back to the mean: in a column whose
// rows share one z (a patient broadcast over the batch), x - z is the small
// uniform, so the mean of a large, narrow column keeps its float32 digits.
// Both: loads and stores coalesced along the column strip; no FMA contraction
// on the uniform mapping (__fmul_rn/__fadd_rn), so the kernels and the plain
// PyTorch version agree on every uniform bit for bit.
//
// Group mode (the batch split over the ranks of a data group, each holding
// rows [row0, row0 + n) of a global batch): the standardization is over the
// global batch, which no one launch sees. The wrapper runs three launches of
// infused_noise_group with an all-reduce of a (D + 1,) float32 buffer after
// each of the first two (torch.distributed, between launches):
//   phase 0: x = u + z into out, the column sums of x into sums[0, D); the
//            wrapper has put this rank's row count in sums[D], so the
//            all-reduce gives the global count there too;
//   phase 1: mean = sums[c] / N, the centered sums sum((x - mean)^2) into sq;
//   phase 2: out = (x - mean) / sqrt(sq[c] / (N - 1) + 1e-12) in place.
// The same two-pass arithmetic as the one-device kernels, with the Philox
// counter (row0 + row, col, 0, 0): ranks that hold rows [row0, row0 + n)
// together draw the uniforms one device draws for the global batch. The
// loop kernel's layout: a block a strip of 32 columns, 8 warps over the
// rank's rows, the column sums through shared memory. Bound by latency (at
// the training batch a rank holds 4 rows); the one-device path never runs it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;      // loop kernel: columns per block (one warp wide)
constexpr int kRowGroups = 8;  // loop kernel: warps per block, each over every 8th row
constexpr int kStripCols = 16;   // one-pass kernel: columns per block
constexpr int kStripGroups = 32; // one-pass kernel: threads per column (512 a block)

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1, uint32_t key0) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
  uint32_t c2 = 0u, c3 = 0u, k0 = key0, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) { k0 += W0; k1 += W1; }
    const uint64_t p0 = (uint64_t)M0 * c0, p1 = (uint64_t)M1 * c2;  // one wide multiply each
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0, n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c0 = n0; c1 = (uint32_t)p1; c2 = n2; c3 = (uint32_t)p0;
  }
  return c0;
}

// the seed of this launch: the argument, or the int32/int64 at seed_ptr
__device__ __forceinline__ uint32_t launch_seed(uint32_t seed, const void* seed_ptr, int seed_bytes) {
  if (seed_ptr == nullptr) return seed;
  return seed_bytes == 8 ? (uint32_t)*static_cast<const long long*>(seed_ptr)
                         : *static_cast<const uint32_t*>(seed_ptr);
}

// the uniform of element (i, col): u's, or the Philox stream's scaled to [-r, r)
__device__ __forceinline__ float uniform(const float* __restrict__ u, int i, int col, int d, uint32_t seed,
                                         float noise_range) {
  if (u != nullptr) return u[(long long)i * d + col];
  const float u01 = (float)(philox_word0((uint32_t)i, (uint32_t)col, seed) >> 8) * (1.0f / 16777216.0f);
  return __fmul_rn(__fadd_rn(__fmul_rn(u01, 2.0f), -1.0f), noise_range);
}

template <int R>
__global__ void __launch_bounds__(kStripCols * kStripGroups)
infused_noise_onepass(const float* __restrict__ z, long long z_row_stride,
                      const float* __restrict__ u, const float* __restrict__ pop_mean,
                      const float* __restrict__ pop_std, float* __restrict__ out,
                      int n, int d, uint32_t seed_arg, const void* seed_ptr, int seed_bytes,
                      float noise_range, float var_u) {
  const uint32_t seed = launch_seed(seed_arg, seed_ptr, seed_bytes);
  constexpr int kWarps = kStripCols * kStripGroups / 32;
  __shared__ float part_sum[kWarps][kStripCols];
  __shared__ float part_sq[kWarps][kStripCols];
  const int tx = threadIdx.x % kStripCols, ty = threadIdx.x / kStripCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kStripCols + tx;
  const bool live = col < d;

  float v[R];
  float sum = 0.f;  // of v - shift (see the note at the top)
  const float shift = live ? z[col] : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {  // every load in flight before the Philox work starts
    const int i = ty + r * kStripGroups;
    v[r] = live && i < n ? z[(long long)i * z_row_stride + col] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + r * kStripGroups;
    if (live && i < n) {
      v[r] = __fadd_rn(uniform(u, i, col, d, seed, noise_range), v[r]);
      sum += v[r] - shift;
    }
  }
  if (pop_mean != nullptr) {  // uniform across the block: no barrier is skipped unevenly
    if (!live) return;
    const float s = pop_std[col];
    const float mu = pop_mean[col], den = sqrtf(__fadd_rn(__fmul_rn(s, s), var_u));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + r * kStripGroups;
      if (i < n) out[(long long)i * d + col] = __fdiv_rn(__fsub_rn(v[r], mu), den);
    }
    return;
  }

  // lanes tx and tx + 16 of a warp are row groups 2w and 2w+1 of one column
  sum += __shfl_xor_sync(0xffffffffu, sum, 16);
  if (lane < kStripCols) part_sum[warp][tx] = sum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part_sum[w][tx];
  const float mean = shift + total / (float)n;

  float sq = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + r * kStripGroups;
    if (live && i < n) {
      const float c = v[r] - mean;
      sq = __fmaf_rn(c, c, sq);
    }
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 16);
  if (lane < kStripCols) part_sq[warp][tx] = sq;
  __syncthreads();
  float total_sq = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total_sq += part_sq[w][tx];
  const float denom = sqrtf(total_sq / fmaxf((float)(n - 1), 1.0f) + 1e-12f);

  if (!live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + r * kStripGroups;
    if (i < n) out[(long long)i * d + col] = __fdiv_rn(v[r] - mean, denom);
  }
}

__global__ void __launch_bounds__(kCols * kRowGroups)
infused_noise_loop(const float* __restrict__ z, long long z_row_stride,
                   const float* __restrict__ u, const float* __restrict__ pop_mean,
                   const float* __restrict__ pop_std, float* __restrict__ out,
                   int n, int d, uint32_t seed_arg, const void* seed_ptr, int seed_bytes,
                   float noise_range, float var_u) {
  const uint32_t seed = launch_seed(seed_arg, seed_ptr, seed_bytes);
  __shared__ float partial[kRowGroups][kCols];
  __shared__ float stat[kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const bool live = col < d;

  float sum = 0.f;  // of x - shift (see the note at the top)
  const float shift = live ? z[col] : 0.f;
  if (live) {
    for (int i = ty; i < n; i += kRowGroups) {
      const float x = __fadd_rn(uniform(u, i, col, d, seed, noise_range), z[(long long)i * z_row_stride + col]);
      if (pop_mean != nullptr) {
        const float s = pop_std[col];
        out[(long long)i * d + col] =
            __fdiv_rn(__fsub_rn(x, pop_mean[col]), sqrtf(__fadd_rn(__fmul_rn(s, s), var_u)));
      } else {
        out[(long long)i * d + col] = x;
        sum += x - shift;
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
    stat[tx] = shift + s / (float)n;
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

__global__ void __launch_bounds__(kCols * kRowGroups)
infused_noise_group(const float* __restrict__ z, long long z_row_stride, const float* __restrict__ u,
                    float* __restrict__ out, float* __restrict__ sums, float* __restrict__ sq, int n, int d,
                    long long row0, uint32_t seed, float noise_range, int phase) {
  __shared__ float partial[kRowGroups][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const bool live = col < d;
  float acc = 0.f;
  if (phase == 0) {
    if (live) {
      for (int i = ty; i < n; i += kRowGroups) {
        float r;
        if (u != nullptr) {
          r = u[(long long)i * d + col];
        } else {
          const uint32_t row = (uint32_t)(row0 + i);
          const float u01 = (float)(philox_word0(row, (uint32_t)col, seed) >> 8) * (1.0f / 16777216.0f);
          r = __fmul_rn(__fadd_rn(__fmul_rn(u01, 2.0f), -1.0f), noise_range);
        }
        const float x = __fadd_rn(r, z[(long long)i * z_row_stride + col]);
        out[(long long)i * d + col] = x;
        acc += x;
      }
    }
  } else {
    const float count = sums[d];  // the global row count, all-reduced with the sums
    const float mean = live ? __fdiv_rn(sums[col], count) : 0.f;
    if (phase == 2) {
      if (!live) return;  // no barrier follows in this phase
      const float denom = sqrtf(__fadd_rn(__fdiv_rn(sq[col], fmaxf(__fsub_rn(count, 1.0f), 1.0f)), 1e-12f));
      for (int i = ty; i < n; i += kRowGroups) {
        const long long k = (long long)i * d + col;
        out[k] = __fdiv_rn(__fsub_rn(out[k], mean), denom);
      }
      return;
    }
    if (live) {
      for (int i = ty; i < n; i += kRowGroups) {
        const float c = __fsub_rn(out[(long long)i * d + col], mean);
        acc = __fmaf_rn(c, c, acc);
      }
    }
  }
  partial[ty][tx] = acc;  // phases 0 and 1: the column's sum over the row groups
  __syncthreads();
  if (ty == 0 && live) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) total += partial[g][tx];
    (phase == 0 ? sums : sq)[col] = total;
  }
}

template <int R>
void launch_onepass(const float* z, long long z_row_stride, const float* u, const float* pop_mean,
                    const float* pop_std, float* out, int n, int d, unsigned int seed, const void* seed_ptr,
                    int seed_bytes, float noise_range, float var_u, cudaStream_t s) {
  infused_noise_onepass<R><<<(d + kStripCols - 1) / kStripCols, kStripCols * kStripGroups, 0, s>>>(
      z, z_row_stride, u, pop_mean, pop_std, out, n, d, seed, seed_ptr, seed_bytes, noise_range, var_u);
}

}  // namespace

// rows_per_thread: 1, 2, 4 or 8 runs the one-pass kernel (n <= 32 *
// rows_per_thread), 0 the loop kernel (any n); the Python wrapper picks it.
// seed_ptr: nullptr takes seed; else the seed is read on the device from an
// integer of seed_bytes (4 or 8) bytes there.
extern "C" int rnagan_infused_noise(const float* z, long long z_row_stride, const float* u,
                                    const float* pop_mean, const float* pop_std, float* out,
                                    int n, int d, unsigned int seed, const void* seed_ptr,
                                    int seed_bytes, float noise_range, float var_u,
                                    int rows_per_thread, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_thread != 0 && n > kStripGroups * rows_per_thread) return (int)cudaErrorInvalidValue;
  if (seed_ptr != nullptr && seed_bytes != 4 && seed_bytes != 8) return (int)cudaErrorInvalidValue;
  switch (rows_per_thread) {
    case 0: {
      const dim3 block(kCols, kRowGroups);
      const dim3 grid((d + kCols - 1) / kCols);
      infused_noise_loop<<<grid, block, 0, s>>>(z, z_row_stride, u, pop_mean, pop_std, out, n, d, seed,
                                                seed_ptr, seed_bytes, noise_range, var_u);
      break;
    }
#define ONEPASS(R)                                                                                      \
  case R:                                                                                               \
    launch_onepass<R>(z, z_row_stride, u, pop_mean, pop_std, out, n, d, seed, seed_ptr, seed_bytes,     \
                      noise_range, var_u, s);                                                           \
    break;
    ONEPASS(1) ONEPASS(2) ONEPASS(4) ONEPASS(8)
#undef ONEPASS
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One phase (0, 1 or 2) of the group mode; see the note at the top.
extern "C" int rnagan_infused_noise_group(const float* z, long long z_row_stride, const float* u, float* out,
                                          float* sums, float* sq, int n, int d, long long row0,
                                          unsigned int seed, float noise_range, int phase, void* stream) {
  if (phase < 0 || phase > 2 || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  infused_noise_group<<<(d + kCols - 1) / kCols, dim3(kCols, kRowGroups), 0, s>>>(
      z, z_row_stride, u, out, sums, sq, n, d, row0, seed, noise_range, phase);
  return (int)cudaGetLastError();
}
