// int8-weight matmul with per-column dequantization, on the tensor cores.
//
// Replaces the TPU kernel rnagan_tpu/ops/quant_matmul.py::pallas_int8_matmul
// (body _kernel):
//
//     out[n, m] = (sum_k bf16(x[n, k]) * bf16(w_q[k, m])) * scale[m] + bias[m]
//
// with a float32 sum. It serves the generator's 4x4 ConvTranspose head on the
// 1x1 noise map, a (N, 2048) @ (2048, 32768) product whose int8 weight is the
// largest read of the synthesis path.
//
// Arithmetic. bf16(x) rounds to nearest even (__float2bfloat16_rn); an int8
// value is exact in bf16, and the product of two bf16 values is exact in
// float32. So the kernel equals its plain PyTorch version up to the order of
// the sums. The epilogue is __fmul_rn then __fadd_rn, as `acc * scale + bias`
// is written, with no FMA contraction.
//
// Bound on the H100 at N = 128: 85,196,800 bytes (x read once, the int8
// weight, scale, bias, the float32 output written once) take 25.4 us at
// 3.35 TB/s; its 17.2 GFLOP take 17.4 us at the 989 TFLOP/s bf16 dense peak
// and 257 us at the 67 TFLOP/s float32 rate outside the tensor cores. Bytes
// bound it, but only the tensor cores keep the operations under the bytes.
//
// Design: a pre-pass rounds x to bf16 once, into a scratch buffer padded with
// zeros to whole tiles, so the product reads half the bytes of float32 x each
// time a block rereads it (from L2) and needs no mask along N or K. The
// product is a tiled GEMM: a block owns a 128 x 128 output tile (all N rows
// of a serving batch of up to 128, one 128-column strip of M) and walks K in
// steps of 32. Each step its 256 threads load the next bf16 x tile and int8
// weight tile into registers (16-byte loads, neighbouring threads on
// neighbouring addresses) while the 8 warps run the current step's products
// from shared memory with nvcuda::wmma bf16 16x16x16 fragments and float32
// accumulators; the weight widens int8 -> bf16 on its way into shared memory.
// Each weight byte leaves device memory once per 128 rows of N, blocks of one
// column strip are neighbours in the grid so a second row tile finds it in
// L2, and the float32 result is written once with scale and bias fused.
// Ragged M and K are masked; the weight is read 16 bytes at a time when M is
// a multiple of 16 and its pointer 16-byte aligned, byte by byte otherwise.
// wgmma, TMA and a deeper pipeline are left for a later redesign.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;  // rows of N per block; the wrapper pads x to it
constexpr int kBN = 128;  // columns of M per block
constexpr int kBK = 32;   // depth of one K step; the wrapper pads K to it
constexpr int kThreads = 256;
constexpr int kWarpRows = 32, kWarpCols = 64;  // 8 warps: 4 along N x 2 along M
constexpr int kFragM = kWarpRows / 16, kFragN = kWarpCols / 16;
constexpr int kLdA = kBK + 8;  // shared row pitches in bf16 elements: +16 bytes
constexpr int kLdB = kBN + 8;  // spreads ldmatrix rows over the banks

__global__ void to_bf16_padded(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                               int n, int k, int n_pad, int k_pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_pad * k_pad) return;
  const int r = (int)(i / k_pad), c = (int)(i % k_pad);
  xb[i] = __float2bfloat16_rn(r < n && c < k ? x[(long long)r * k + c] : 0.0f);
}

// four int8 in a word -> four bf16 (exact), as two bf16 pairs
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const float a = (float)(int8_t)(w & 0xff), b = (float)(int8_t)((w >> 8) & 0xff);
  const float c = (float)(int8_t)((w >> 16) & 0xff), d = (float)(int8_t)(w >> 24);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <bool kVecW>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ xb, int k_pad, const int8_t* __restrict__ wq,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ out, int n, int k, int m) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kLdB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;
  const int n0 = blockIdx.x * kBM, m0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // x tile: kBM x kBK bf16 = 512 chunks of 8 values, 2 a thread.
  // weight tile: kBK x kBN int8 = 256 chunks of 16 values, 1 a thread.
  const int b_row = tid / 8, b_col = (tid % 8) * 16;
  uint4 a_reg[2], b_reg;

  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads, r = chunk / 4, col = (chunk % 4) * 8;
      a_reg[c] = *reinterpret_cast<const uint4*>(xb + (long long)(n0 + r) * k_pad + k0 + col);
    }
    const int kk = k0 + b_row, mm = m0 + b_col;
    const int8_t* src = wq + (long long)kk * m + mm;
    if (kVecW) {
      b_reg = (kk < k && mm < m) ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (kk < k) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (mm + e < m) w[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
      }
      b_reg = make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads, r = chunk / 4, col = (chunk % 4) * 8;
      *reinterpret_cast<uint4*>(&As[r * kLdA + col]) = a_reg[c];
    }
    const uint2 p0 = widen4(b_reg.x), p1 = widen4(b_reg.y), p2 = widen4(b_reg.z), p3 = widen4(b_reg.w);
    uint4* dst = reinterpret_cast<uint4*>(&Bs[b_row * kLdB + b_col]);
    dst[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    dst[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  };

  const int k_tiles = k_pad / kBK;
  load(0);
  for (int t = 0; t < k_tiles; ++t) {
    __syncthreads();  // every warp is done reading the previous step's tiles
    store();
    __syncthreads();
    if (t + 1 < k_tiles) load((t + 1) * kBK);  // next step's loads fly during the products
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(a[i], &As[(wr * kWarpRows + i * 16) * kLdA + ks], kLdA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[ks * kLdB + wc * kWarpCols + j * 16], kLdB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: each warp stages one 16x16 fragment at a time in shared memory
  // (the x tile's space, free now) and writes it with scale and bias; a lane
  // owns one column, so a store instruction covers two 64-byte row segments
  __syncthreads();
  float* stage = reinterpret_cast<float*>(As) + warp * 256;
  const int col_in = lane % 16, row_in = lane / 16;
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = m0 + wc * kWarpCols + j * 16 + col_in;
      const int row0 = n0 + wr * kWarpRows + i * 16;
      if (col < m) {
        const float s = scale[col], b = bias[col];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = row_in + 2 * e;
          if (row0 + r < n)
            out[(long long)(row0 + r) * m + col] = __fadd_rn(__fmul_rn(stage[r * 16 + col_in], s), b);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x: (n, k) float32; xb: scratch of (round_up(n, 128), round_up(k, 32)) bf16;
// w_q: (k, m) int8; scale, bias: (m,) float32; out: (n, m) float32. All
// contiguous on one device; the Python wrapper checks it. Returns the
// cudaError_t of the launches.
extern "C" int rnagan_int8_matmul(const float* x, void* xb, const void* w_q, const float* scale,
                                  const float* bias, float* out, int n, int k, int m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = (n + kBM - 1) / kBM * kBM, k_pad = (k + kBK - 1) / kBK * kBK;
  __nv_bfloat16* xbf = static_cast<__nv_bfloat16*>(xb);
  const long long elems = (long long)n_pad * k_pad;
  to_bf16_padded<<<(unsigned int)((elems + 255) / 256), 256, 0, s>>>(x, xbf, n, k, n_pad, k_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_pad / kBM, (m + kBN - 1) / kBN);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  if (m % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(xbf, k_pad, w, scale, bias, out, n, k, m);
  } else {
    int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(xbf, k_pad, w, scale, bias, out, n, k, m);
  }
  return (int)cudaGetLastError();
}
