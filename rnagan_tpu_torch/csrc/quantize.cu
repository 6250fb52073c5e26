// Fused serving egress: tanh -> [0, 1] -> uint8, NCHW float32 in, NHWC uint8 out.
//
// Replaces the TPU kernel rnagan_tpu/ops/quantize.py::pallas_tanh_to_uint8
// (body _quant_kernel): q = trunc(clip((tanh(x) * 0.5 + 0.5) * 255 + 0.5, 0, 255)),
// round half up like the Pallas kernel (not the half-to-even of
// xla_tanh_to_uint8). The generator writes torch's NCHW; the JAX package's
// egress layout is NHWC, so the transpose is fused into the same pass.
//
// Bound on the H100: at N=128, 3x256x256 it reads 100.7 MB of float32 and
// writes 25.2 MB of uint8: 37.6 us at 3.35 TB/s; the arithmetic (one tanhf
// and five flops an element) is far below the float32 rate. Bytes bound it.
// Design: one thread per 4 neighbouring pixels of one image. It reads a
// float4 from each of the 3 channel planes (16-byte loads, neighbouring
// threads on neighbouring addresses) and writes the 12 output bytes as 3
// aligned 32-bit words, so no byte-wide stores and no shared-memory
// transpose. Each value is read once and written once. The arithmetic uses
// __fmul_rn/__fadd_rn, so no FMA contraction moves a value across a rounding
// boundary relative to the plain PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 3;  // RGB: the generator's out_channels

__device__ __forceinline__ uint32_t quantize(float v) {
  const float t = tanhf(v);
  const float x01 = __fadd_rn(__fmul_rn(t, 0.5f), 0.5f);
  const float s = fminf(fmaxf(__fadd_rn(__fmul_rn(x01, 255.0f), 0.5f), 0.0f), 255.0f);
  return (uint32_t)(int)s;
}

__global__ void __launch_bounds__(kThreads)
tanh_to_uint8_kernel(const float* __restrict__ x, uint32_t* __restrict__ out, int n, int hw) {
  const int quads = hw / 4;  // 4-pixel groups per image
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)n * quads) return;
  const long long img = g / quads;
  const int p = (int)(g - img * quads) * 4;

  uint32_t q[4 * kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(x + (img * kC + c) * hw + p);
    q[0 * kC + c] = quantize(v.x);
    q[1 * kC + c] = quantize(v.y);
    q[2 * kC + c] = quantize(v.z);
    q[3 * kC + c] = quantize(v.w);
  }
  // bytes (img, p..p+3, 0..2) are contiguous and start at a multiple of 12
  uint32_t* dst = out + ((img * hw + p) * kC) / 4;
#pragma unroll
  for (int w = 0; w < kC; ++w) {
    dst[w] = q[4 * w] | (q[4 * w + 1] << 8) | (q[4 * w + 2] << 16) | (q[4 * w + 3] << 24);
  }
}

}  // namespace

// x: (n, 3, hw) float32, 16-byte aligned, hw % 4 == 0; out: (n, hw, 3) uint8,
// 4-byte aligned. The Python wrapper checks all of it. Returns the cudaError_t.
extern "C" int rnagan_tanh_to_uint8(const float* x, void* out, int n, int hw, void* stream) {
  const long long work = (long long)n * (hw / 4);
  const unsigned int blocks = (unsigned int)((work + kThreads - 1) / kThreads);
  tanh_to_uint8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint32_t*>(out), n, hw);
  return (int)cudaGetLastError();
}
