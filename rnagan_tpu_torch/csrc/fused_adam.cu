// Multi-tensor Adam (optax math), in place on every parameter of one model.
//
// Replaces the TPU kernel rnagan_tpu/ops/fused_adam.py::adam_update_flat
// (body _adam_kernel). For each element, with c1 = 1 - b1^t and c2 = 1 - b2^t
// computed on the host (float32 pow), given as launch arguments or, with
// corr != nullptr, read from corr[0], corr[1] in device memory (the TPU
// kernel's SMEM corr operand: a step captured in a CUDA graph reads each
// step's corrections from a table the host fills once). With corr_n == 3 the
// rate is read from corr[2] too (a schedule's rate for this step, the one
// optax computes inside the JAX step) instead of the lr argument; b1, b2,
// eps and wd stay launch arguments, static as in adam_update_flat:
//   mu = b1*mu + (1-b1)*g
//   nu = b2*nu + ((1-b2)*g)*g
//   u  = (mu/c1) / (sqrt(nu/c2) + eps)
//   u  = u + wd*p                    (optax.adamw's decoupled decay; only when wd != 0)
//   p  = p - lr * u
// in that order, each step rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: nvcc contracts nothing into an FMA), so the plain
// PyTorch version (kernels/fused_adam.py), a chain of separate tensor ops,
// gives the same bits. mu may be stored in bfloat16 (optax's mu_dtype): it is
// read into float32, updated and used in float32, and rounded to nearest even
// on store.
//
// Bound on the H100: Adam reads p, g, mu, nu and writes p, mu, nu, 28 bytes
// a parameter (24 with a bf16 mu), a few flops each: bandwidth work, far
// below the card's ridge point. The GAN training step's 156.55 M parameters
// move 4.383 GB, 1.3085 ms at 3.35 TB/s; ResNet50's 23.51 M (2 classes) move
// 658 MB, 0.1965 ms.
//
// With wd == 0 the kernel is instantiated without the decay term, so Adam's
// instruction sequence is the one it always was. optax.adamw adds wd*p to
// Adam's scaled update (add_decayed_weights), then scales by -lr
// (scale_by_learning_rate) and adds (apply_updates): p + (-lr)*u has the
// bits of p - lr*u.
//
// Design: one launch per model per optimizer step, over all its tensors,
// with no flat copy. The host packs a table of (p, g, mu, nu, numel) for up
// to kMaxTensors tensors into the kernel's parameter block (a
// __grid_constant__ struct, so no device allocation and no host-to-device
// copy; the table is rebuilt on every call because gradient tensors move
// between steps). CUDA 12.1 and later take up to 32,764 bytes of kernel
// parameters on Volta and later, so 512 rows fit: ResNet152 (467 tensors)
// steps in one launch. Each tensor is cut into chunks of kChunk elements;
// block b takes chunks b, b + gridDim.x, ... and finds its tensor by a
// binary search of the chunk prefix sums. Inside a chunk each thread moves
// 16-byte float4 (and 8-byte bf16x4) vectors when the tensor's pointers are
// aligned, and the ragged tail (tensors of 1 or 3 elements included) goes
// element by element.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 512;   // parameter block: 512 x 48 bytes + scalars < 32,764 bytes
constexpr int kThreads = 256;
constexpr long long kChunk = 16384;  // elements a block handles at once (16 float4 a thread)

struct AdamTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long n[kMaxTensors];
  long long chunk_start[kMaxTensors + 1];  // prefix sums of each tensor's chunk count
  int count;
};

struct AdamScalars {
  float lr, b1, b2, omb1, omb2, eps, c1, c2;  // omb = 1 - b, rounded from double on the host
  float wd;                                   // decoupled weight decay (AdamW), 0 for Adam
};

static_assert(sizeof(AdamTable) + sizeof(AdamScalars) <= 32764,
              "the kernel's parameter block exceeds CUDA's 32,764-byte limit");

template <bool kDecay>
__device__ __forceinline__ void adam_elem(float& p, float g, float& mu, float& nu,
                                          const AdamScalars& s) {
  mu = __fadd_rn(__fmul_rn(s.b1, mu), __fmul_rn(s.omb1, g));
  nu = __fadd_rn(__fmul_rn(s.b2, nu), __fmul_rn(__fmul_rn(s.omb2, g), g));
  float upd =
      __fdiv_rn(__fdiv_rn(mu, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.c2)), s.eps));
  if (kDecay) upd = __fadd_rn(upd, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

__device__ __forceinline__ float load1(const float* m) { return *m; }
__device__ __forceinline__ float load1(const __nv_bfloat16* m) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(*m)) << 16);
}
__device__ __forceinline__ void store1(float* m, float v) { *m = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* m, float v) { *m = __float2bfloat16_rn(v); }

__device__ __forceinline__ void load4(const float* m, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(m);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* m, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(m);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}
__device__ __forceinline__ void store4(float* m, const float v[4]) {
  *reinterpret_cast<float4*>(m) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* m, const float v[4]) {
  uint32_t h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
  *reinterpret_cast<uint2*>(m) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

template <typename MuT, bool kDecay>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const __grid_constant__ AdamTable t, const AdamScalars scalars,
                  const float* __restrict__ corr, int corr_n) {
  AdamScalars s = scalars;
  if (corr != nullptr) {
    s.c1 = corr[0];
    s.c2 = corr[1];
    if (corr_n == 3) s.lr = corr[2];
  }
  const long long total = t.chunk_start[t.count];
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    // the last tensor whose first chunk is at or before c (tensors of 0
    // elements share the next one's start and are passed over)
    int i = 0, hi = t.count - 1;
    while (i < hi) {
      const int mid = (i + hi + 1) >> 1;
      if (t.chunk_start[mid] <= c) i = mid; else hi = mid - 1;
    }
    const long long begin = (c - t.chunk_start[i]) * kChunk;
    const long long end = begin + kChunk < t.n[i] ? begin + kChunk : t.n[i];
    float* p = t.p[i];
    const float* g = t.g[i];
    MuT* mu = static_cast<MuT*>(t.mu[i]);
    float* nu = t.nu[i];
    const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(nu)) % 16 == 0) &&
                     reinterpret_cast<uintptr_t>(mu) % (4 * sizeof(MuT)) == 0;
    long long tail = begin;
    if (vec) {
      tail = begin + ((end - begin) & ~3LL);
      for (long long j = begin + 4LL * threadIdx.x; j < tail; j += 4LL * kThreads) {
        float4 pv = *reinterpret_cast<const float4*>(p + j);
        const float4 gv = *reinterpret_cast<const float4*>(g + j);
        float4 nv = *reinterpret_cast<const float4*>(nu + j);
        float m[4];
        load4(mu + j, m);
        adam_elem<kDecay>(pv.x, gv.x, m[0], nv.x, s);
        adam_elem<kDecay>(pv.y, gv.y, m[1], nv.y, s);
        adam_elem<kDecay>(pv.z, gv.z, m[2], nv.z, s);
        adam_elem<kDecay>(pv.w, gv.w, m[3], nv.w, s);
        *reinterpret_cast<float4*>(p + j) = pv;
        *reinterpret_cast<float4*>(nu + j) = nv;
        store4(mu + j, m);
      }
    }
    for (long long j = tail + threadIdx.x; j < end; j += kThreads) {
      float pj = p[j], mj = load1(mu + j), nj = nu[j];
      adam_elem<kDecay>(pj, g[j], mj, nj, s);
      p[j] = pj;
      nu[j] = nj;
      store1(mu + j, mj);
    }
  }
}

template <bool kDecay>
void launch(const AdamTable& t, const AdamScalars& s, const float* corr, int corr_n, int mu_bf16,
            unsigned int grid, cudaStream_t st) {
  if (mu_bf16)
    fused_adam_kernel<__nv_bfloat16, kDecay><<<grid, kThreads, 0, st>>>(t, s, corr, corr_n);
  else
    fused_adam_kernel<float, kDecay><<<grid, kThreads, 0, st>>>(t, s, corr, corr_n);
}

}  // namespace

// table: count rows of (p, g, mu, nu, numel) as 64-bit words, in host memory.
// mu_bf16: 0 when every mu is float32, 1 when every mu is bfloat16.
// corr: nullptr takes c1 and c2; else the kernel reads (c1, c2) from the
// first two of corr_n (2 or 3) float32 values in device memory, and with 3
// the rate from the third (lr is then not read).
// wd: optax.adamw's weight decay; 0 takes Adam's kernel.
extern "C" int rnagan_fused_adam(const unsigned long long* table, int count, int mu_bf16,
                                 float lr, float b1, float b2, float omb1, float omb2,
                                 float eps, float c1, float c2, const float* corr, int corr_n,
                                 float wd, void* stream) {
  if (count < 1 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  if (corr != nullptr && corr_n != 2 && corr_n != 3) return (int)cudaErrorInvalidValue;
  AdamTable t;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    const unsigned long long* row = table + 5 * i;
    t.p[i] = reinterpret_cast<float*>(row[0]);
    t.g[i] = reinterpret_cast<const float*>(row[1]);
    t.mu[i] = reinterpret_cast<void*>(row[2]);
    t.nu[i] = reinterpret_cast<float*>(row[3]);
    t.n[i] = static_cast<long long>(row[4]);
    t.chunk_start[i] = chunks;
    chunks += (t.n[i] + kChunk - 1) / kChunk;
  }
  for (int i = count; i < kMaxTensors; ++i) {
    t.p[i] = nullptr; t.g[i] = nullptr; t.mu[i] = nullptr; t.nu[i] = nullptr; t.n[i] = 0;
    t.chunk_start[i] = chunks;
  }
  t.chunk_start[count] = chunks;
  t.chunk_start[kMaxTensors] = chunks;
  t.count = count;
  if (chunks == 0) return 0;
  const AdamScalars s{lr, b1, b2, omb1, omb2, eps, c1, c2, wd};
  const unsigned int grid = chunks < 65535 ? (unsigned int)chunks : 65535u;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wd != 0.0f)
    launch<true>(t, s, corr, corr_n, mu_bf16, grid, st);
  else
    launch<false>(t, s, corr, corr_n, mu_bf16, grid, st);
  return (int)cudaGetLastError();
}
