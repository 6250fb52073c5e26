// int8-weight matmul with per-column dequantization, on Hopper's tensor cores.
//
// Replaces the TPU kernel rnagan_tpu/ops/quant_matmul.py::pallas_int8_matmul
// (body _kernel):
//
//     out[n, m] = (sum_k bf16(x[n, k]) * bf16(w_q[k, m])) * scale[m] + bias[m]
//
// with a float32 sum. It serves the generator's 4x4 ConvTranspose head on the
// 1x1 noise map, a (N, 2048) @ (2048, 32768) product whose int8 weight (67 MB,
// more than the 50 MB L2) is the largest read of the synthesis path.
//
// Arithmetic. bf16(x) rounds to nearest even (__float2bfloat16_rn); an int8
// value is exact in bf16, and the product of two bf16 values is exact in
// float32. So each kernel equals its plain PyTorch version up to the order of
// the sums. The epilogue is __fmul_rn then __fadd_rn, as `acc * scale + bias`
// is written, with no FMA contraction.
//
// Bound on the H100 at N = 128: 85,196,800 bytes (x read once, the int8
// weight, scale, bias, the float32 output written once) take 25.4 us at
// 3.35 TB/s; its 17.2 GFLOP take 17.4 us at the 989 TFLOP/s bf16 dense peak.
// Bytes bound it, but the operations are close behind: only wgmma, fed by
// loads that are always in flight, keeps them under the bytes.
//
// Two routes, chosen by shape in the Python wrapper (kernels/quant_matmul.py):
//
// wgmma route (M a multiple of 16 and a 16-byte aligned weight: what TMA
// takes). A pre-pass rounds x to bf16 once, into a scratch whose row pitch is
// K rounded up to 8 (TMA wants 16-byte row strides). The product computes
// out^T = w_q^T x^T: the weight is wgmma's A operand and x its B operand.
//   * A block owns a strip of kBM = 256 columns of M (128 blocks for
//     M = 32768: one wave on 132 SMs) and a tile of up to BN rows of N (32, 64
//     or 128, the wgmma N width, picked by the wrapper from N). Blocks of one
//     strip are neighbours in the grid, so a second N tile finds the strip's
//     weight in L2.
//   * One thread of a producer warpgroup walks K in steps of kBK = 64 and
//     keeps a ring of kStages shared-memory stages filled by TMA: a 64 x BN
//     bf16 box of x (K-major, 128-byte swizzle) and two 128 x 64 int8 boxes
//     of the weight (128-byte swizzle), completion counted on an mbarrier per
//     stage. TMA's
//     zero fill past the tensor's edges replaces the masks for ragged K and N
//     (and ragged M within a box); a box wholly past M is not loaded.
//   * Two consumer warpgroups, one per weight box (128 columns of M each,
//     two 64-row wgmma tiles). Why A is the weight, widened in registers,
//     rather than a bf16 B tile written back to shared memory: the widening
//     then never leaves registers, there is no second shared-memory write, no
//     generic-to-async proxy fence and no barrier between widening and wgmma;
//     x keeps the standard K-major swizzled B layout that TMA writes. Each
//     thread's A rows are permuted (which row of M a fragment row holds is
//     free, the epilogue undoes it) so that its four rows of the two tiles are
//     four adjacent bytes: one 32-bit shared load per K row gives the bytes
//     of both tiles, and the swizzle makes those loads free of bank
//     conflicts. A byte widens to bf16 exactly through the float 2^23 trick
//     (3 integer/float operations, no I2F).
//   * wgmma.mma_async m64nBNk16, bf16 x bf16 -> f32, A from registers, B by
//     descriptor. Two register sets of A fragments: a stage widens while the
//     previous stage's wgmma group runs (wgmma.wait_group 1), and a stage is
//     released to the producer (empty mbarrier) once its group has completed.
//   * Epilogue: the accumulators go through shared memory (the ring, free
//     by then; padded rows, conflict-free float4 stores) and leave with scale
//     and bias as coalesced float4 rows of the float32 output, written once.
// Registers: a consumer thread holds 2 x BN/2 float32 accumulators and 2 x 32
// A registers, 192 at BN = 128. Registers are split among an SM's four
// quarters by warp, so a block of 9 warps caps a thread at 168 (measured:
// spills, serialized wgmma). The producer is a whole warpgroup instead, and
// setmaxnreg moves registers to the consumers (40 / 232 a thread). Stages: the
// consumers hold two (one widening, one in wgmma), so 6 stages of up to 32 KB
// (192 KB) keep 4 stages' loads in flight.
//
// Byte-wise route (any other M or weight pointer): a tiled nvcuda::wmma GEMM
// that reads the weight one byte at a time.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and the CUDA driver API enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

__global__ void to_bf16_padded(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                               int n, int k, int n_pad, int k_pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_pad * k_pad) return;
  const int r = (int)(i / k_pad), c = (int)(i % k_pad);
  xb[i] = __float2bfloat16_rn(r < n && c < k ? x[(long long)r * k + c] : 0.0f);
}

cudaError_t launch_to_bf16(const float* x, __nv_bfloat16* xb, int n, int k, int n_pad, int k_pad,
                           cudaStream_t s) {
  const long long elems = (long long)n_pad * k_pad;
  to_bf16_padded<<<(unsigned int)((elems + 255) / 256), 256, 0, s>>>(x, xb, n, k, n_pad, k_pad);
  return cudaGetLastError();
}

// ------------------------------------------------------------ wgmma route

constexpr int kBK = 64;          // K per stage: one 128-byte swizzle row of bf16 x
constexpr int kBoxM = 128;       // weight columns per TMA box and per consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kBM = kConsumers * kBoxM;  // columns of M per block
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 4 x 40 + 8 x 232 warps' worth fit an SM
constexpr int kStages = 6;
constexpr int kKPitch = 8;       // the bf16 x row pitch is a multiple of 8 (16 bytes)
constexpr int kEpiPitch = kBoxM + 4;  // floats a staged output row: +16 bytes spreads the banks
constexpr int kWBoxBytes = kBK * kBoxM;

template <int BN>
struct Tile {
  static constexpr int kXBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kXBytes + kConsumers * kWBoxBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kEpiBytes = kConsumers * BN * kEpiPitch * 4;
  static constexpr int kDataBytes = kRingBytes > kEpiBytes ? kRingBytes : kEpiBytes;
  // + the 2 * kStages mbarriers, + slack to align the ring to 1024 bytes (128-byte swizzle)
  static constexpr int kSmemBytes = kDataBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major bf16 tile whose 128-byte rows TMA wrote with the
// 128-byte swizzle from a 1024-byte aligned address: 8-row groups 1024 bytes apart
// (SBO), LBO unused for this layout, layout type 1 (128-byte swizzle). One k16 step
// (32 bytes) further along K is +2 in the address field.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)

// D (64 x BN, f32, in registers) += A (64 x 16 bf16, registers) * B (16 x BN, descriptor)
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    const int scale_d = 1;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    const int scale_d = 1;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : F16(d, 0), F16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    const int scale_d = 1;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

#undef F16
#undef F4

// four int8 (the bytes of w, byte i = element i) -> their values as float32,
// exactly: a byte made unsigned (^ 0x80) fills the low mantissa byte of 2^23,
// giving 2^23 + 128 + v, and 2^23 + 128 is subtracted
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.0f;
}

// two floats holding bf16 values exactly -> one bf16x2 word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The producer: one lane walks K and keeps the ring full (TMA, mbarriers).
template <int BN>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty, int m, int k_tiles, int n0, int m0) {
  using T = Tile<BN>;
  if (threadIdx.x == kConsumers * 128) {
    const bool second_box = m0 + kBoxM < m;
    const uint32_t bytes = T::kXBytes + (second_box ? 2 : 1) * kWBoxBytes;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      uint8_t* stage = smem + s * T::kStageBytes;
      mbar_expect_tx(&full[s], bytes);
      tma_load_2d(stage, xmap, &full[s], kt * kBK, n0);
      tma_load_2d(stage + T::kXBytes, wmap, &full[s], m0, kt * kBK);
      if (second_box) tma_load_2d(stage + T::kXBytes + kWBoxBytes, wmap, &full[s], m0 + kBoxM, kt * kBK);
    }
  }
}

// A consumer warpgroup: the products of its weight box, then the epilogue.
template <int BN>
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full, uint64_t* empty, const float* scale,
                                        const float* bias, float* out, int n, int m, int k_tiles, int n0,
                                        int m0) {
  using T = Tile<BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // wg owns columns m0 + wg*128 .. +127 (weight box wg)
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, tig = lane % 4;
  // this thread's 4 adjacent weight bytes in a box row: rows g and g+8 of its
  // warp's slice of tile 0, then of tile 1 (column 32*wq + 4*g + 2*tile + half)
  const int chunk = 2 * wq + g / 4, in_chunk = 4 * (g % 4);
  float acc[2][BN / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.0f;

  // the A fragments of one stage (4 k16 steps x 2 tiles), widened from its weight box
  auto widen_stage = [&](int kt, uint32_t (&a)[kBK / 16][2][4]) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* wbox = smem + s * T::kStageBytes + T::kXBytes + wg * kWBoxBytes;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      float f[4][4];  // K rows 16j + 2tig + {0, 1, 8, 9}
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kr = 16 * j + 2 * tig + (q & 1) + 8 * (q >> 1);
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(wbox + kr * kBoxM + ((chunk ^ (kr & 7)) << 4) + in_chunk);
        widen4(word, f[q]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        a[j][t][0] = pack_bf16(f[0][2 * t], f[1][2 * t]);          // row g,   k c, c+1
        a[j][t][1] = pack_bf16(f[0][2 * t + 1], f[1][2 * t + 1]);  // row g+8, k c, c+1
        a[j][t][2] = pack_bf16(f[2][2 * t], f[3][2 * t]);          // row g,   k c+8, c+9
        a[j][t][3] = pack_bf16(f[2][2 * t + 1], f[3][2 * t + 1]);  // row g+8, k c+8, c+9
    }
  }
  };
  // issue the stage's wgmmas; wait until at most one group (this one) is in
  // flight, so the previous stage's products are done: release that stage,
  // whose A registers the next widening then reuses
  auto mma_stage = [&](int kt, const uint32_t (&a)[kBK / 16][2][4]) {
    const uint64_t desc = kmajor_sw128_desc(smem + (kt % kStages) * T::kStageBytes);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[t][i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
      for (int t = 0; t < 2; ++t) Wgmma<BN>::mma(acc[t], a[j][t], desc + 2 * j);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[t][i]);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
  };

  // two register sets of A fragments, so a stage widens while the previous one's wgmmas run
  uint32_t a0[kBK / 16][2][4], a1[kBK / 16][2][4];
  widen_stage(0, a0);
  for (int kt = 0; kt < k_tiles; kt += 2) {
    mma_stage(kt, a0);
    if (kt + 1 >= k_tiles) break;
    widen_stage(kt + 1, a1);
    mma_stage(kt + 1, a1);
    if (kt + 2 < k_tiles) widen_stage(kt + 2, a0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[t][i]);

  // ---- epilogue: stage (n, m) in shared memory, then scale, bias, coalesced rows
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");  // the ring is free
  float* epi = reinterpret_cast<float*>(smem) + wg * BN * kEpiPitch;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * i + 2 * tig + e;
      // acc index 4i + 2h + e holds (M row g + 8h, N column 8i + 2tig + e)
      *reinterpret_cast<float4*>(&epi[row * kEpiPitch + 32 * wq + 4 * g]) =
          make_float4(acc[0][4 * i + e], acc[0][4 * i + 2 + e], acc[1][4 * i + e], acc[1][4 * i + 2 + e]);
    }
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const int tid = threadIdx.x % 128, col = m0 + wg * kBoxM + 4 * (tid % 32);
  if (col < m) {  // m is a multiple of 16: a float4 is all in or all out
    float s4[4], b4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s4[c] = scale[col + c];
      b4[c] = bias[col + c];
    }
    for (int row = tid / 32; row < BN && n0 + row < n; row += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&epi[row * kEpiPitch + 4 * (tid % 32)]);
      *reinterpret_cast<float4*>(&out[(long long)(n0 + row) * m + col]) =
          make_float4(__fadd_rn(__fmul_rn(v.x, s4[0]), b4[0]), __fadd_rn(__fmul_rn(v.y, s4[1]), b4[1]),
                      __fadd_rn(__fmul_rn(v.z, s4[2]), b4[2]), __fadd_rn(__fmul_rn(v.w, s4[3]), b4[3]));
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ out,
                  int n, int m, int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile<BN>::kDataBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  // one if/else, the roles never reconverge: what setmaxnreg needs
  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    produce<BN>(&xmap, &wmap, smem, full, empty, m, k_tiles, n0, m0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<BN>(smem, full, empty, scale, bias, out, n, m, k_tiles, n0, m0);
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2D row-major (rows, cols) tensor with a row pitch in bytes, read in
// (box_rows, box_cols) boxes with the 128-byte swizzle and zero fill outside
bool encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, uint64_t rows, uint64_t cols,
               uint64_t pitch_bytes, uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const __nv_bfloat16* xb, int k_pitch, const int8_t* w, const float* scale,
                         const float* bias, float* out, int n, int k, int m, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  if (!encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xb, n, k_pitch, (uint64_t)k_pitch * 2, BN, kBK) ||
      !encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k, m, m, kBK, kBoxM))
    return cudaErrorInvalidValue;
  const int smem = Tile<BN>::kSmemBytes;
  static bool opted_in[64] = {};  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(int8_matmul_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM);
  int8_matmul_wgmma<BN><<<grid, kThreads, smem, s>>>(xmap, wmap, scale, bias, out, n, m, (k + kBK - 1) / kBK);
  return cudaGetLastError();
}

// --------------------------------------------------------- byte-wise route

using namespace nvcuda;

constexpr int kByteBM = 128;  // rows of N per block; the wrapper pads x to it
constexpr int kByteBN = 128;  // columns of M per block
constexpr int kByteBK = 32;   // depth of one K step; the wrapper pads K to it
constexpr int kByteThreads = 256;
constexpr int kWarpRows = 32, kWarpCols = 64;  // 8 warps: 4 along N x 2 along M
constexpr int kFragM = kWarpRows / 16, kFragN = kWarpCols / 16;
constexpr int kLdA = kByteBK + 8;  // shared row pitches in bf16 elements: +16 bytes
constexpr int kLdB = kByteBN + 8;  // spreads ldmatrix rows over the banks

// four int8 in a word -> four bf16 (exact), as two bf16 pairs
__device__ __forceinline__ uint2 widen4_bf16(uint32_t w) {
  const float a = (float)(int8_t)(w & 0xff), b = (float)(int8_t)((w >> 8) & 0xff);
  const float c = (float)(int8_t)((w >> 16) & 0xff), d = (float)(int8_t)(w >> 24);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// a 128 x 128 output tile a block, K steps of 32 staged through registers,
// the weight read byte by byte and widened on its way into shared memory,
// nvcuda::wmma bf16 16x16x16 fragments with float32 accumulators
__global__ void __launch_bounds__(kByteThreads, 2)
int8_matmul_bytewise(const __nv_bfloat16* __restrict__ xb, int k_pad, const int8_t* __restrict__ wq,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ out, int n, int k, int m) {
  __shared__ __align__(128) __nv_bfloat16 As[kByteBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kByteBK * kLdB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;
  const int n0 = blockIdx.x * kByteBM, m0 = blockIdx.y * kByteBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // x tile: kByteBM x kByteBK bf16 = 512 chunks of 8 values, 2 a thread.
  // weight tile: kByteBK x kByteBN int8 = 256 chunks of 16 values, 1 a thread.
  const int b_row = tid / 8, b_col = (tid % 8) * 16;
  uint4 a_reg[2], b_reg;

  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kByteThreads, r = chunk / 4, col = (chunk % 4) * 8;
      a_reg[c] = *reinterpret_cast<const uint4*>(xb + (long long)(n0 + r) * k_pad + k0 + col);
    }
    const int kk = k0 + b_row, mm = m0 + b_col;
    const int8_t* src = wq + (long long)kk * m + mm;
    uint32_t w[4] = {0, 0, 0, 0};
    if (kk < k) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (mm + e < m) w[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
    }
    b_reg = make_uint4(w[0], w[1], w[2], w[3]);
  };

  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kByteThreads, r = chunk / 4, col = (chunk % 4) * 8;
      *reinterpret_cast<uint4*>(&As[r * kLdA + col]) = a_reg[c];
    }
    const uint2 p0 = widen4_bf16(b_reg.x), p1 = widen4_bf16(b_reg.y);
    const uint2 p2 = widen4_bf16(b_reg.z), p3 = widen4_bf16(b_reg.w);
    uint4* dst = reinterpret_cast<uint4*>(&Bs[b_row * kLdB + b_col]);
    dst[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    dst[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  };

  const int k_tiles = k_pad / kByteBK;
  load(0);
  for (int t = 0; t < k_tiles; ++t) {
    __syncthreads();  // every warp is done reading the previous step's tiles
    store();
    __syncthreads();
    if (t + 1 < k_tiles) load((t + 1) * kByteBK);  // next step's loads fly during the products
#pragma unroll
    for (int ks = 0; ks < kByteBK; ks += 16) {
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
  // (the x tile's space, free now) and writes it with scale and bias
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

// x: (n, k) float32; xb: scratch of (n, round_up(k, 8)) bf16; w_q: (k, m) int8,
// m a multiple of 16 and w_q 16-byte aligned; scale, bias: (m,) float32; out:
// (n, m) float32; tile_n 32, 64 or 128 (the wgmma N width). All contiguous on
// one device; the Python wrapper checks it and picks the route. Returns the
// cudaError_t of the launches.
extern "C" int rnagan_int8_matmul_wgmma(const float* x, void* xb, const void* w_q, const float* scale,
                                        const float* bias, float* out, int n, int k, int m, int tile_n,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_pitch = (k + kKPitch - 1) / kKPitch * kKPitch;
  __nv_bfloat16* xbf = static_cast<__nv_bfloat16*>(xb);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  if (m % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_to_bf16(x, xbf, n, k, n, k_pitch, s);
  if (err != cudaSuccess) return (int)err;
  switch (tile_n) {
    case 32: err = launch_wgmma<32>(xbf, k_pitch, w, scale, bias, out, n, k, m, s); break;
    case 64: err = launch_wgmma<64>(xbf, k_pitch, w, scale, bias, out, n, k, m, s); break;
    case 128: err = launch_wgmma<128>(xbf, k_pitch, w, scale, bias, out, n, k, m, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The byte-wise route: xb is a scratch of (round_up(n, 128), round_up(k, 32))
// bf16; any m and weight alignment. Otherwise as above.
extern "C" int rnagan_int8_matmul_bytewise(const float* x, void* xb, const void* w_q, const float* scale,
                                           const float* bias, float* out, int n, int k, int m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = (n + kByteBM - 1) / kByteBM * kByteBM, k_pad = (k + kByteBK - 1) / kByteBK * kByteBK;
  __nv_bfloat16* xbf = static_cast<__nv_bfloat16*>(xb);
  const cudaError_t err = launch_to_bf16(x, xbf, n, k, n_pad, k_pad, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_pad / kByteBM, (m + kByteBN - 1) / kByteBN);
  int8_matmul_bytewise<<<grid, kByteThreads, 0, s>>>(xbf, k_pad, static_cast<const int8_t*>(w_q), scale, bias,
                                                     out, n, k, m);
  return (int)cudaGetLastError();
}
