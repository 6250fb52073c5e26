// Train-mode BatchNorm of a bf16 channels-last map, with flax's semantics,
// optionally followed by LeakyReLU, its backward and the backward's backward.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's nn.BatchNorm,
// which XLA fuses on the TPU. On the card the same arithmetic written as
// PyTorch ops (models/batchnorm.py) runs as about ten float32 passes over the
// map, each (1, C, 1, 1) broadcast over an NHWC map on a strided elementwise
// kernel. A channels-last map of N x C x H x W is the row-major (R, C) matrix
// with R = N * H * W, so each kernel here walks rows of C contiguous bf16.
//
// Forward (models/batchnorm.py's flax semantics):
//   m = E[x], raw = E[x^2] - m^2, v = max(raw, 0), rstd = rsqrt(v + 1e-5),
//   mul = rstd * scale (rstd without a scale),
//   z = bf16((x - m) * mul + bias)      (no "+ bias" without a bias),
//   y = z > 0 ? z : bf16(z * slope)     (act) or y = z,
//   running statistics 0.9 * old + 0.1 * batch, the variance the biased one.
// Backward, with g' = g where z > 0 or without act, bf16(g * slope) elsewhere,
// and xh = (x - m) * rstd:
//   dbias = sum g', dscale = sum g' * xh,
//   dx = mul * (g' - dbias / R - [raw >= 0] * xh * dscale / R).
// The mask of g' is recovered by recomputing z from x with the same rounded
// operations as the forward (so the backward reads x and g, not y).
// The backward's backward (the gradient penalty's double backward), for the
// cotangents u of dx, a of dscale and b of dbias, with c = [raw >= 0],
// lam = act'(z), and the per-channel means mu = E[u], ux = E[u * xh] and the
// sum ug = sum u * g':
//   Q = ug - dbias * mu - c * dscale * ux,  d/dscale = rstd * Q,
//   d/dg = lam * (mul * u + (a - c * mul * ux) * xh + b - mul * mu),
//   d/dx = rstd * (P - E[P]) - c * xh * (rstd * E[P * xh] + rstd * mul * Q / R),
//   P = -c * mul * dscale / R * u + (a - c * mul * ux) * g',
// where E[P] and E[P * xh] follow from the sums in closed form; the bias has
// no second derivative (it reaches the backward only through the mask).
//
// Bound on the H100: bytes. The function needs x read and y written forward
// (4 bytes an element), x and g read and dx written backward (6), and x, g and
// u read and two maps written in the double backward (10). This design reads
// each input twice (the sums, then the elementwise pass): 6, 10 and 16 bytes
// an element. At the DCGAN step's batch 8, G's six BatchNorms hold 2.06 M
// elements a sample and D's five 1.02 M.
//
// Design. Each thread loads 8 channels of one row as one 16-byte vector;
// a block of 256 threads covers a tile of up to 256 channels (32 groups of
// 8) and 256 / groups rows at once, and walks a chunk of rows four rows a
// step (four loads in flight a thread). The grid is (row chunks, channel
// tiles); the Python wrapper (kernels/batchnorm.py::plan) picks the chunks.
// The statistics kernels sum in float32 registers, combine the block's rows
// in shared memory in a fixed order and write one partial sum a chunk; the
// last block of each channel tile to arrive (an integer ticket of the
// launch's own, no float atomics) sums the tile's partials over the chunks in
// a fixed order and writes its channels' results. So every sum has one order
// for a given shape: the results are bit-stable from launch to launch and in
// every CUDA graph replay. Each
// kernel reads its per-channel operands from device memory, so the launches
// can be captured. Every rounding step of z uses the _rn intrinsics, so no
// FMA contraction moves z across a rounding boundary between the forward and
// the backward's recomputation.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // bf16 channels a thread loads at once (16 bytes)
constexpr int kTileGroups = 32;  // channel groups of 8 in a block's tile (256 channels)
constexpr int kUnroll = 4;       // rows a thread loads before it adds
constexpr float kEps = 1e-5f;
constexpr float kMomentum = 0.9f;  // flax: the weight of the old running statistics
constexpr float kBatchWeight = 0.1f;

struct Tile {
  int groups;  // channel groups of 8 a block covers
  int ry;      // rows a block covers at once
  int gx;      // this thread's group
  int row;     // this thread's row offset within the block's rows
  int c0;      // this thread's first channel
  bool valid;
};

__device__ __forceinline__ Tile tile_of(int C) {
  Tile t;
  t.groups = min(C / kVec, kTileGroups);
  t.ry = kThreads / t.groups;
  t.gx = threadIdx.x % t.groups;
  t.row = threadIdx.x / t.groups;
  t.c0 = (blockIdx.y * t.groups + t.gx) * kVec;
  t.valid = threadIdx.x < t.groups * t.ry && t.c0 < C;
  return t;
}

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ float bf16_round(float f) { return __uint_as_float(bf16_bits(f) << 16); }

__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// z = bf16((x - m) * mul + b), the composite's roundings
__device__ __forceinline__ float normalized(float x, float m, float mul, float b, bool has_bias) {
  float z = __fmul_rn(__fsub_rn(x, m), mul);
  if (has_bias) z = __fadd_rn(z, b);
  return bf16_round(z);
}

// g through the activation at z: LeakyReLU's backward in bf16, or g itself
__device__ __forceinline__ float through_act(float g, float z, float slope, bool act) {
  return (!act || z > 0.f) ? g : bf16_round(__fmul_rn(g, slope));
}

// Per-channel operands of a thread's 8 channels: m, rstd, mul, raw and bias
struct Channels {
  float m[kVec], r[kVec], mul[kVec], raw[kVec], b[kVec];
};

__device__ __forceinline__ void load_channels(Channels& ch, const float* stats, const float* bias, int C,
                                              int c0) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    ch.m[k] = stats[c0 + k];
    ch.r[k] = stats[C + c0 + k];
    ch.mul[k] = stats[2 * C + c0 + k];
    ch.raw[k] = stats[3 * C + c0 + k];
    ch.b[k] = bias ? bias[c0 + k] : 0.f;
  }
}

// The block's per-thread sums acc[kind] combined over its rows in a fixed
// order and written as this chunk's partials: part[(chunk * kKinds + kind) * C + c].
template <int kKinds>
__device__ void write_partials(const Tile& t, const float (&acc)[kKinds][kVec], float* red, float* part, int C) {
#pragma unroll
  for (int kind = 0; kind < kKinds; ++kind)
#pragma unroll
    for (int k = 0; k < kVec; ++k) red[(kind * kThreads + threadIdx.x) * kVec + k] = acc[kind][k];
  __syncthreads();
  const int width = t.groups * kVec;
  for (int o = threadIdx.x; o < kKinds * width; o += kThreads) {
    const int kind = o / width, idx = o % width;
    const int gx = idx / kVec, k = idx % kVec;
    const int c = (blockIdx.y * t.groups + gx) * kVec + k;
    if (c >= C) continue;
    float sum = 0.f;
    for (int row = 0; row < t.ry; ++row) sum += red[(kind * kThreads + row * t.groups + gx) * kVec + k];
    part[((size_t)blockIdx.x * kKinds + kind) * C + c] = sum;
  }
}

// Whether this block arrived last of its channel tile's column of blocks.
// ``tickets`` (a tile each) belong to this launch alone and are zero when it
// starts (its launcher clears them on the launch's stream), so launches that
// overlap, on other streams or in graph replays, never count each other.
__device__ bool arrived_last(unsigned int* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// A tile's last block: each of the tile's channels' sums over the chunks, in
// a fixed order, handed to epi(c, S). Each thread adds float4s of 4 channels
// over every K-th chunk; then the K partials of a quad are added in order.
template <int kKinds, class Epilogue>
__device__ void finish(const float* part, int chunks, int C, float* red, const Epilogue& epi) {
  const int c_begin = blockIdx.y * kTileGroups * kVec;
  const int quads = min(C - c_begin, kTileGroups * kVec) / 4, K = kThreads / quads;
  const int lane = threadIdx.x % quads, k = threadIdx.x / quads, c = c_begin + 4 * lane;
  float4 s[kKinds];
#pragma unroll
  for (int kind = 0; kind < kKinds; ++kind) s[kind] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < K) {
#pragma unroll 4
    for (int j = k; j < chunks; j += K) {
#pragma unroll
      for (int kind = 0; kind < kKinds; ++kind) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(part + ((size_t)j * kKinds + kind) * C + c));
        s[kind].x += a.x, s[kind].y += a.y, s[kind].z += a.z, s[kind].w += a.w;
      }
    }
  }
  float4* red4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int kind = 0; kind < kKinds; ++kind) red4[kind * kThreads + threadIdx.x] = s[kind];
  __syncthreads();
  if (k == 0) {
    float S[4][kKinds] = {};
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int kind = 0; kind < kKinds; ++kind) {
        const float4 a = red4[kind * kThreads + i * quads + lane];
        S[0][kind] += a.x, S[1][kind] += a.y, S[2][kind] += a.z, S[3][kind] += a.w;
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) epi(c + v, S[v]);
  }
}

struct ForwardEpilogue {
  const float* scale;
  const float* mean;
  const float* var;
  float* stats;
  float* new_mean;
  float* new_var;
  int rows, C;
  __device__ void operator()(int c, const float (&S)[2]) const {
    const float n = (float)rows;
    const float m = __fdiv_rn(S[0], n);
    const float raw = __fsub_rn(__fdiv_rn(S[1], n), __fmul_rn(m, m));
    const float v = fmaxf(raw, 0.f);
    const float r = rsqrtf(__fadd_rn(v, kEps));
    stats[c] = m;
    stats[C + c] = r;
    stats[2 * C + c] = scale ? __fmul_rn(r, scale[c]) : r;
    stats[3 * C + c] = raw;
    new_mean[c] = __fadd_rn(__fmul_rn(kMomentum, mean[c]), __fmul_rn(kBatchWeight, m));
    new_var[c] = __fadd_rn(__fmul_rn(kMomentum, var[c]), __fmul_rn(kBatchWeight, v));
  }
};

struct GradEpilogue {
  const float* stats;
  float* dbias;
  float* dscale;
  int C;
  __device__ void operator()(int c, const float (&S)[2]) const {
    dbias[c] = S[0];
    dscale[c] = __fmul_rn(S[1], stats[C + c]);  // sum g' (x - m), times rstd
  }
};

// The double backward's per-channel coefficients (kGrad2Coefs rows of C) from
// the sums of u, u * xh and u * g', and d/dscale.
constexpr int kGrad2Coefs = 5;
struct Grad2Epilogue {
  const float* stats;
  const float* dbias;
  const float* dscale;
  const float* a;  // cotangent of dscale, or null
  const float* b;  // cotangent of dbias, or null
  float* coef;     // (kGrad2Coefs, C): xh's and the constant term of d/dg; u's, xh's and the constant of d/dx
  float* dscale_grad;
  int rows, C;
  __device__ void operator()(int c, const float (&S)[3]) const {
    const float n = (float)rows;
    const float r = stats[C + c], mul = stats[2 * C + c], cl = stats[3 * C + c] >= 0.f ? 1.f : 0.f;
    const float av = a ? a[c] : 0.f, bv = b ? b[c] : 0.f;
    const float mu = S[0] / n, ux = S[1] / n;
    const float q = S[2] - dbias[c] * mu - cl * dscale[c] * ux;
    const float xh_g = av - cl * mul * ux;  // the coefficient of xh in d/dg and of g' in P
    const float p_mean = -cl * mul * (mu * dscale[c] / n) + xh_g * dbias[c] / n;
    const float pxh_mean = xh_g * dscale[c] / n - cl * mul * ux * dscale[c] / n;
    coef[c] = xh_g;
    coef[C + c] = bv - mul * mu;
    coef[2 * C + c] = -r * cl * mul * dscale[c] / n;
    coef[3 * C + c] = -cl * (r * pxh_mean + r * mul * q / n);
    coef[4 * C + c] = -r * p_mean;
    dscale_grad[c] = r * q;
  }
};

// Walks this thread's rows of the block's chunk, kSteps rows a step: loads the
// 8-channel vectors of every map for every row of the step (zeros for a null
// map), then hands each row to op(offset, v) in row order.
template <int kMaps, int kSteps, class Op>
__device__ __forceinline__ void walk_rows(const Tile& t, const __nv_bfloat16* const (&maps)[kMaps], int rows, int C,
                                          int rows_per_chunk, Op& op) {
  const int row1 = min(rows, (int)(blockIdx.x + 1) * rows_per_chunk);
  int r = blockIdx.x * rows_per_chunk + t.row;
  for (; r + (kSteps - 1) * t.ry < row1; r += kSteps * t.ry) {
    uint4 v[kSteps][kMaps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
#pragma unroll
      for (int i = 0; i < kMaps; ++i) {
        const size_t off = (size_t)(r + u * t.ry) * C + t.c0;
        v[u][i] = maps[i] ? load8(maps[i] + off) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) op((size_t)(r + u * t.ry) * C + t.c0, v[u]);
  }
  for (; r < row1; r += t.ry) {
    const size_t off = (size_t)r * C + t.c0;
    uint4 v[kMaps];
#pragma unroll
    for (int i = 0; i < kMaps; ++i) v[i] = maps[i] ? load8(maps[i] + off) : make_uint4(0, 0, 0, 0);
    op(off, v);
  }
}

// Sums of x and x^2 a channel (maps: x)
struct SumSquares {
  float acc[2][kVec] = {};
  __device__ __forceinline__ void operator()(size_t, const uint4 (&v)[1]) {
    float f[kVec];
    unpack8(v[0], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      acc[0][k] += f[k];
      acc[1][k] = fmaf(f[k], f[k], acc[1][k]);
    }
  }
};

// y = act(z) written at the row's offset (maps: x)
struct Normalize {
  Channels ch;
  __nv_bfloat16* y;
  float slope;
  bool has_bias, act;
  __device__ __forceinline__ void operator()(size_t off, const uint4 (&v)[1]) {
    float f[kVec];
    unpack8(v[0], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float z = normalized(f[k], ch.m[k], ch.mul[k], ch.b[k], has_bias);
      f[k] = (!act || z > 0.f) ? z : bf16_round(__fmul_rn(z, slope));
    }
    *reinterpret_cast<uint4*>(y + off) = pack8(f);
  }
};

// Sums of g' and g' * (x - m) a channel (maps: x, g)
struct GradSums {
  Channels ch;
  float slope;
  bool has_bias, act;
  float acc[2][kVec] = {};
  __device__ __forceinline__ void operator()(size_t, const uint4 (&v)[2]) {
    float fx[kVec], fg[kVec];
    unpack8(v[0], fx);
    unpack8(v[1], fg);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float gp = through_act(fg[k], normalized(fx[k], ch.m[k], ch.mul[k], ch.b[k], has_bias), slope, act);
      acc[0][k] += gp;
      acc[1][k] = fmaf(gp, __fsub_rn(fx[k], ch.m[k]), acc[1][k]);
    }
  }
};

// dx written at the row's offset (maps: x, g)
struct GradInput {
  Channels ch;
  float mean_g[kVec], mean_gx[kVec];
  __nv_bfloat16* dx;
  float slope;
  bool has_bias, act;
  __device__ __forceinline__ void operator()(size_t off, const uint4 (&v)[2]) {
    float fx[kVec], fg[kVec];
    unpack8(v[0], fx);
    unpack8(v[1], fg);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float gp = through_act(fg[k], normalized(fx[k], ch.m[k], ch.mul[k], ch.b[k], has_bias), slope, act);
      const float xh = __fsub_rn(fx[k], ch.m[k]) * ch.r[k];
      fx[k] = ch.mul[k] * (gp - mean_g[k] - xh * mean_gx[k]);
    }
    *reinterpret_cast<uint4*>(dx + off) = pack8(fx);
  }
};

// Sums of u, u * xh and u * g' a channel (maps: x, g, u)
struct Grad2Sums {
  Channels ch;
  float slope;
  bool has_bias, act;
  float acc[3][kVec] = {};
  __device__ __forceinline__ void operator()(size_t, const uint4 (&v)[3]) {
    float fx[kVec], fg[kVec], fu[kVec];
    unpack8(v[0], fx);
    unpack8(v[1], fg);
    unpack8(v[2], fu);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float gp = through_act(fg[k], normalized(fx[k], ch.m[k], ch.mul[k], ch.b[k], has_bias), slope, act);
      const float xh = __fsub_rn(fx[k], ch.m[k]) * ch.r[k];
      acc[0][k] += fu[k];
      acc[1][k] = fmaf(fu[k], xh, acc[1][k]);
      acc[2][k] = fmaf(fu[k], gp, acc[2][k]);
    }
  }
};

// d/dg and d/dx written at the row's offset (maps: x, g, u)
struct Grad2Input {
  Channels ch;
  float coef[kGrad2Coefs][kVec];
  __nv_bfloat16* gg;
  __nv_bfloat16* gx;
  float slope;
  bool has_bias, act;
  __device__ __forceinline__ void operator()(size_t off, const uint4 (&v)[3]) {
    float fx[kVec], fg[kVec], fu[kVec];
    unpack8(v[0], fx);
    unpack8(v[1], fg);
    unpack8(v[2], fu);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float z = normalized(fx[k], ch.m[k], ch.mul[k], ch.b[k], has_bias);
      const float gp = through_act(fg[k], z, slope, act);
      const float xh = __fsub_rn(fx[k], ch.m[k]) * ch.r[k];
      const float inner = ch.mul[k] * fu[k] + coef[0][k] * xh + coef[1][k];
      fg[k] = (!act || z > 0.f) ? inner : inner * slope;
      fx[k] = coef[2][k] * fu[k] + ch.r[k] * coef[0][k] * gp + coef[3][k] * xh + coef[4][k];
    }
    *reinterpret_cast<uint4*>(gg + off) = pack8(fg);
    *reinterpret_cast<uint4*>(gx + off) = pack8(fx);
  }
};

__global__ void __launch_bounds__(kThreads)
rnagan_bn_stats(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ mean, const float* __restrict__ var, float* __restrict__ part,
                unsigned int* __restrict__ tickets, float* __restrict__ stats, float* __restrict__ new_mean,
                float* __restrict__ new_var, int rows, int C, int rows_per_chunk) {
  __shared__ __align__(16) float red[2 * kThreads * kVec];
  const Tile t = tile_of(C);
  SumSquares op;
  const __nv_bfloat16* const maps[1] = {x};
  if (t.valid) walk_rows<1, kUnroll>(t, maps, rows, C, rows_per_chunk, op);
  write_partials<2>(t, op.acc, red, part, C);
  if (!arrived_last(tickets)) return;
  finish<2>(part, gridDim.x, C, red, ForwardEpilogue{scale, mean, var, stats, new_mean, new_var, rows, C});
}

__global__ void __launch_bounds__(kThreads)
rnagan_bn_apply(const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int rows, int C,
                int rows_per_chunk, float slope, int act) {
  const Tile t = tile_of(C);
  if (!t.valid) return;
  Normalize op;
  load_channels(op.ch, stats, bias, C, t.c0);
  op.y = y;
  op.slope = slope;
  op.has_bias = bias != nullptr;
  op.act = act != 0;
  const __nv_bfloat16* const maps[1] = {x};
  walk_rows<1, kUnroll>(t, maps, rows, C, rows_per_chunk, op);
}

__global__ void __launch_bounds__(kThreads)
rnagan_bn_grad_sums(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ stats, const float* __restrict__ bias, float* __restrict__ part,
                    unsigned int* __restrict__ tickets, float* __restrict__ dbias, float* __restrict__ dscale,
                    int rows, int C, int rows_per_chunk, float slope, int act) {
  __shared__ __align__(16) float red[2 * kThreads * kVec];
  const Tile t = tile_of(C);
  GradSums op;
  if (t.valid) {
    load_channels(op.ch, stats, bias, C, t.c0);
    op.slope = slope;
    op.has_bias = bias != nullptr;
    op.act = act != 0;
    const __nv_bfloat16* const maps[2] = {x, g};
    walk_rows<2, kUnroll>(t, maps, rows, C, rows_per_chunk, op);
  }
  write_partials<2>(t, op.acc, red, part, C);
  if (!arrived_last(tickets)) return;
  finish<2>(part, gridDim.x, C, red, GradEpilogue{stats, dbias, dscale, C});
}

__global__ void __launch_bounds__(kThreads)
rnagan_bn_grad_input(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ stats, const float* __restrict__ bias,
                     const float* __restrict__ dbias, const float* __restrict__ dscale,
                     __nv_bfloat16* __restrict__ dx, int rows, int C, int rows_per_chunk, float slope, int act) {
  const Tile t = tile_of(C);
  if (!t.valid) return;
  GradInput op;
  load_channels(op.ch, stats, bias, C, t.c0);
  const float n = (float)rows;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    op.mean_g[k] = __fdiv_rn(dbias[t.c0 + k], n);
    // the clamp of the variance passes no gradient where E[x^2] - m^2 < 0
    op.mean_gx[k] = op.ch.raw[k] >= 0.f ? __fdiv_rn(dscale[t.c0 + k], n) : 0.f;
  }
  op.dx = dx;
  op.slope = slope;
  op.has_bias = bias != nullptr;
  op.act = act != 0;
  const __nv_bfloat16* const maps[2] = {x, g};
  walk_rows<2, kUnroll>(t, maps, rows, C, rows_per_chunk, op);
}

__global__ void __launch_bounds__(kThreads)
rnagan_bn_grad2_sums(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ u, const float* __restrict__ stats,
                     const float* __restrict__ bias, const float* __restrict__ dbias,
                     const float* __restrict__ dscale, const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ part, unsigned int* __restrict__ tickets, float* __restrict__ coef,
                     float* __restrict__ dscale_grad, int rows, int C, int rows_per_chunk, float slope, int act) {
  __shared__ __align__(16) float red[3 * kThreads * kVec];
  const Tile t = tile_of(C);
  Grad2Sums op;
  if (t.valid) {
    load_channels(op.ch, stats, bias, C, t.c0);
    op.slope = slope;
    op.has_bias = bias != nullptr;
    op.act = act != 0;
    const __nv_bfloat16* const maps[3] = {x, g, u};
    walk_rows<3, 2>(t, maps, rows, C, rows_per_chunk, op);
  }
  write_partials<3>(t, op.acc, red, part, C);
  if (!arrived_last(tickets)) return;
  finish<3>(part, gridDim.x, C, red, Grad2Epilogue{stats, dbias, dscale, a, b, coef, dscale_grad, rows, C});
}

__global__ void __launch_bounds__(kThreads)
rnagan_bn_grad2_input(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ u, const float* __restrict__ stats,
                      const float* __restrict__ bias, const float* __restrict__ coef, __nv_bfloat16* __restrict__ gg,
                      __nv_bfloat16* __restrict__ gx, int rows, int C, int rows_per_chunk, float slope, int act) {
  const Tile t = tile_of(C);
  if (!t.valid) return;
  Grad2Input op;
  load_channels(op.ch, stats, bias, C, t.c0);
#pragma unroll
  for (int i = 0; i < kGrad2Coefs; ++i)
#pragma unroll
    for (int k = 0; k < kVec; ++k) op.coef[i][k] = coef[i * C + t.c0 + k];
  op.gg = gg;
  op.gx = gx;
  op.slope = slope;
  op.has_bias = bias != nullptr;
  op.act = act != 0;
  const __nv_bfloat16* const maps[3] = {x, g, u};
  walk_rows<3, 2>(t, maps, rows, C, rows_per_chunk, op);
}

int tiles_of(int C) { return (C / kVec + kTileGroups - 1) / kTileGroups; }

dim3 grid_of(int C, int chunks) { return dim3((unsigned int)chunks, (unsigned int)tiles_of(C)); }

// A statistics launch's tickets, one a channel tile, cleared on its stream.
cudaError_t clear_tickets(unsigned int* tickets, int C, cudaStream_t stream) {
  return cudaMemsetAsync(tickets, 0, sizeof(unsigned int) * (size_t)tiles_of(C), stream);
}

}  // namespace

// x: (rows, C) bf16, 16-byte aligned, C % 8 == 0; scale may be null; mean, var
// (C,) float32; part (chunks, 2, C) float32 scratch; tickets (tiles,) 32-bit
// scratch of this launch alone; stats (4, C) float32 out (m, rstd, mul, raw);
// new_mean, new_var (C,) out. chunks * rows_per_chunk covers rows. The Python
// wrapper checks all of it. Returns the cudaError_t.
extern "C" int rnagan_batch_norm_stats(const void* x, const float* scale, const float* mean, const float* var,
                                       float* part, void* tickets, float* stats, float* new_mean, float* new_var,
                                       int rows, int C, int chunks, int rows_per_chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* const t = static_cast<unsigned int*>(tickets);
  if (const cudaError_t err = clear_tickets(t, C, s)) return (int)err;
  rnagan_bn_stats<<<grid_of(C, chunks), kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), scale, mean,
                                                          var, part, t, stats, new_mean, new_var, rows, C,
                                                          rows_per_chunk);
  return (int)cudaGetLastError();
}

// y: (rows, C) bf16 out; bias may be null; act 1 applies LeakyReLU(slope).
extern "C" int rnagan_batch_norm_apply(const void* x, const float* stats, const float* bias, void* y, int rows,
                                       int C, int chunks, int rows_per_chunk, float slope, int act, void* stream) {
  rnagan_bn_apply<<<grid_of(C, chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), stats, bias, static_cast<__nv_bfloat16*>(y), rows, C,
      rows_per_chunk, slope, act);
  return (int)cudaGetLastError();
}

// g, x: (rows, C) bf16; part, tickets as for the statistics; dbias, dscale
// (C,) float32 out: sum g', sum g' * xh.
extern "C" int rnagan_batch_norm_grad_sums(const void* g, const void* x, const float* stats, const float* bias,
                                           float* part, void* tickets, float* dbias, float* dscale, int rows,
                                           int C, int chunks, int rows_per_chunk, float slope, int act,
                                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* const t = static_cast<unsigned int*>(tickets);
  if (const cudaError_t err = clear_tickets(t, C, s)) return (int)err;
  rnagan_bn_grad_sums<<<grid_of(C, chunks), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x), stats, bias, part, t, dbias,
      dscale, rows, C, rows_per_chunk, slope, act);
  return (int)cudaGetLastError();
}

// dx: (rows, C) bf16 out, from the sums rnagan_batch_norm_grad_sums wrote.
extern "C" int rnagan_batch_norm_grad_input(const void* g, const void* x, const float* stats, const float* bias,
                                            const float* dbias, const float* dscale, void* dx, int rows, int C,
                                            int chunks, int rows_per_chunk, float slope, int act, void* stream) {
  rnagan_bn_grad_input<<<grid_of(C, chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x), stats, bias, dbias, dscale,
      static_cast<__nv_bfloat16*>(dx), rows, C, rows_per_chunk, slope, act);
  return (int)cudaGetLastError();
}

// u: (rows, C) bf16, the cotangent of dx; a, b (C,) the cotangents of dscale
// and dbias, either may be null; part (chunks, 3, C) scratch; tickets as for
// the statistics; coef (kGrad2Coefs, C) out; dscale_grad (C,) out: the double
// backward's d/dscale.
extern "C" int rnagan_batch_norm_grad2_sums(const void* g, const void* x, const void* u, const float* stats,
                                            const float* bias, const float* dbias, const float* dscale,
                                            const float* a, const float* b, float* part, void* tickets,
                                            float* coef, float* dscale_grad, int rows, int C, int chunks,
                                            int rows_per_chunk, float slope, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* const t = static_cast<unsigned int*>(tickets);
  if (const cudaError_t err = clear_tickets(t, C, s)) return (int)err;
  rnagan_bn_grad2_sums<<<grid_of(C, chunks), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), stats, bias, dbias, dscale, a, b, part, t, coef, dscale_grad, rows,
      C, rows_per_chunk, slope, act);
  return (int)cudaGetLastError();
}

// gg, gx: (rows, C) bf16 out, the double backward's d/dg and d/dx, from coef.
extern "C" int rnagan_batch_norm_grad2_input(const void* g, const void* x, const void* u, const float* stats,
                                             const float* bias, const float* coef, void* gg, void* gx, int rows,
                                             int C, int chunks, int rows_per_chunk, float slope, int act,
                                             void* stream) {
  rnagan_bn_grad2_input<<<grid_of(C, chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), stats, bias, coef, static_cast<__nv_bfloat16*>(gg),
      static_cast<__nv_bfloat16*>(gx), rows, C, rows_per_chunk, slope, act);
  return (int)cudaGetLastError();
}
