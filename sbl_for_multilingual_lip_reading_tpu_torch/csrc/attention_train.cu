// K3, K4, K5: the training attention with attention-probability dropout on
// the projections' flat (B, T, H*d) layout, for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package's ops/attention.py:
//   K3 fused_small_mha_dropout_fwd_flat:
//        out = (keep * softmax(Q K^T * scale + bias) / (1 - rate)) V
//   K4 fused_small_mha_dropout_bwd_flat: dQ, dK, dV of K3 (the bias gets no
//        gradient), recomputing S, P and the keep mask from q, k, v, bias and
//        the seed, so the forward saves nothing else:
//        dV = P_drop^T dO;  dP = keep * (dO V^T) / (1 - rate);
//        dS = P o (dP - rowsum(dP o P));  dQ = dS K scale;  dK = dS^T Q scale
//   K5 dropout_keep_mask_flat: the (B, H, Tq, Tk) keep mask K3 and K4 draw.
// At rate 0 the draw is skipped and K3 computes K1's softmax(...) V.
//
// Random bits.  The TPU kernels draw pltpu.prng_random_bits, which no GPU
// reproduces.  Here the bits of every element come from a counter-based
// generator, Philox4x32-10 (Salmon et al., SC'11, with the round constants
// of Random123 and cuRAND), in one function shared by the three kernels:
//   key     = (seed & 0xffffffff, seed >> 32), the launch's 64-bit seed;
//   counter = (key index j, query index i, head h, batch row b);
//   bits    = word 0 of Philox4x32-10(counter, key);
//   keep   <=> bits >= uint32(rate * 2^32), the JAX package's threshold.
// An element (b, h, i, j) gets the same bits in K3, K4 and K5 for one seed
// whatever the launch geometry, so the backward regenerates the forward's
// mask by construction, and the plain Philox of ops/attention.py reproduces
// it bit for bit.  The decoder folds its two directions into the batch (2B
// rows), so the batch row in the counter gives each direction its own mask.
//
// What bounds them: as K1 (attention.cu), launch count and the bytes of
// Q/K/V/dO and the outputs at Tq, Tk <= 32 and d = 64, not FLOPs.  Design:
//   * one block of 4 warps per (batch row, head).  The head's K and V (in
//     K4 also Q and dO) are staged whole in shared memory as f32, each row
//     padded by one float so that lanes reading different rows hit
//     different banks: at most 41 KB at Tq = Tk = 32, under the 48 KB a
//     launch gets without opting in;
//   * one warp per query row; lane j owns key j (hence Tq, Tk <= 32): the
//     score, max and sum by shuffles, an f32 softmax normalised before the
//     mask is applied (as the JAX kernel orders it), one Philox draw per
//     (row, key);
//   * K4 keeps dS and the dropped P of the whole (row, head) tile in shared
//     memory, so the sums over queries for dK and dV stay inside the block:
//     one warp per key row, no atomics.
// Operands are upcast to f32 as the JAX kernels do; outputs and gradients
// are rounded once to the input dtype.  wgmma/TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using sbl::from_f32;
using sbl::to_f32;
using sbl::warp_max;
using sbl::warp_sum;

constexpr int kWarps = 4;
constexpr int kHeadDim = 64;        // d: the model's d_k = d_v
constexpr int kPad = kHeadDim + 1;  // staged row stride, in floats
constexpr int kMaxT = 32;           // Tq, Tk: one lane per key

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// word 0 of Philox4x32-10 at counter (j, i, h, b) under the 64-bit seed
__device__ __forceinline__ uint32_t dropout_bits(unsigned long long seed, uint32_t b,
                                                 uint32_t h, uint32_t i, uint32_t j) {
  uint32_t c0 = j, c1 = i, c2 = h, c3 = b;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

struct Dropout {
  unsigned long long seed;
  uint32_t thresh;   // uint32(rate * 2^32)
  float inv_keep;    // 1 / (1 - rate), rounded to f32 as JAX's weak-typed constant
  int on;            // rate > 0

  __device__ __forceinline__ bool keep(int b, int h, int i, int j) const {
    return dropout_bits(seed, b, h, i, j) >= thresh;
  }
};

// Copy a head's (n, d) rows of a flat (.., T, H*d) tensor into shared memory
// as f32 rows of stride kPad.  src points at row 0 of the head.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long row_stride, int n,
                                      float* dst) {
  for (int idx = threadIdx.x; idx < n * kHeadDim; idx += blockDim.x) {
    const int r = idx / kHeadDim;
    const int c = idx % kHeadDim;
    dst[r * kPad + c] = to_f32(src[(long long)r * row_stride + c]);
  }
}

// Lane j's softmax weight P[row, j] (0 for j >= Tk): the score q . k_j *
// scale + bias, max and sum over the warp, normalised as e / sum(e).
__device__ __forceinline__ float softmax_weight(const float* qrow, const float* ks,
                                                const float* bb, int row, int Tk, float scale,
                                                int lane) {
  float s = -INFINITY;
  if (lane < Tk) {
    float dot = 0.f;
#pragma unroll 16
    for (int c = 0; c < kHeadDim; ++c) dot = fmaf(qrow[c], ks[lane * kPad + c], dot);
    s = dot * scale;
    if (bb != nullptr) s += bb[(long long)row * Tk + lane];
  }
  const float m = warp_max(s);
  const float e = lane < Tk ? expf(s - m) : 0.f;
  return e / warp_sum(e);
}

// q: (B, Tq, H*d); k, v: (B, Tk, H*d); bias: null or (1|B, Tq, Tk) f32;
// out: (B, Tq, H*d).  Grid: B*H blocks of kWarps warps.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dropout_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, int Tq, int Tk, int H, int bias_per_batch,
                             float scale, Dropout drop) {
  extern __shared__ float smem[];
  float* ks = smem;              // [Tk][kPad]
  float* vs = ks + Tk * kPad;    // [Tk][kPad]
  float* qs = vs + Tk * kPad;    // [kWarps][kHeadDim], one query row per warp

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rs = (long long)H * kHeadDim;
  const long long head = (long long)h * kHeadDim;
  const T* qb = q + (long long)b * Tq * rs + head;
  T* ob = out + (long long)b * Tq * rs + head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage(k + (long long)b * Tk * rs + head, rs, Tk, ks);
  stage(v + (long long)b * Tk * rs + head, rs, Tk, vs);
  __syncthreads();

  float* qrow = qs + warp * kHeadDim;
  for (int row = warp; row < Tq; row += kWarps) {
    for (int c = lane; c < kHeadDim; c += 32) qrow[c] = to_f32(qb[(long long)row * rs + c]);
    __syncwarp();
    const float p = softmax_weight(qrow, ks, bb, row, Tk, scale, lane);
    float pd = p;
    if (drop.on) pd = (lane < Tk && drop.keep(b, h, row, lane)) ? p * drop.inv_keep : 0.f;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < Tk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pd, j);
      a0 = fmaf(pj, vs[j * kPad + lane], a0);
      a1 = fmaf(pj, vs[j * kPad + lane + 32], a1);
    }
    ob[(long long)row * rs + lane] = from_f32<T>(a0);
    ob[(long long)row * rs + lane + 32] = from_f32<T>(a1);
    __syncwarp();  // this warp's query row is rewritten in its next round
  }
}

// K3's inputs plus dout: (B, Tq, H*d); writes dq (B, Tq, H*d) and dk, dv
// (B, Tk, H*d).  Grid: B*H blocks of kWarps warps.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dropout_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             const T* __restrict__ dout, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H,
                             int bias_per_batch, float scale, Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;              // [Tq][kPad]
  float* gs = qs + Tq * kPad;    // [Tq][kPad]  dO
  float* ks = gs + Tq * kPad;    // [Tk][kPad]
  float* vs = ks + Tk * kPad;    // [Tk][kPad]
  float* dss = vs + Tk * kPad;   // [Tq][Tk]    dS
  float* pds = dss + Tq * Tk;    // [Tq][Tk]    P after dropout

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rs = (long long)H * kHeadDim;
  const long long head = (long long)h * kHeadDim;
  const long long qoff = (long long)b * Tq * rs + head;
  const long long koff = (long long)b * Tk * rs + head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage(q + qoff, rs, Tq, qs);
  stage(dout + qoff, rs, Tq, gs);
  stage(k + koff, rs, Tk, ks);
  stage(v + koff, rs, Tk, vs);
  __syncthreads();

  // rows of dS and P_drop, and dQ = dS K * scale
  for (int row = warp; row < Tq; row += kWarps) {
    const float p = softmax_weight(qs + row * kPad, ks, bb, row, Tk, scale, lane);
    float dpd = 0.f;
    if (lane < Tk) {
      const float* grow = gs + row * kPad;
#pragma unroll 16
      for (int c = 0; c < kHeadDim; ++c) dpd = fmaf(grow[c], vs[lane * kPad + c], dpd);
    }
    float pd = p, dp = dpd;
    if (drop.on) {
      const bool keep = lane < Tk && drop.keep(b, h, row, lane);
      pd = keep ? p * drop.inv_keep : 0.f;
      dp = keep ? dpd * drop.inv_keep : 0.f;
    }
    const float ds = p * (dp - warp_sum(dp * p));
    if (lane < Tk) {
      dss[row * Tk + lane] = ds;
      pds[row * Tk + lane] = pd;
    }
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < Tk; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
      a0 = fmaf(dsj, ks[j * kPad + lane], a0);
      a1 = fmaf(dsj, ks[j * kPad + lane + 32], a1);
    }
    dq[qoff + (long long)row * rs + lane] = from_f32<T>(a0 * scale);
    dq[qoff + (long long)row * rs + lane + 32] = from_f32<T>(a1 * scale);
  }
  __syncthreads();

  // dK = dS^T Q * scale and dV = P_drop^T dO, one warp per key row
  for (int j = warp; j < Tk; j += kWarps) {
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < Tq; ++i) {
      const float ds = dss[i * Tk + j];
      const float pd = pds[i * Tk + j];
      k0 = fmaf(ds, qs[i * kPad + lane], k0);
      k1 = fmaf(ds, qs[i * kPad + lane + 32], k1);
      v0 = fmaf(pd, gs[i * kPad + lane], v0);
      v1 = fmaf(pd, gs[i * kPad + lane + 32], v1);
    }
    const long long o = koff + (long long)j * rs;
    dk[o + lane] = from_f32<T>(k0 * scale);
    dk[o + lane + 32] = from_f32<T>(k1 * scale);
    dv[o + lane] = from_f32<T>(v0);
    dv[o + lane + 32] = from_f32<T>(v1);
  }
}

// out: (B, H, Tq, Tk) bytes, 1 = keep.  A grid-stride loop over elements.
__global__ void dropout_keep_mask_kernel(unsigned char* __restrict__ out, long long n, int H,
                                         int Tq, int Tk, Dropout drop) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    long long t = idx;
    const int j = (int)(t % Tk);
    t /= Tk;
    const int i = (int)(t % Tq);
    t /= Tq;
    const int h = (int)(t % H);
    const int b = (int)(t / H);
    out[idx] = drop.keep(b, h, i, j) ? 1 : 0;
  }
}

bool shape_ok(int B, int Tq, int Tk, int H, int D) {
  return B > 0 && H > 0 && D == kHeadDim && Tq > 0 && Tq <= kMaxT && Tk > 0 && Tk <= kMaxT;
}

Dropout make_dropout(unsigned long long seed, unsigned int thresh, float inv_keep, int on) {
  Dropout d;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.on = on;
  return d;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       int B, int Tq, int Tk, int H, int bias_per_batch, float scale,
                       Dropout drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * Tk * kPad + kWarps * kHeadDim);
  dropout_attention_fwd_kernel<T><<<(unsigned)B * (unsigned)H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), Tq, Tk, H, bias_per_batch, scale,
      drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                       int H, int bias_per_batch, float scale, Dropout drop,
                       cudaStream_t stream) {
  // <= 41,472 bytes at Tq = Tk = 32: no opt-in needed
  const size_t smem = sizeof(float) * ((size_t)(2 * Tq + 2 * Tk) * kPad + 2 * Tq * Tk);
  dropout_attention_bwd_kernel<T><<<(unsigned)B * (unsigned)H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, H, bias_per_batch, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 64 and Tq, Tk at most 32.
// thresh = uint32(rate * 2^32), inv_keep = 1 / (1 - rate), dropout_on =
// rate > 0.  Each returns the cudaError_t of its launch (0 on success).
extern "C" int sbl_small_mha_dropout_fwd_flat(const void* q, const void* k, const void* v,
                                              const void* bias, void* out, int B, int Tq,
                                              int Tk, int H, int D, int bias_per_batch,
                                              float scale, unsigned long long seed,
                                              unsigned int thresh, float inv_keep,
                                              int dropout_on, int dtype, int device,
                                              void* stream) {
  if (!shape_ok(B, Tq, Tk, H, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dropout drop = make_dropout(seed, thresh, inv_keep, dropout_on);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(q, k, v, bias, out, B, Tq, Tk, H, bias_per_batch, scale, drop, s);
    case 1: return (int)launch_fwd<__nv_bfloat16>(q, k, v, bias, out, B, Tq, Tk, H, bias_per_batch, scale, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sbl_small_mha_dropout_bwd_flat(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout, void* dq,
                                              void* dk, void* dv, int B, int Tq, int Tk, int H,
                                              int D, int bias_per_batch, float scale,
                                              unsigned long long seed, unsigned int thresh,
                                              float inv_keep, int dropout_on, int dtype,
                                              int device, void* stream) {
  if (!shape_ok(B, Tq, Tk, H, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dropout drop = make_dropout(seed, thresh, inv_keep, dropout_on);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(q, k, v, bias, dout, dq, dk, dv, B, Tq, Tk, H, bias_per_batch, scale, drop, s);
    case 1: return (int)launch_bwd<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, B, Tq, Tk, H, bias_per_batch, scale, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: (B, H, Tq, Tk) torch.bool (one byte per element).
extern "C" int sbl_dropout_keep_mask_flat(void* out, int B, int H, int Tq, int Tk,
                                          unsigned long long seed, unsigned int thresh,
                                          int device, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H * Tq * Tk;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  dropout_keep_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(out), n, H, Tq, Tk, make_dropout(seed, thresh, 0.f, 1));
  return (int)cudaGetLastError();
}
