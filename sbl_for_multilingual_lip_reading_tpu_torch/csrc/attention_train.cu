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
// What bounds them: the bytes of Q/K/V/dO and the outputs would take 0.01-
// 0.03 ms at the train step's shapes (Tq, Tk <= 31, d = 64), but the time
// is set by per-(row, key) work on CUDA cores: the Philox draw, the score
// row's passes through shared memory and the warp-serial PV loop, which a
// narrower head does not shrink (PERF.md has the readings).  Design:
//   * the head width d is a template parameter, instantiated for 16, 32, 64
//     and 128 (the widths K1 is built for): lane l owns output columns l,
//     l + 32, ... below d;
//   * one block of 4 warps per (batch row, head).  The head's K and V (in
//     K4 also Q and dO) are staged whole in shared memory as f32, each row
//     padded by one float so that lanes reading different rows hit
//     different banks.  K4 also keeps dS and the dropped P of the whole
//     (query, key) tile there, so the sums over queries for dK and dV stay
//     inside the block: one warp per key row, no atomics.  Shared memory
//     grows with Tq, Tk and d (41 KB for K4 at Tq = Tk = 32, d = 64); past
//     48 KB the launch opts in, up to the card's 227 KB a block, which
//     bounds the lengths the kernels take (Tq = Tk <= 116 at d = 64, 84 at
//     d = 128; smem_bytes below, mirrored by ops/attention.py);
//   * one warp per query row, the keys in tiles of 32, lane l owning keys
//     l, l + 32, ...: a row's scores go to a per-warp row of shared memory,
//     its max and sum by shuffles over the lanes' partial ones, an f32
//     softmax normalised before the mask is applied (as the JAX kernel
//     orders it), one Philox draw per (row, key).
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
constexpr int kMaxSmem = 232448;  // the card's dynamic shared memory a block

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

// Copy a head's (n, D) rows of a flat (.., T, H*D) tensor into shared memory
// as f32 rows of stride D + 1.  src points at row 0 of the head.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long row_stride, int n,
                                      float* dst) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r * (D + 1) + c] = to_f32(src[(long long)r * row_stride + c]);
  }
}

// The softmax weights P[row, j] of one query row, j < Tk, into prow (a
// per-warp shared row): the scores q . k_j * scale + bias, their max and
// sum over the lanes' partial ones, normalised as e / sum(e).  Lane l
// writes (and later reads) only keys l, l + 32, ...; the caller syncs the
// warp before other lanes read them.
template <int D>
__device__ __forceinline__ void softmax_row(const float* qrow, const float* ks, const float* bb,
                                            int row, int Tk, float scale, int lane,
                                            float* prow) {
  constexpr int kPad = D + 1;
  float mx = -INFINITY;
  for (int j = lane; j < Tk; j += 32) {
    float dot = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], ks[j * kPad + c], dot);
    float s = dot * scale;
    if (bb != nullptr) s += bb[(long long)row * Tk + j];
    prow[j] = s;
    mx = fmaxf(mx, s);
  }
  const float m = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < Tk; j += 32) {
    const float e = expf(prow[j] - m);
    prow[j] = e;
    sum += e;
  }
  const float total = warp_sum(sum);
  for (int j = lane; j < Tk; j += 32) prow[j] = prow[j] / total;
}

// Bytes of dynamic shared memory the forward (backward = 0) or backward
// (1) kernel takes at these lengths; ops/attention.py mirrors it.
__host__ __device__ inline long long smem_bytes(int Tq, int Tk, int D, int backward) {
  const long long pad = D + 1;
  if (!backward) return 4LL * (2LL * Tk * pad + (long long)kWarps * D + (long long)kWarps * Tk);
  return 4LL * ((2LL * Tq + 2LL * Tk) * pad + 2LL * Tq * Tk + (long long)kWarps * Tk);
}

// q: (B, Tq, H*D); k, v: (B, Tk, H*D); bias: null or (1|B, Tq, Tk) f32;
// out: (B, Tq, H*D).  Grid: B*H blocks of kWarps warps.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
dropout_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, int Tq, int Tk, int H, int bias_per_batch,
                             float scale, Dropout drop) {
  constexpr int kPad = D + 1;
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* ks = smem;              // [Tk][kPad]
  float* vs = ks + Tk * kPad;    // [Tk][kPad]
  float* qs = vs + Tk * kPad;    // [kWarps][D], one query row per warp
  float* ps = qs + kWarps * D;   // [kWarps][Tk], its probabilities

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rs = (long long)H * D;
  const long long head = (long long)h * D;
  const T* qb = q + (long long)b * Tq * rs + head;
  T* ob = out + (long long)b * Tq * rs + head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage<T, D>(k + (long long)b * Tk * rs + head, rs, Tk, ks);
  stage<T, D>(v + (long long)b * Tk * rs + head, rs, Tk, vs);
  __syncthreads();

  float* qrow = qs + warp * D;
  float* prow = ps + warp * Tk;
  for (int row = warp; row < Tq; row += kWarps) {
    for (int c = lane; c < D; c += 32) qrow[c] = to_f32(qb[(long long)row * rs + c]);
    __syncwarp();
    softmax_row<D>(qrow, ks, bb, row, Tk, scale, lane, prow);
    if (drop.on)
      for (int j = lane; j < Tk; j += 32)
        prow[j] = drop.keep(b, h, row, j) ? prow[j] * drop.inv_keep : 0.f;
    __syncwarp();
    float acc[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) acc[m] = 0.f;
    for (int j = 0; j < Tk; ++j) {
      const float pj = prow[j];
#pragma unroll
      for (int m = 0; m < kCols; ++m)
        if (lane + 32 * m < D) acc[m] = fmaf(pj, vs[j * kPad + lane + 32 * m], acc[m]);
    }
#pragma unroll
    for (int m = 0; m < kCols; ++m)
      if (lane + 32 * m < D) ob[(long long)row * rs + lane + 32 * m] = from_f32<T>(acc[m]);
    __syncwarp();  // this warp's query and probability rows are rewritten next round
  }
}

// K3's inputs plus dout: (B, Tq, H*D); writes dq (B, Tq, H*D) and dk, dv
// (B, Tk, H*D).  Grid: B*H blocks of kWarps warps.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
dropout_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             const T* __restrict__ dout, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H,
                             int bias_per_batch, float scale, Dropout drop) {
  constexpr int kPad = D + 1;
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;              // [Tq][kPad]
  float* gs = qs + Tq * kPad;    // [Tq][kPad]  dO
  float* ks = gs + Tq * kPad;    // [Tk][kPad]
  float* vs = ks + Tk * kPad;    // [Tk][kPad]
  float* dss = vs + Tk * kPad;   // [Tq][Tk]    P, then dS
  float* pds = dss + Tq * Tk;    // [Tq][Tk]    P after dropout
  float* dps = pds + Tq * Tk;    // [kWarps][Tk] a row's dP after dropout

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rs = (long long)H * D;
  const long long head = (long long)h * D;
  const long long qoff = (long long)b * Tq * rs + head;
  const long long koff = (long long)b * Tk * rs + head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage<T, D>(q + qoff, rs, Tq, qs);
  stage<T, D>(dout + qoff, rs, Tq, gs);
  stage<T, D>(k + koff, rs, Tk, ks);
  stage<T, D>(v + koff, rs, Tk, vs);
  __syncthreads();

  // rows of dS and P_drop, and dQ = dS K * scale
  float* dprow = dps + warp * Tk;
  for (int row = warp; row < Tq; row += kWarps) {
    float* prow = dss + row * Tk;
    softmax_row<D>(qs + row * kPad, ks, bb, row, Tk, scale, lane, prow);
    const float* grow = gs + row * kPad;
    float part = 0.f;  // this lane's share of rowsum(dP o P)
    for (int j = lane; j < Tk; j += 32) {
      float dpd = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dpd = fmaf(grow[c], vs[j * kPad + c], dpd);
      const float p = prow[j];
      float pd = p, dp = dpd;
      if (drop.on) {
        const bool keep = drop.keep(b, h, row, j);
        pd = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dpd * drop.inv_keep : 0.f;
      }
      pds[row * Tk + j] = pd;
      dprow[j] = dp;
      part = fmaf(dp, p, part);
    }
    const float rowsum = warp_sum(part);
    for (int j = lane; j < Tk; j += 32) prow[j] = prow[j] * (dprow[j] - rowsum);
    __syncwarp();
    float acc[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) acc[m] = 0.f;
    for (int j = 0; j < Tk; ++j) {
      const float dsj = prow[j];
#pragma unroll
      for (int m = 0; m < kCols; ++m)
        if (lane + 32 * m < D) acc[m] = fmaf(dsj, ks[j * kPad + lane + 32 * m], acc[m]);
    }
#pragma unroll
    for (int m = 0; m < kCols; ++m)
      if (lane + 32 * m < D) dq[qoff + (long long)row * rs + lane + 32 * m] = from_f32<T>(acc[m] * scale);
    __syncwarp();  // dprow is rewritten next round
  }
  __syncthreads();

  // dK = dS^T Q * scale and dV = P_drop^T dO, one warp per key row
  for (int j = warp; j < Tk; j += kWarps) {
    float ka[kCols], va[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) ka[m] = va[m] = 0.f;
    for (int i = 0; i < Tq; ++i) {
      const float ds = dss[i * Tk + j];
      const float pd = pds[i * Tk + j];
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        if (lane + 32 * m < D) {
          ka[m] = fmaf(ds, qs[i * kPad + lane + 32 * m], ka[m]);
          va[m] = fmaf(pd, gs[i * kPad + lane + 32 * m], va[m]);
        }
      }
    }
    const long long o = koff + (long long)j * rs;
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      if (lane + 32 * m < D) {
        dk[o + lane + 32 * m] = from_f32<T>(ka[m] * scale);
        dv[o + lane + 32 * m] = from_f32<T>(va[m]);
      }
    }
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
  return B > 0 && H > 0 && (D == 16 || D == 32 || D == 64 || D == 128) && Tq > 0 && Tk > 0 &&
         smem_bytes(Tq, Tk, D, 0) <= kMaxSmem && smem_bytes(Tq, Tk, D, 1) <= kMaxSmem;
}

Dropout make_dropout(unsigned long long seed, unsigned int thresh, float inv_keep, int on) {
  Dropout d;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.on = on;
  return d;
}

// Launch kernel with smem bytes of dynamic shared memory, opting in past
// the 48 KB a launch gets without.
template <typename Kernel, typename... Args>
cudaError_t launch_with(Kernel kernel, unsigned blocks, size_t smem, cudaStream_t stream,
                        Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kWarps * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       int B, int Tq, int Tk, int H, int bias_per_batch, float scale,
                       Dropout drop, cudaStream_t stream) {
  return launch_with(dropout_attention_fwd_kernel<T, D>, (unsigned)B * (unsigned)H,
                     (size_t)smem_bytes(Tq, Tk, D, 0), stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const float*>(bias), static_cast<T*>(out), Tq, Tk, H,
                     bias_per_batch, scale, drop);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                       int H, int bias_per_batch, float scale, Dropout drop,
                       cudaStream_t stream) {
  return launch_with(dropout_attention_bwd_kernel<T, D>, (unsigned)B * (unsigned)H,
                     (size_t)smem_bytes(Tq, Tk, D, 1), stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const float*>(bias), static_cast<const T*>(dout),
                     static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, H,
                     bias_per_batch, scale, drop);
}

// Return LAUNCH's instantiation for the launch's dtype (0 = float32, 1 =
// bfloat16) and head width D, called with the remaining arguments.
#define SBL_TRAIN_DISPATCH(LAUNCH, ...)                                                    \
  switch (dtype * 1000 + D) {                                                            \
    case 16: return (int)LAUNCH<float, 16>(__VA_ARGS__);                                  \
    case 32: return (int)LAUNCH<float, 32>(__VA_ARGS__);                                  \
    case 64: return (int)LAUNCH<float, 64>(__VA_ARGS__);                                  \
    case 128: return (int)LAUNCH<float, 128>(__VA_ARGS__);                                \
    case 1016: return (int)LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__);                        \
    case 1032: return (int)LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                        \
    case 1064: return (int)LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                        \
    case 1128: return (int)LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                       \
    default: return (int)cudaErrorInvalidValue;                                          \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128}; Tq, Tk such that
// smem_bytes fits a block (kMaxSmem).
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
  SBL_TRAIN_DISPATCH(launch_fwd, q, k, v, bias, out, B, Tq, Tk, H, bias_per_batch, scale, drop, s)
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
  SBL_TRAIN_DISPATCH(launch_bwd, q, k, v, bias, dout, dq, dk, dv, B, Tq, Tk, H, bias_per_batch, scale, drop, s)
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
