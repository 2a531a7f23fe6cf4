// K1: fused small-sequence multi-head attention on the projections' flat
// (B, T, H*d) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/attention.py::fused_small_mha_flat of the JAX
// package: out = softmax(Q K^T * scale + bias) V per (batch row, head), with
// the head split and merge done inside the kernel and an f32 softmax.
//
// What bounds it: at this model's shapes (T <= 30, d = 64) one head's scores
// are at most 30 x 30, so the kernel does ~0.25 MFLOP per (batch, head) and
// is bound by launch count and by the bytes of Q/K/V/out, not by FLOPs.  The
// design therefore reads each Q/K/V/out element once and keeps the scores
// out of device memory:
//   * one block per (batch row, head);
//   * the head's K and V are staged in shared memory as f32, in chunks of
//     at most kChunk keys (K rows padded by one float so that lanes reading
//     different keys hit different banks); the shared memory is sized by
//     the chunk actually used (min(Tk, kChunk) keys), and registers are
//     capped (__launch_bounds__) so that 12 blocks of 4 warps share an SM
//     (a block takes 10 KB of shared memory at Tk = 17);
//   * one warp per query row; lane j scores key j of a 32-key slice, the
//     warp takes max and sum with shuffles, and an online (running max)
//     softmax carries across slices, so any Tk works;
//   * each lane accumulates two of the 64 output channels (lane, lane+32).
// Operands are upcast to f32 as the JAX kernel does (_OPERAND_DT); the
// output is rounded once to the input dtype.  wgmma/TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using sbl::from_f32;
using sbl::to_f32;
using sbl::warp_max;
using sbl::warp_sum;

constexpr int kWarps = 4;
constexpr int kMinBlocksPerSM = 12;
constexpr int kHeadDim = 64;             // d: the model's d_k = d_v
constexpr int kPerLane = kHeadDim / 32;  // output channels per lane
constexpr int kChunk = 64;               // keys staged in shared memory per pass

// floats of dynamic shared memory for a chunk of nk keys:
// K [nk][d + 1], V [nk][d], one query row per warp [kWarps][d]
constexpr int smem_floats(int nk) {
  return nk * (kHeadDim + 1) + nk * kHeadDim + kWarps * kHeadDim;
}

// q: (B, Tq, H*d); k, v: (B, Tk, H*d); bias: null or (1|B, Tq, Tk) f32;
// out: (B, Tq, H*d).  Grid: B*H blocks of kWarps warps.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocksPerSM)
small_mha_flat_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, int Tq, int Tk, int H,
                      int bias_per_batch, float scale) {
  constexpr int D = kHeadDim;
  extern __shared__ float smem[];
  const int nk = min(Tk, kChunk);   // rows of the staged chunk
  float* ks = smem;                 // [nk][D + 1]
  float* vs = ks + nk * (D + 1);    // [nk][D]
  float* qs = vs + nk * D;          // [kWarps][D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row_stride = (long long)H * D;
  const T* qb = q + (long long)b * Tq * row_stride + (long long)h * D;
  const T* kb = k + (long long)b * Tk * row_stride + (long long)h * D;
  const T* vb = v + (long long)b * Tk * row_stride + (long long)h * D;
  T* ob = out + (long long)b * Tq * row_stride + (long long)h * D;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  const int n_chunks = (Tk + kChunk - 1) / kChunk;
  auto load_chunk = [&](int c0) {
    const int n = min(kChunk, Tk - c0);
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
      const int j = i / D;
      const int c = i % D;
      const long long src = (long long)(c0 + j) * row_stride + c;
      ks[j * (D + 1) + c] = to_f32(kb[src]);
      vs[j * D + c] = to_f32(vb[src]);
    }
  };
  if (n_chunks == 1) {
    load_chunk(0);
    __syncthreads();
  }

  // every warp runs the same number of row rounds, so the block-wide
  // barriers of the multi-chunk path are reached uniformly
  for (int r0 = 0; r0 < Tq; r0 += kWarps) {
    const int row = r0 + warp;
    const bool active = row < Tq;
    if (active) {
      for (int c = lane; c < D; c += 32) qs[warp * D + c] = to_f32(qb[(long long)row * row_stride + c]);
    }
    __syncwarp();
    float m = -INFINITY;
    float l = 0.f;
    float acc[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) acc[c] = 0.f;

    for (int ci = 0; ci < n_chunks; ++ci) {
      const int c0 = ci * kChunk;
      if (n_chunks > 1) {
        __syncthreads();
        load_chunk(c0);
        __syncthreads();
      }
      if (!active) continue;
      const int n = min(kChunk, Tk - c0);
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        float s = -INFINITY;
        if (j < n) {
          float dot = 0.f;
#pragma unroll 16
          for (int c = 0; c < D; ++c) dot = fmaf(qs[warp * D + c], ks[j * (D + 1) + c], dot);
          s = dot * scale;
          if (bb != nullptr) s += bb[(long long)row * Tk + c0 + j];
        }
        const float m_new = fmaxf(m, warp_max(s));
        const float corr = expf(m - m_new);
        const float p = (j < n) ? expf(s - m_new) : 0.f;
        l = l * corr + warp_sum(p);
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) acc[c] *= corr;
        const int jn = min(32, n - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
          for (int c = 0; c < kPerLane; ++c) acc[c] = fmaf(pj, vs[(j0 + jj) * D + lane + 32 * c], acc[c]);
        }
        m = m_new;
      }
    }
    if (active) {
      const float inv = 1.f / l;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        ob[(long long)row * row_stride + lane + 32 * c] = from_f32<T>(acc[c] * inv);
    }
    __syncwarp();  // this warp's qs row is rewritten in the next round
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, int Tq, int Tk, int H, int bias_per_batch, float scale,
                   cudaStream_t stream) {
  const int nk = Tk < kChunk ? Tk : kChunk;
  const size_t smem = sizeof(float) * (size_t)smem_floats(nk);  // <= 34 KB: no opt-in needed
  small_mha_flat_kernel<T><<<(unsigned)B * (unsigned)H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), Tq, Tk, H, bias_per_batch, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 64.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int sbl_small_mha_flat(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, int B, int Tq, int Tk, int H, int D,
                                  int bias_per_batch, float scale, int dtype, int device,
                                  void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || D != kHeadDim) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(q, k, v, bias, out, B, Tq, Tk, H, bias_per_batch, scale, s);
    case 1: return (int)launch<__nv_bfloat16>(q, k, v, bias, out, B, Tq, Tk, H, bias_per_batch, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
