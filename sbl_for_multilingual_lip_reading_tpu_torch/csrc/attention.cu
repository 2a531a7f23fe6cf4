// K1: fused small-sequence multi-head attention on the projections' flat
// (B, T, H*d) layout, and K12: the same kernel on the head-major (B, H, T, d)
// layout, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package's ops/attention.py:
//   K1  fused_small_mha_flat: out = softmax(Q K^T * scale + bias) V per
//       (batch row, head), with the head split and merge done inside the
//       kernel and an f32 softmax; bias (1|B, Tq, Tk), shared by the heads;
//   K12 fused_mha, the legacy head-major kernel with grid (B, H): the same
//       math on q/k/v (B, H, T, d) and a bias (B, 1|H, Tq, Tk) that may
//       differ per head.
// One kernel body serves both: a block reads its (batch row, head) through
// the strides of a Layout (batch, head and sequence-position strides of
// q/out and of k/v, and the bias's batch and head strides, 0 where it
// broadcasts), so the two layouts cost no copy.  The JAX package's
// (B, T, H, d) twins (fused_small_mha and its train-side relatives) have
// the bytes of the flat layout and launch K1 (and K3/K4) on its view.
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

// Element strides of one launch: q and out share a layout, k and v share
// one; every sequence position is `row` elements after the one before.
struct Layout {
  long long q_batch, q_head;   // q / out
  long long k_batch, k_head;   // k / v
  long long row;
  long long bias_batch, bias_head;  // 0 where the bias broadcasts
};

// (B, T, H*d): a row holds every head; bias (1|B, Tq, Tk)
Layout flat_layout(int Tq, int Tk, int H, int bias_per_batch) {
  const long long rs = (long long)H * kHeadDim;
  return Layout{Tq * rs, kHeadDim, Tk * rs, kHeadDim, rs,
                bias_per_batch ? (long long)Tq * Tk : 0LL, 0LL};
}

// (B, H, T, d): a head holds T rows; bias (B, 1|H, Tq, Tk)
Layout head_major_layout(int Tq, int Tk, int H, long long bias_batch, long long bias_head) {
  return Layout{(long long)H * Tq * kHeadDim, (long long)Tq * kHeadDim,
                (long long)H * Tk * kHeadDim, (long long)Tk * kHeadDim, kHeadDim,
                bias_batch, bias_head};
}

// q, out: Tq rows of d per (batch row, head); k, v: Tk rows; bias: null or
// a (Tq, Tk) f32 block per (batch row, head) at the layout's strides.
// Grid: B*H blocks of kWarps warps.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocksPerSM)
small_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int Tq, int Tk, int H, Layout lay, float scale) {
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
  const long long row_stride = lay.row;
  const long long qoff = b * lay.q_batch + h * lay.q_head;
  const long long koff = b * lay.k_batch + h * lay.k_head;
  const T* qb = q + qoff;
  const T* kb = k + koff;
  const T* vb = v + koff;
  T* ob = out + qoff;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + b * lay.bias_batch + h * lay.bias_head;

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
                   int B, int Tq, int Tk, int H, Layout lay, float scale, cudaStream_t stream) {
  const int nk = Tk < kChunk ? Tk : kChunk;
  const size_t smem = sizeof(float) * (size_t)smem_floats(nk);  // <= 34 KB: no opt-in needed
  small_mha_kernel<T><<<(unsigned)B * (unsigned)H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), Tq, Tk, H, lay, scale);
  return cudaGetLastError();
}

int launch_dtype(const void* q, const void* k, const void* v, const void* bias, void* out,
                 int B, int Tq, int Tk, int H, int D, Layout lay, float scale, int dtype,
                 int device, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || D != kHeadDim) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, s);
    case 1: return (int)launch<__nv_bfloat16>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 64.  Each returns the
// cudaError_t of its launch (0 on success).

// K1: q (B, Tq, H*D), k, v (B, Tk, H*D), bias null or (1|B, Tq, Tk).
extern "C" int sbl_small_mha_flat(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, int B, int Tq, int Tk, int H, int D,
                                  int bias_per_batch, float scale, int dtype, int device,
                                  void* stream) {
  return launch_dtype(q, k, v, bias, out, B, Tq, Tk, H, D,
                      flat_layout(Tq, Tk, H, bias_per_batch), scale, dtype, device, stream);
}

// K12: q (B, H, Tq, D), k, v (B, H, Tk, D), bias null or (B, 1|H, Tq, Tk)
// with element strides bias_batch, bias_head (0 where it broadcasts over
// the heads).
extern "C" int sbl_fused_mha(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int H, int Tq, int Tk, int D,
                             long long bias_batch, long long bias_head, float scale, int dtype,
                             int device, void* stream) {
  return launch_dtype(q, k, v, bias, out, B, Tq, Tk, H, D,
                      head_major_layout(Tq, Tk, H, bias_batch, bias_head), scale, dtype,
                      device, stream);
}
