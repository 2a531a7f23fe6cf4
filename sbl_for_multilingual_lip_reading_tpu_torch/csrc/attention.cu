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
// The head width d is a template parameter, built for 16, 32, 64 and 128.
//
// What bounds it: the bytes.  At the recognize path's shapes one head's
// scores are at most 30 x 30, ~0.25 MFLOP per (batch row, head) at d = 64,
// so the whole call is a few hundred MFLOP (under a microsecond of the
// card's bf16 tensor-core rate) against the bytes of Q, K, V and the output
// read or written once: in bf16 the encoder's (512,30,512) moves 62.9 MB
// (18.8 us at 3.35 TB/s), the decoder's self-attention (1024,17,512) 71.3 MB
// (21.3 us), its cross-attention (1024,17)x(1024,30) 98.6 MB (29.4 us), the
// unidirectional decoder's cached cross-attention (512,1)x(512,30) 32.5 MB
// (9.7 us).
//
// The bf16 body (small_mha_mma_kernel, which runs sbl::mha_fwd_block of
// mma.cuh; K3 runs the same body with its dropout) is built so that
// nothing but those bytes costs time:
//   * one block per (batch row, head), one warp per 16 query rows (at most
//     kMaxMmaWarps; more rows take more rounds), so the encoder's 30 rows
//     are two warps and a cached decode step's one row is one;
//   * Q, K and V are staged in shared memory as bf16 by 16-byte cp.async.cg
//     copies (a d = 64 row is 128 contiguous bytes, one cache line); rows
//     past Tq / Tk are zero-filled by the copy (src-size 0), and each staged
//     row is padded by 16 bytes so that the eight row addresses of an
//     ldmatrix fall in eight different bank groups (no conflicts at any d);
//   * Q K^T and P V run on the tensor cores, mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate) fed by ldmatrix (ldmatrix.trans for V); wgmma's
//     64-row tiles do not fit one head's 30 x 30 scores, and the kernel is
//     bound by bytes, not by the tensor cores' rate;
//   * the scores stay in registers: keys past Tk are set to -inf, the
//     bias elements a lane needs are loaded while the copies are in flight,
//     exp is the hardware's ex2 (__expf: ~2^-21 relative, far inside a bf16
//     ulp, and no slow path for the -1e9 of a masked key), the row max and
//     row sum are taken across the quad that holds a row with two shuffles
//     each, and an online (running max) softmax carries across key
//     tiles of kKeyTile keys, so any Tk works (K and V are staged again per
//     tile and per round of rows when there is more than one tile);
//   * P is reused from the score registers as the A operand of P V (the
//     FlashAttention-2 register layout), split into hi = bf16(P) and
//     lo = bf16(P - hi) with both products issued: the JAX kernel multiplies
//     P V with f32 operands (_OPERAND_DT), and the split keeps P to ~2^-17
//     of itself, so the output stays within an output ulp of the plain
//     f32-upcast version at twice a P V mma, which costs nothing here;
//   * the output is rounded once to bf16 and stored from the accumulator
//     registers.
// Shared memory per block: (2 * kKeyTile + 16 * warps) rows of (d + 8)
// bf16, 13.8 KB for the encoder's two warps at d = 64 (34.8 KB at most, d =
// 128 with four warps); no opt-in above 48 KB is needed.  Registers bound
// the occupancy instead (ptxas: 127 a thread at d = 64, no spills): 8
// two-warp blocks share an SM and keep ~120 KB of copies in flight on it.
//
// f32 inputs keep a scalar body (small_mha_f32_kernel: one warp per query
// row, lane j scoring key j of a 32-key slice with f32 FMAs from f32 staged
// K and V): a TF32 mma would break the f32 check's 1e-5 tolerance, and the
// f32 route is the card's f32 check route, not the main path (which runs
// bf16).  Operands are upcast to f32 as the JAX kernel does; the output is
// rounded once to the input dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using sbl::bf16;
using sbl::kMaxMmaWarps;
using sbl::warp_max;
using sbl::warp_sum;

// Element strides of one launch: q and out share a layout, k and v share
// one; every sequence position is `row` elements after the one before.
struct Layout {
  long long q_batch, q_head;   // q / out
  long long k_batch, k_head;   // k / v
  long long row;
  long long bias_batch, bias_head;  // 0 where the bias broadcasts
};

// (B, T, H*d): a row holds every head; bias (1|B, Tq, Tk)
Layout flat_layout(int Tq, int Tk, int H, int D, int bias_per_batch) {
  const long long rs = (long long)H * D;
  return Layout{Tq * rs, D, Tk * rs, D, rs, bias_per_batch ? (long long)Tq * Tk : 0LL, 0LL};
}

// (B, H, T, d): a head holds T rows; bias (B, 1|H, Tq, Tk)
Layout head_major_layout(int Tq, int Tk, int H, int D, long long bias_batch,
                         long long bias_head) {
  return Layout{(long long)H * Tq * D, (long long)Tq * D, (long long)H * Tk * D,
                (long long)Tk * D, D, bias_batch, bias_head};
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (the body is sbl::mha_fwd_block, mma.cuh)
// ---------------------------------------------------------------------------

// q, out: Tq rows of D per (batch row, head); k, v: Tk rows; bias: null or
// a (Tq, Tk) f32 block per (batch row, head) at the layout's strides.
// Grid: B*H blocks of min(ceil(Tq / 16), kMaxMmaWarps) warps.
template <int D>
__global__ void __launch_bounds__(kMaxMmaWarps * 32)
small_mha_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, int Tq, int Tk, int H, Layout lay, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long qoff = b * lay.q_batch + h * lay.q_head;
  const long long koff = b * lay.k_batch + h * lay.k_head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + b * lay.bias_batch + h * lay.bias_head;
  sbl::mha_fwd_block<D>(q + qoff, k + koff, v + koff, bb, out + qoff, lay.row, Tq, Tk, scale,
                        sbl::NoDropout{}, reinterpret_cast<bf16*>(smem_raw));
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out,
                        int B, int Tq, int Tk, int H, Layout lay, float scale,
                        cudaStream_t stream) {
  const int m_tiles = (Tq + 15) / 16;
  const int warps = m_tiles < kMaxMmaWarps ? m_tiles : kMaxMmaWarps;
  const size_t smem = sizeof(bf16) * (size_t)sbl::mma_smem_elems(D, warps);  // <= 34.8 KB
  small_mha_mma_kernel<D><<<(unsigned)B * (unsigned)H, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), Tq, Tk, H, lay, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the scalar body
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
// registers are capped so that 12 blocks of 4 warps share an SM (8 at d = 128)
__host__ __device__ constexpr int f32_min_blocks(int D) { return D <= 64 ? 12 : 8; }

// keys staged in shared memory per pass (34.9 KB at most: no opt-in)
__host__ __device__ constexpr int f32_chunk(int D) { return D <= 64 ? 64 : 32; }

// floats of dynamic shared memory for a chunk of nk keys:
// K [nk][D + 1], V [nk][D], one query row per warp [kF32Warps][D]
__host__ __device__ constexpr int f32_smem_floats(int D, int nk) {
  return nk * (D + 1) + nk * D + kF32Warps * D;
}

// One block per (batch row, head) of kF32Warps warps, one warp per query
// row: lane j scores key j of a 32-key slice (K rows padded by one float so
// lanes reading different keys hit different banks), the warp takes max and
// sum with shuffles, an online softmax carries across slices and chunks,
// and each lane accumulates output channels lane, lane + 32, ...
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32, f32_min_blocks(D))
small_mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int Tq, int Tk, int H, Layout lay, float scale) {
  constexpr int kChunk = f32_chunk(D);
  constexpr int kPerLane = (D + 31) / 32;  // output channels per lane
  extern __shared__ float smem[];
  const int nk = min(Tk, kChunk);  // rows of the staged chunk
  float* ks = smem;                // [nk][D + 1]
  float* vs = ks + nk * (D + 1);   // [nk][D]
  float* qs = vs + nk * D;         // [kF32Warps][D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row_stride = lay.row;
  const long long qoff = b * lay.q_batch + h * lay.q_head;
  const long long koff = b * lay.k_batch + h * lay.k_head;
  const float* qb = q + qoff;
  const float* kb = k + koff;
  const float* vb = v + koff;
  float* ob = out + qoff;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + b * lay.bias_batch + h * lay.bias_head;

  const int n_chunks = (Tk + kChunk - 1) / kChunk;
  auto load_chunk = [&](int c0) {
    const int n = min(kChunk, Tk - c0);
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
      const int j = i / D;
      const int c = i % D;
      const long long src = (long long)(c0 + j) * row_stride + c;
      ks[j * (D + 1) + c] = kb[src];
      vs[j * D + c] = vb[src];
    }
  };
  if (n_chunks == 1) {
    load_chunk(0);
    __syncthreads();
  }

  // every warp runs the same number of row rounds, so the block-wide
  // barriers of the multi-chunk path are reached uniformly
  for (int r0 = 0; r0 < Tq; r0 += kF32Warps) {
    const int row = r0 + warp;
    const bool active = row < Tq;
    if (active) {
      for (int c = lane; c < D; c += 32) qs[warp * D + c] = qb[(long long)row * row_stride + c];
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
          for (int c = 0; c < kPerLane; ++c) {
            if (lane + 32 * c < D) acc[c] = fmaf(pj, vs[(j0 + jj) * D + lane + 32 * c], acc[c]);
          }
        }
        m = m_new;
      }
    }
    if (active) {
      const float inv = 1.f / l;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        if (lane + 32 * c < D) ob[(long long)row * row_stride + lane + 32 * c] = acc[c] * inv;
      }
    }
    __syncwarp();  // this warp's qs row is rewritten in the next round
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias, void* out,
                       int B, int Tq, int Tk, int H, Layout lay, float scale,
                       cudaStream_t stream) {
  const int nk = Tk < f32_chunk(D) ? Tk : f32_chunk(D);
  const size_t smem = sizeof(float) * (size_t)f32_smem_floats(D, nk);
  small_mha_f32_kernel<D><<<(unsigned)B * (unsigned)H, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), Tq, Tk, H, lay, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_width(const void* q, const void* k, const void* v, const void* bias, void* out,
                         int B, int Tq, int Tk, int H, Layout lay, float scale, int dtype,
                         cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_f32<D>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, s);
    case 1: return launch_bf16<D>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int launch_dtype(const void* q, const void* k, const void* v, const void* bias, void* out,
                 int B, int Tq, int Tk, int H, int D, Layout lay, float scale, int dtype,
                 int device, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  // the bf16 body stages rows by 16-byte copies
  if (dtype == 1 && !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_width<16>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, dtype, s);
    case 32: return (int)launch_width<32>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, dtype, s);
    case 64: return (int)launch_width<64>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, dtype, s);
    case 128:
      return (int)launch_width<128>(q, k, v, bias, out, B, Tq, Tk, H, lay, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D (the head width) in {16, 32, 64,
// 128}; bf16 pointers 16-byte aligned.  Each returns the cudaError_t of its
// launch (0 on success).

// K1: q (B, Tq, H*D), k, v (B, Tk, H*D), bias null or (1|B, Tq, Tk).
extern "C" int sbl_small_mha_flat(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, int B, int Tq, int Tk, int H, int D,
                                  int bias_per_batch, float scale, int dtype, int device,
                                  void* stream) {
  return launch_dtype(q, k, v, bias, out, B, Tq, Tk, H, D,
                      flat_layout(Tq, Tk, H, D, bias_per_batch), scale, dtype, device, stream);
}

// K12: q (B, H, Tq, D), k, v (B, H, Tk, D), bias null or (B, 1|H, Tq, Tk)
// with element strides bias_batch, bias_head (0 where it broadcasts over
// the heads).
extern "C" int sbl_fused_mha(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int H, int Tq, int Tk, int D,
                             long long bias_batch, long long bias_head, float scale, int dtype,
                             int device, void* stream) {
  return launch_dtype(q, k, v, bias, out, B, Tq, Tk, H, D,
                      head_major_layout(Tq, Tk, H, D, bias_batch, bias_head), scale, dtype,
                      device, stream);
}
