// A block-wide tiled f32 GEMM on the CUDA cores, the f32 route of the fused
// ResNet block (resblock.cu) and the fused decoder layer (decoder_layer.cu):
//
//   C[m][n] = sum_k A(m, k) * W[n][k]      m0 <= m < m0+64, n0 <= n < n0+64
//
// W is a row-major (N, K) matrix in device memory with row stride ldw: the
// layout of the port's Dense weights (out, in) and of an OIHW conv weight
// read as (O, I*3*3), so neither is transposed on the way in.  A is given by
// a functor, so the caller can read rows from shared or device memory, or
// gather an implicit im2col patch.  The block's 256 threads stage a 64 x 32
// slice of A and of W in shared memory as f32 (stored k-major, so the inner
// loop reads both as float4), each thread accumulates a 4 x 4 tile in
// registers with k ascending, and the epilogue functor receives every
// element once: every product an f32 FMA, a true f32 GEMM, which is what
// the card's f32 check of both kernels holds their plain versions to.  The
// bf16 routes run on the tensor cores through gemm_ring.cuh.
//
// Every thread of the block must call gemm_tile with the same arguments: it
// synchronises the block.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace sbl {

constexpr int kGemmThreads = 256;
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
// floats of shared memory the staging needs: As[kTileK][kTileM] and
// Ws[kTileK][kTileN]
constexpr int kGemmStageFloats = kTileK * (kTileM + kTileN);

// AFn: int base(int m) gives a row handle for m < M; float at(int base, int k)
// the element for k < K.  EpiFn: void(int m, int n, float acc) for m < M, n < N.
template <typename T, typename AFn, typename EpiFn>
__device__ __forceinline__ void gemm_tile_fma(const AFn& a, int M, int K,
                                              const T* __restrict__ W, long long ldw, int N,
                                              int m0, int n0, float* stage, const EpiFn& epi) {
  float* As = stage;
  float* Ws = stage + kTileK * kTileM;
  const int t = threadIdx.x;
  const int rg = t & 15;   // rows rg*4 .. rg*4+3 of the tile
  const int cg = t >> 4;   // cols cg*4 .. cg*4+3 of the tile
  const int srow = t & 63;  // the tile row (of A and of W) this thread stages
  const int skc = t >> 6;   // ... and its 8 consecutive k of the 32
  const int am = m0 + srow;
  const int wn = n0 + srow;
  const bool a_ok = am < M;
  const bool w_ok = wn < N;
  const int abase = a_ok ? a.base(am) : 0;
  const T* wrow = W + (long long)(w_ok ? wn : 0) * ldw;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int kk = skc * 8 + e;
      const int k = k0 + kk;
      const bool k_ok = k < K;
      As[kk * kTileM + srow] = (a_ok && k_ok) ? a.at(abase, k) : 0.f;
      Ws[kk * kTileN + srow] = (w_ok && k_ok) ? to_f32(wrow[k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(As + kk * kTileM + rg * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Ws + kk * kTileN + cg * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cg * 4 + j;
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

// The tile in T's path: the f32 route only.
template <typename T, typename AFn, typename EpiFn>
__device__ __forceinline__ void gemm_tile(const AFn& a, int M, int K, const T* __restrict__ W,
                                          long long ldw, int N, int m0, int n0, float* stage,
                                          const EpiFn& epi) {
  static_assert(std::is_same<T, float>::value, "the bf16 routes use gemm_ring.cuh");
  gemm_tile_fma<T>(a, M, K, W, ldw, N, m0, n0, stage, epi);
}

// Rows of a row-major matrix of T (shared or device memory) as gemm_tile's A.
template <typename T>
struct RowsA {
  const T* p;
  int ld;
  __device__ __forceinline__ int base(int m) const { return m * ld; }
  __device__ __forceinline__ float at(int b, int k) const { return to_f32(p[b + k]); }
};

}  // namespace sbl
