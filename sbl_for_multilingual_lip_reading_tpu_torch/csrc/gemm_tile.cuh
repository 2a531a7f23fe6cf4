// A block-wide tiled GEMM with f32 accumulation, shared by the fused
// ResNet block (resblock.cu) and the fused decoder layer (decoder_layer.cu).
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
// element once.  That is the f32 path (gemm_tile_fma): CUDA cores, every
// product an f32 FMA, a true f32 GEMM.
//
// The bf16 path (gemm_tile_mma) runs the same tile on the tensor cores
// through warp-level mma (nvcuda::wmma, 16 x 16 x 16 bf16 fragments, f32
// accumulators): 64 x 64 slices are staged as bf16 (rows padded to 72
// elements) with 16-byte loads, eight neighbouring threads to a row's 128
// bytes; each of the 8 warps owns a 16 x 32 piece of the tile; the next two
// slices are in flight in registers while the current one multiplies; and
// the accumulators pass through the same shared memory to reach the
// epilogue functor in the f32 path's thread layout.  Staging, not the mma,
// bounds it (PERF.md); wgmma with TMA-fed stages is later work.
//
// Every thread of the block must call gemm_tile with the same arguments: it
// synchronises the block.
#pragma once

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace sbl {

constexpr int kGemmThreads = 256;
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;  // the f32 path's k step
constexpr int kMmaK = 64;   // the bf16 path's k step
// floats of shared memory the staging needs: the f32 path's As[kTileK][kTileM]
// and Ws[kTileK][kTileN]; the bf16 path's two [64][kMmaK + 8] bf16 slices,
// then its 64 x 64 f32 result
constexpr int kGemmStageFloats = 2 * kTileM * (kMmaK + 8) / 2;
static_assert(kGemmStageFloats >= kTileK * (kTileM + kTileN), "f32 staging fits");

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

// The bf16 tile on the tensor cores.  AFn also needs raw(base, k), the
// element as stored, and for runs of 8 elements from a k that is a multiple
// of 8, vec_ok(base, k) (the run is contiguous and 16-byte aligned) and
// raw8(base, k), the run as one 16-byte load.  It walks K in steps of kMmaK = 64: stage holds
// As[64][72] and Ws[64][72] in bf16 during the k loop and the 64 x 64 f32
// result after it.  Each thread stages 8 consecutive k of two rows of A and
// of W (8 neighbouring threads read one row's 128 contiguous bytes); the
// operands of the next two steps are in flight in registers while
// the current step multiplies, so the loads' latency (L2 for the weights)
// runs under two steps of tensor-core work instead of in front of each.
template <typename AFn, typename EpiFn>
__device__ void gemm_tile_mma(const AFn& a, int M, int K, const __nv_bfloat16* __restrict__ W,
                              long long ldw, int N, int m0, int n0, float* stage,
                              const EpiFn& epi) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int LD = kMmaK + 8;
  static_assert(2 * kTileM * LD * sizeof(bf16) <= kGemmStageFloats * sizeof(float) &&
                    kTileM * kTileN <= kGemmStageFloats && kGemmThreads * 16 == kTileM * kMmaK,
                "the staging area holds both operand slices, then the result");
  bf16* As = reinterpret_cast<bf16*>(stage);
  bf16* Ws = As + kTileM * LD;
  float* Cs = stage;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int wm = warp >> 1;  // rows wm*16 .. +15
  const int wn = warp & 1;   // cols wn*32 .. +31
  const int rg = t & 15;
  const int cg = t >> 4;
  // staging: a thread takes the 8 elements from k = chunk*8 of rows srow and
  // srow + 32 of both slices, so that 8 neighbouring threads read one row's
  // 128 contiguous bytes
  const int chunk = t & 7;
  const int srow = t >> 3;
  bool a_ok[2], w_ok[2];
  int abase[2];
  const bf16* wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int am = m0 + srow + 32 * h;
    const int wn_ = n0 + srow + 32 * h;
    a_ok[h] = am < M;
    w_ok[h] = wn_ < N;
    abase[h] = a_ok[h] ? a.base(am) : 0;
    wrow[h] = W + (long long)(w_ok[h] ? wn_ : 0) * ldw;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);

  // a thread's 16 + 16 staged elements of one k step, packed two to a word
  // so that they live in registers (element k in the low half, k + 1 in the
  // high half)
  struct Staged {
    uint4 a[2], w[2];
  };
  auto pack = [](bf16 lo, bf16 hi) {
    return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
  };
  auto fetch = [&](Staged& r, int k0) {
    const int k = k0 + chunk * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      auto a_at = [&](int kk) { return (a_ok[h] && kk < K) ? a.raw(abase[h], kk) : zero; };
      auto w_at = [&](int kk) { return (w_ok[h] && kk < K) ? wrow[h][kk] : zero; };
      if (a_ok[h] && k + 8 <= K && a.vec_ok(abase[h], k)) {
        r.a[h] = a.raw8(abase[h], k);
      } else {
        r.a[h] = make_uint4(pack(a_at(k), a_at(k + 1)), pack(a_at(k + 2), a_at(k + 3)),
                            pack(a_at(k + 4), a_at(k + 5)), pack(a_at(k + 6), a_at(k + 7)));
      }
      if (w_ok[h] && k + 8 <= K && (reinterpret_cast<uintptr_t>(wrow[h] + k) & 15) == 0) {
        r.w[h] = *reinterpret_cast<const uint4*>(wrow[h] + k);
      } else {
        r.w[h] = make_uint4(pack(w_at(k), w_at(k + 1)), pack(w_at(k + 2), w_at(k + 3)),
                            pack(w_at(k + 4), w_at(k + 5)), pack(w_at(k + 6), w_at(k + 7)));
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);

  // one k step: the staged registers go to shared memory, the registers are
  // refilled with the step two ahead, and the tile multiplies
  auto step = [&](Staged& r, int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint4*>(As + (srow + 32 * h) * LD + chunk * 8) = r.a[h];
      *reinterpret_cast<uint4*>(Ws + (srow + 32 * h) * LD + chunk * 8) = r.w[h];
    }
    __syncthreads();
    if (k0 + 2 * kMmaK < K) fetch(r, k0 + 2 * kMmaK);
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
      wmma::load_matrix_sync(af, As + wm * 16 * LD + kk, LD);
      wmma::load_matrix_sync(b0, Ws + (wn * 32) * LD + kk, LD);
      wmma::load_matrix_sync(b1, Ws + (wn * 32 + 16) * LD + kk, LD);
      wmma::mma_sync(c0, af, b0, c0);
      wmma::mma_sync(c1, af, b1, c1);
    }
    __syncthreads();
  };

  Staged r0, r1;
  fetch(r0, 0);
  if (kMmaK < K) fetch(r1, kMmaK);
  for (int k0 = 0; k0 < K; k0 += 2 * kMmaK) {
    step(r0, k0);
    if (k0 + kMmaK < K) step(r1, k0 + kMmaK);
  }
  wmma::store_matrix_sync(Cs + wm * 16 * kTileN + wn * 32, c0, kTileN, wmma::mem_row_major);
  wmma::store_matrix_sync(Cs + wm * 16 * kTileN + wn * 32 + 16, c1, kTileN,
                          wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cg * 4 + j;
      if (n < N) epi(m, n, Cs[(rg * 4 + i) * kTileN + cg * 4 + j]);
    }
  }
  __syncthreads();  // the result area is the next tile's staging area
}

// The tile in T's path: tensor cores for bf16, CUDA cores for f32.
template <typename T, typename AFn, typename EpiFn>
__device__ __forceinline__ void gemm_tile(const AFn& a, int M, int K, const T* __restrict__ W,
                                          long long ldw, int N, int m0, int n0, float* stage,
                                          const EpiFn& epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    gemm_tile_mma(a, M, K, W, ldw, N, m0, n0, stage, epi);
  } else {
    gemm_tile_fma<T>(a, M, K, W, ldw, N, m0, n0, stage, epi);
  }
}

// Rows of a row-major matrix of T (shared or device memory) as gemm_tile's A.
template <typename T>
struct RowsA {
  const T* p;
  int ld;
  __device__ __forceinline__ int base(int m) const { return m * ld; }
  __device__ __forceinline__ float at(int b, int k) const { return to_f32(p[b + k]); }
  __device__ __forceinline__ T raw(int b, int k) const { return p[b + k]; }
  __device__ __forceinline__ bool vec_ok(int b, int k) const {
    return (reinterpret_cast<uintptr_t>(p + b + k) & 15) == 0;
  }
  __device__ __forceinline__ uint4 raw8(int b, int k) const {
    return *reinterpret_cast<const uint4*>(p + b + k);
  }
};

}  // namespace sbl
