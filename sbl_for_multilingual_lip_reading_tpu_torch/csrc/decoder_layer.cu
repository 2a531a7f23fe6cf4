// K11: one whole SBL decoder layer in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/decoder_layer.py::fused_decoder_layer of the
// JAX package: self-attention (Q, K, V projections, softmax, out-projection,
// residual, LayerNorm), cached cross-attention against the encoder's
// precomputed K/V (Q projection, softmax, out-projection, residual,
// LayerNorm) and the feed-forward block (w1, ReLU, w2, residual, LayerNorm),
// on the deterministic decode path.  The port's decoder stacks its two
// directions on a leading axis, so the kernel takes that axis in its grid:
// x (dirs, B, L, D), every weight (dirs, out, in), one launch for both.
//
// Rounding points are the TPU kernel's: q, k, v, the attention contexts, the
// ReLU output and the LayerNorm outputs that feed a GEMM are rounded to the
// compute dtype; the softmax probabilities, the residual stream (the
// unrounded LayerNorm outputs h1, h2) and every accumulation stay f32;
// LayerNorm is E[x^2] - mean^2 with eps 1e-6.
//
// What bounds it: operations, 2 * rows * (6 D^2 + 2 D DI) per direction plus
// the attention terms, against 7.3 MB of bf16 weights per direction that
// cannot live in one SM's 227 KB.  The design: a thread block owns a tile of
// Bt samples (R = Bt * L <= 64 rows) of one direction and carries it through
// the whole layer in shared memory: the f32 residual stream [R][D], two
// compute-dtype activation buffers [R][D], one head's q/k/v [R][d] and its
// scores.  Every GEMM streams its weight tiles from L2 through gemm_tile
// (gemm_tile.cuh); the layer's weights therefore cross L2 once per block,
// which is why the host picks the largest Bt that fits.  Self-attention runs
// head by head (the head's three projections, in column tiles of 64 so that
// any head width d_k = D / H is taken, then scores, f32 softmax, PV), the
// cross-attention reads its K/V rows straight from device memory, and the
// 2048-wide FFN intermediate is produced and consumed in chunks of D columns
// so that it never exists in full: the w2 partial products accumulate into
// the f32 residual buffer, in another order than one 2048-long sum (an f32
// rounding difference, no more).  The GEMM tile runs bf16 on the tensor
// cores (warp-level mma) and f32 on the CUDA cores; wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"

namespace {

using sbl::from_f32;
using sbl::gemm_tile;
using sbl::RowsA;
using sbl::to_f32;
using sbl::warp_sum;

constexpr float kLnEps = 1e-6f;
constexpr int kVecRows = 13;
// rows of the packed (13, D) f32 vector input, the TPU kernel's order
enum { BQ, BK, BV, FC_B, LN1_S, LN1_B, BQ2, FC2_B, LN2_S, LN2_B, B2, LN3_S, LN3_B };

struct LayerArgs {
  const void* x;       // (dirs, B, L, D)
  const void* wq;      // (dirs, H*dk, D)
  const void* wk;
  const void* wv;
  const void* fc;      // (dirs, D, H*dk)
  const void* wq2;     // (dirs, H*dk, D)
  const void* fc2;     // (dirs, D, H*dk)
  const void* w1;      // (dirs, DI, D)
  const void* w2;      // (dirs, D, DI)
  const float* vecs;   // (dirs, 13, D)
  const float* b1;     // (dirs, DI)
  const void* ck;      // (dirs, B, Tk, H*dk)
  const void* cv;
  const float* bias;   // (L, L) or null
  void* out;           // (dirs, B, L, D)
  int B, L, D, H, dk, DI, Tk, Bt;
  float scale;
};

__host__ __device__ inline long long align16(long long v) { return (v + 15) / 16 * 16; }

// shared-memory layout, in bytes from the start
struct Layout {
  long long res, act1, act2, qb, kb, vb, sc, total;
  int ldt, ldq, sw;
};

__host__ __device__ inline Layout make_layout(int R, int D, int dk, int L, int Tk, int elem) {
  Layout o;
  // rows start 16 bytes past a multiple of 128 (bf16: 16-byte loads of
  // neighbouring rows hit different banks and stay aligned) or one word
  // past it (f32: scalar loads)
  const int pad = elem == 2 ? 8 : 1;
  o.ldt = D + pad;
  o.ldq = dk + pad;
  o.sw = L > Tk ? L : Tk;
  long long off = (long long)sizeof(float) * sbl::kGemmStageFloats;
  o.res = off;  off = align16(off + (long long)sizeof(float) * R * D);
  o.act1 = off; off = align16(off + (long long)elem * R * o.ldt);
  o.act2 = off; off = align16(off + (long long)elem * R * o.ldt);
  o.qb = off;   off = align16(off + (long long)elem * R * o.ldq);
  o.kb = off;   off = align16(off + (long long)elem * R * o.ldq);
  o.vb = off;   off = align16(off + (long long)elem * R * o.ldq);
  o.sc = off;   off = align16(off + (long long)sizeof(float) * R * o.sw);
  o.total = off;
  return o;
}

// in-place softmax of each row's first n scores; one thread per row
__device__ __forceinline__ void softmax_rows(float* sc, int R, int sw, int n) {
  for (int m = threadIdx.x; m < R; m += blockDim.x) {
    float* row = sc + m * sw;
    float mx = row[0];
    for (int j = 1; j < n; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < n; ++j) row[j] = row[j] / sum;
  }
}

// LayerNorm of every row of res (f32, in place); the result also goes, in
// the compute dtype, to act (shared) and/or outp (device) where given
template <typename T>
__device__ __forceinline__ void layer_norm_rows(float* res, int R, int D, const float* g,
                                                const float* b, T* act, int ldt, T* outp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int m = warp; m < R; m += n_warps) {
    float* row = res + (long long)m * D;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = row[c];
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / (float)D;
    const float var = s2 / (float)D - mu * mu;
    const float inv = 1.0f / sqrtf(var + kLnEps);
    for (int c = lane; c < D; c += 32) {
      const float y = (row[c] - mu) * inv * g[c] + b[c];
      row[c] = y;
      if (act != nullptr) act[m * ldt + c] = from_f32<T>(y);
      if (outp != nullptr) outp[(long long)m * D + c] = from_f32<T>(y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(sbl::kGemmThreads) decoder_layer_kernel(const LayerArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int B = p.B, L = p.L, D = p.D, H = p.H, dk = p.dk, DI = p.DI, Tk = p.Tk;
  const int HD = H * dk;
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * p.Bt;
  const int nb = min(p.Bt, B - b0);
  const int R = nb * L;
  const Layout lay = make_layout(p.Bt * L, D, dk, L, Tk, (int)sizeof(T));
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* res = reinterpret_cast<float*>(smem_raw + lay.res);
  T* act1 = reinterpret_cast<T*>(smem_raw + lay.act1);
  T* act2 = reinterpret_cast<T*>(smem_raw + lay.act2);
  T* qb = reinterpret_cast<T*>(smem_raw + lay.qb);
  T* kb = reinterpret_cast<T*>(smem_raw + lay.kb);
  T* vb = reinterpret_cast<T*>(smem_raw + lay.vb);
  float* sc = reinterpret_cast<float*>(smem_raw + lay.sc);
  const int ldt = lay.ldt, ldq = lay.ldq, sw = lay.sw;

  const long long row0 = ((long long)dir * B + b0) * L;  // first row of the tile
  const T* xg = static_cast<const T*>(p.x) + row0 * D;
  T* og = static_cast<T*>(p.out) + row0 * D;
  const T* wq = static_cast<const T*>(p.wq) + (long long)dir * HD * D;
  const T* wk = static_cast<const T*>(p.wk) + (long long)dir * HD * D;
  const T* wv = static_cast<const T*>(p.wv) + (long long)dir * HD * D;
  const T* fc = static_cast<const T*>(p.fc) + (long long)dir * D * HD;
  const T* wq2 = static_cast<const T*>(p.wq2) + (long long)dir * HD * D;
  const T* fc2 = static_cast<const T*>(p.fc2) + (long long)dir * D * HD;
  const T* w1 = static_cast<const T*>(p.w1) + (long long)dir * DI * D;
  const T* w2 = static_cast<const T*>(p.w2) + (long long)dir * D * DI;
  const float* vec = p.vecs + (long long)dir * kVecRows * D;
  const float* b1 = p.b1 + (long long)dir * DI;
  const T* ckg = static_cast<const T*>(p.ck) + ((long long)dir * B + b0) * Tk * HD;
  const T* cvg = static_cast<const T*>(p.cv) + ((long long)dir * B + b0) * Tk * HD;
  const float scale = p.scale;

  // the residual stream starts as x in f32
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) res[i] = to_f32(xg[i]);
  __syncthreads();

  // ---- self-attention, head by head: ctx -> act1 ---------------------------
  const RowsA<T> ax{xg, D};
  for (int h = 0; h < H; ++h) {
    const float* bq = vec + BQ * D + h * dk;
    const float* bk = vec + BK * D + h * dk;
    const float* bv = vec + BV * D + h * dk;
    for (int n0 = 0; n0 < dk; n0 += sbl::kTileN) {
      gemm_tile<T>(ax, R, D, wq + (long long)h * dk * D, (long long)D, dk, 0, n0, stage,
                   [&](int m, int n, float a) { qb[m * ldq + n] = from_f32<T>(a + bq[n]); });
      gemm_tile<T>(ax, R, D, wk + (long long)h * dk * D, (long long)D, dk, 0, n0, stage,
                   [&](int m, int n, float a) { kb[m * ldq + n] = from_f32<T>(a + bk[n]); });
      gemm_tile<T>(ax, R, D, wv + (long long)h * dk * D, (long long)D, dk, 0, n0, stage,
                   [&](int m, int n, float a) { vb[m * ldq + n] = from_f32<T>(a + bv[n]); });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * L; i += blockDim.x) {
      const int m = i / L;
      const int j = i - m * L;
      const int krow = (m / L) * L + j;
      float dot = 0.f;
      for (int c = 0; c < dk; ++c)
        dot = fmaf(to_f32(qb[m * ldq + c]), to_f32(kb[krow * ldq + c]), dot);
      float s = dot * scale;
      if (p.bias != nullptr) s += p.bias[(m % L) * L + j];
      sc[m * sw + j] = s;
    }
    __syncthreads();
    softmax_rows(sc, R, sw, L);
    __syncthreads();
    for (int i = threadIdx.x; i < R * dk; i += blockDim.x) {
      const int m = i / dk;
      const int c = i - m * dk;
      const int v0 = (m / L) * L;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(sc[m * sw + j], to_f32(vb[(v0 + j) * ldq + c]), acc);
      act1[m * ldt + h * dk + c] = from_f32<T>(acc);
    }
    __syncthreads();
  }

  // out-projection + residual, LayerNorm 1: h1 -> res (f32), act1 (rounded)
  {
    const RowsA<T> a{act1, ldt};
    const float* fb = vec + FC_B * D;
    for (int n0 = 0; n0 < D; n0 += sbl::kTileN)
      gemm_tile<T>(a, R, HD, fc, (long long)HD, D, 0, n0, stage, [&](int m, int n, float acc) {
        res[m * D + n] = (acc + fb[n]) + res[m * D + n];
      });
  }
  __syncthreads();
  layer_norm_rows<T>(res, R, D, vec + LN1_S * D, vec + LN1_B * D, act1, ldt, nullptr);
  __syncthreads();

  // ---- cached cross-attention, head by head: ctx2 -> act2 -------------------
  {
    const RowsA<T> a{act1, ldt};
    for (int h = 0; h < H; ++h) {
      const float* bq2 = vec + BQ2 * D + h * dk;
      for (int n0 = 0; n0 < dk; n0 += sbl::kTileN)
        gemm_tile<T>(a, R, D, wq2 + (long long)h * dk * D, (long long)D, dk, 0, n0, stage,
                     [&](int m, int n, float acc) { qb[m * ldq + n] = from_f32<T>(acc + bq2[n]); });
      __syncthreads();
      for (int i = threadIdx.x; i < R * Tk; i += blockDim.x) {
        const int m = i / Tk;
        const int j = i - m * Tk;
        const T* krow = ckg + ((long long)(m / L) * Tk + j) * HD + h * dk;
        float dot = 0.f;
        for (int c = 0; c < dk; ++c) dot = fmaf(to_f32(qb[m * ldq + c]), to_f32(krow[c]), dot);
        sc[m * sw + j] = dot * scale;
      }
      __syncthreads();
      softmax_rows(sc, R, sw, Tk);
      __syncthreads();
      for (int i = threadIdx.x; i < R * dk; i += blockDim.x) {
        const int m = i / dk;
        const int c = i - m * dk;
        const T* vcol = cvg + (long long)(m / L) * Tk * HD + h * dk + c;
        float acc = 0.f;
        for (int j = 0; j < Tk; ++j) acc = fmaf(sc[m * sw + j], to_f32(vcol[(long long)j * HD]), acc);
        act2[m * ldt + h * dk + c] = from_f32<T>(acc);
      }
      __syncthreads();
    }
  }

  // out-projection + residual, LayerNorm 2: h2 -> res (f32), act1 (rounded)
  {
    const RowsA<T> a{act2, ldt};
    const float* fb = vec + FC2_B * D;
    for (int n0 = 0; n0 < D; n0 += sbl::kTileN)
      gemm_tile<T>(a, R, HD, fc2, (long long)HD, D, 0, n0, stage, [&](int m, int n, float acc) {
        res[m * D + n] = (acc + fb[n]) + res[m * D + n];
      });
  }
  __syncthreads();
  layer_norm_rows<T>(res, R, D, vec + LN2_S * D, vec + LN2_B * D, act1, ldt, nullptr);
  __syncthreads();

  // ---- FFN in chunks of D columns of the intermediate -----------------------
  {
    const RowsA<T> a1{act1, ldt};
    const RowsA<T> a2{act2, ldt};
    const float* bo = vec + B2 * D;
    for (int c0 = 0; c0 < DI; c0 += D) {
      for (int n0 = 0; n0 < D; n0 += sbl::kTileN)
        gemm_tile<T>(a1, R, D, w1 + (long long)c0 * D, (long long)D, D, 0, n0, stage,
                     [&](int m, int n, float acc) {
                       act2[m * ldt + n] = from_f32<T>(fmaxf(acc + b1[c0 + n], 0.f));
                     });
      __syncthreads();
      const bool first = c0 == 0;
      for (int n0 = 0; n0 < D; n0 += sbl::kTileN)
        gemm_tile<T>(a2, R, D, w2 + c0, (long long)DI, D, 0, n0, stage,
                     [&](int m, int n, float acc) {
                       res[m * D + n] = (first ? acc + bo[n] : acc) + res[m * D + n];
                     });
      __syncthreads();
    }
  }
  layer_norm_rows<T>(res, R, D, vec + LN3_S * D, vec + LN3_B * D, static_cast<T*>(nullptr), ldt,
                     og);
}

template <typename T>
cudaError_t launch(const LayerArgs& p, int dirs, cudaStream_t stream) {
  const Layout lay = make_layout(p.Bt * p.L, p.D, p.dk, p.L, p.Tk, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(decoder_layer_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.B + p.Bt - 1) / p.Bt), (unsigned)dirs);
  decoder_layer_kernel<T><<<grid, sbl::kGemmThreads, (size_t)lay.total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block of Bt samples needs; the wrapper
// picks Bt with it.  elem = 4 (f32) or 2 (bf16).
extern "C" long long sbl_decoder_layer_smem_bytes(int Bt, int L, int D, int dk, int Tk, int elem) {
  return make_layout(Bt * L, D, dk, L, Tk, elem).total;
}

// Shapes as in LayerArgs; every activation and weight in one dtype (0 =
// float32, 1 = bfloat16), vecs/b1/bias f32.  Needs Bt * L <= 64, H * dk ==
// D, DI a multiple of D.  Returns the cudaError_t of the launch.
extern "C" int sbl_fused_decoder_layer(const void* x, const void* wq, const void* wk,
                                       const void* wv, const void* fc, const void* wq2,
                                       const void* fc2, const void* w1, const void* w2,
                                       const void* vecs, const void* b1, const void* ck,
                                       const void* cv, const void* bias, void* out, int dirs,
                                       int B, int L, int D, int H, int dk, int DI, int Tk, int Bt,
                                       float scale, int dtype, int device, void* stream) {
  if (dirs <= 0 || B <= 0 || L <= 0 || Tk <= 0 || Bt <= 0 || Bt * L > sbl::kTileM || dk <= 0 ||
      H * dk != D || DI <= 0 || DI % D != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LayerArgs p;
  p.x = x; p.wq = wq; p.wk = wk; p.wv = wv; p.fc = fc; p.wq2 = wq2; p.fc2 = fc2;
  p.w1 = w1; p.w2 = w2;
  p.vecs = static_cast<const float*>(vecs);
  p.b1 = static_cast<const float*>(b1);
  p.ck = ck; p.cv = cv;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.B = B; p.L = L; p.D = D; p.H = H; p.dk = dk; p.DI = DI; p.Tk = Tk; p.Bt = Bt;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, dirs, s);
    case 1: return (int)launch<__nv_bfloat16>(p, dirs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
