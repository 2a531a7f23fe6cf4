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
// cannot live in one SM's 227 KB, so each tile of rows streams them from L2:
// the fewer the tiles, the less L2 traffic, and the tile's rows are bounded
// by the shared memory that holds its f32 residual stream.
//
// The bf16 route (decoder_layer_mma_kernel) spreads a tile of Bt samples
// (R = Bt * L <= 64 rows) over a thread-block cluster of cs = 4 CTAs (2 or 1
// where the head count is not a multiple of 4), so that the cluster's
// shared memory holds a full 64-row tile and every CTA streams a quarter of
// the weights:
//  * CTA r owns the columns [r * Dc, (r + 1) * Dc), Dc = D / cs, of every
//    GEMM and the heads that go with them, so its self- and cross-attention
//    need nothing from its peers; it keeps the f32 residual of its columns;
//  * the GEMMs are warpgroup MMAs through gemm_ring.cuh: A, the full rows
//    of x, a context, a LayerNorm output or a ReLU chunk, sits in shared
//    memory and goes to registers by ldmatrix; this CTA's weight rows come
//    by TMA through a 3-stage ring, and the next product's first stages are
//    requested before the attention or LayerNorm that precedes it; the
//    epilogue (bias, rounding, residual) is applied to the accumulators in
//    registers;
//  * an operand a GEMM needs in full rows (the contexts for the
//    out-projections, the LayerNorm outputs, the ReLU chunk for w2) is
//    written by each CTA for its columns into the shared memory of every CTA
//    of the cluster (distributed shared memory, 16 bytes a store), between
//    cluster barriers;
//  * the LayerNorm statistics (sum x, sum x^2) of a row are summed per CTA
//    over its columns, exchanged the same way and added in CTA order, so
//    every CTA normalises with the same values;
//  * attention runs on the tensor cores, one warp per (sample, head, 16
//    query rows, 64 output columns): scores Q K^T by mma.sync from the bf16
//    q and k, an f32 softmax in registers with quad shuffles (online across
//    passes of 64 keys), P V with P split into bf16 hi + lo (mma.cuh) so
//    that P stays f32-faithful; the cross K/V of a group of samples are
//    staged by 16-byte cp.async into the ring's shared memory (asked of L2
//    when the layer starts);
//  * the FFN's 2048-wide intermediate is made and consumed in chunks of D
//    columns (each CTA makes its Dc columns of the chunk and writes them to
//    all), so it never exists in full.
// Sums taken in another order than the plain version's: every GEMM's k sum
// (tensor-core order), w2's sum in chunks of D added into the residual, the
// LayerNorm statistics per CTA then across the cluster, the softmax sum
// online across key passes.
//
// The f32 route (decoder_layer_kernel<float>) is the card's f32 check: one
// thread block per tile of Bt samples, every GEMM through gemm_tile.cuh's
// f32 FMA tile, head by head, with scalar attention.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_ring.cuh"
#include "gemm_tile.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using sbl::bf16;
using sbl::from_f32;
using sbl::gemm_tile;
using sbl::RowsA;
using sbl::to_f32;
using sbl::warp_sum;

constexpr float kLnEps = 1e-6f;
constexpr int kVecRows = 13;
// rows of the packed (13, D) f32 vector input, the TPU kernel's order
enum { BQ, BK, BV, FC_B, LN1_S, LN1_B, BQ2, FC2_B, LN2_S, LN2_B, B2, LN3_S, LN3_B };

struct alignas(64) LayerArgs {
  CUtensorMap maps[8];  // bf16 route: wq, wk, wv, fc, wq2, fc2, w1, w2 as TMA maps
  int tma;              // the maps are built (else the weights go through registers)
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
  int cs;              // CTAs of a cluster (bf16 route)
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


// ---------------------------------------------------------------------------
// The bf16 route: a cluster of CTAs per tile of rows, on the tensor cores.

constexpr int kMmaRows = 64;    // rows of a tile: the GEMMs' 4 x m16
constexpr int kMaxCluster = 4;  // CTAs of a cluster
constexpr int kLayerBN = 128;   // columns of a ring stage: 64 per warpgroup
constexpr int kAttnCols = 64;   // output columns of one attention task
constexpr int kKeyPass = 64;    // keys per pass of the online softmax

// shared memory of one CTA, in bytes from the start
struct MmaLayout {
  long long a, u, res, stats, ring, total;
  int mp;         // rows, R rounded up to 16
  int lda, ldu;   // bf16 row strides of A and U
  int ldr;        // f32 row stride of the residual
  int dkp, dcq;   // head width rounded up to 16; this CTA's heads at dkp each
  int tkp;        // cross keys rounded up to 16
  int kv_sample;  // bf16 elements of one sample's staged cross K and V
};

// A [mp][lda]: full rows of the GEMMs' A operand (x, the contexts, h1, h2);
// U [mp][ldu]: this CTA's q | k | v (dcq columns each), then the cross q,
// then a full-row ReLU chunk; res [mp][ldr]: the f32 residual of this CTA's
// Dc columns; stats [kMaxCluster][mp]: (sum, sum of squares) per CTA;
// ring: gemm_ring's stages, or a group of samples' cross K and V.
__host__ __device__ inline MmaLayout make_mma_layout(int R, int D, int H, int dk, int Tk,
                                                     int cs) {
  MmaLayout o;
  const int hc = H / cs;
  const int dp = (D + 15) / 16 * 16;
  o.mp = (R + 15) / 16 * 16;
  o.dkp = (dk + 15) / 16 * 16;
  o.dcq = hc * o.dkp;
  o.lda = dp + 8;
  o.ldu = (dp > 3 * o.dcq ? dp : 3 * o.dcq) + 8;
  o.ldr = hc * dk + 8;
  o.tkp = (Tk + 15) / 16 * 16;
  o.kv_sample = 2 * hc * o.tkp * (o.dkp + 8);
  const long long ring = sbl::ring_bytes(kLayerBN);
  const long long kv = 2LL * o.kv_sample;
  long long off = 0;
  o.a = off;     off = align16(off + 2LL * o.mp * o.lda);
  o.u = off;     off = align16(off + 2LL * o.mp * o.ldu);
  o.res = off;   off = align16(off + 4LL * o.mp * o.ldr);
  o.stats = off; off = align16(off + 8LL * kMaxCluster * o.mp);
  o.ring = off;  off = align16(off + (ring > kv ? ring : kv));
  o.total = off;
  return o;
}

// an epilogue's column handle: where the column goes, and its bias
struct ColB {
  int n;
  float b;
};

// gemm_ring's W: rows n < N of K elements, row n at base + n * ldw, and
// at (column map_col, row map_row + n) of the TMA map where there is one.
struct DenseW {
  const bf16* base;
  int N, K;
  long long ldw;
  const CUtensorMap* map;
  int map_row, map_col;
  __device__ __forceinline__ const bf16* row(int n) const {
    return n < N ? base + (long long)n * ldw : nullptr;
  }
  __device__ __forceinline__ void fetch8(bf16* dst, const bf16* r, int k) const {
    if (r == nullptr || k >= K) {
      sbl::zero16(dst);
    } else {
      sbl::copy8_scalar(dst, r + k, K - k);
    }
  }
};

// This CTA's columns [c0, c0 + Dc) of rows [0, R) of buf (row stride ld, a
// multiple of 8) to the same place in the shared memory of every other CTA
// of the cluster: one 16-byte store a chunk where the columns are 16-byte
// aligned.  The caller puts a cluster barrier before (the peers are done
// reading those columns) and after (they are there).
__device__ void broadcast_cols(cg::cluster_group& cl, int cs, int rank, bf16* buf, int ld, int R,
                               int c0, int Dc) {
  if (cs == 1) return;
  if (Dc % 8 == 0) {
    // a chunk read once, stored to each peer (the next rank first)
    const int chunks = Dc / 8;
    for (int j = threadIdx.x; j < R * chunks; j += blockDim.x) {
      const int m = j / chunks;
      bf16* p = buf + m * ld + c0 + (j - m * chunks) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      for (int r = 1; r < cs; ++r) {
        const int peer = rank + r < cs ? rank + r : rank + r - cs;
        *reinterpret_cast<uint4*>(cl.map_shared_rank(p, (unsigned)peer)) = v;
      }
    }
  } else {
    const int per = R * Dc;
    for (int i = threadIdx.x; i < per * (cs - 1); i += blockDim.x) {
      const int peer = (rank + 1 + i / per) % cs;
      const int j = i % per;
      const int m = j / Dc;
      bf16* p = buf + m * ld + c0 + (j - m * Dc);
      *cl.map_shared_rank(p, (unsigned)peer) = *p;
    }
  }
}

// One warp: softmax(Q K^T * scale + bias) V for 16 query rows and the
// output columns [col0, col0 + ncols), ncols <= kAttnCols, of one head.
// q: query rows q_row0 + i (i < 16; rows past q_last read q_last) at row
// stride ldq, dkp columns (zero past the head width); k, v: key rows
// k_row0 + j for j < nk (rows past k_last read k_last) at row stride ldk;
// bias: null, or the f32 bias row of query 0 with row stride bias_ld.
// out(i, c, value) receives every output of the nq valid query rows.
template <class Out>
__device__ void attend16(const bf16* q, int ldq, int q_row0, int q_last, const bf16* k,
                         const bf16* v, int ldk, int k_row0, int k_last, int nk,
                         const float* __restrict__ bias, int bias_ld, int nq, int dkp, int col0,
                         int ncols, float scale, const Out& out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* qrow = q + (long long)min(q_row0 + (lane & 15), q_last) * ldq + (lane >> 4) * 8;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[kAttnCols / 8][4];
#pragma unroll
  for (int j = 0; j < kAttnCols / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kp0 = 0; kp0 < nk; kp0 += kKeyPass) {
    const int nkp = min(kKeyPass, nk - kp0);
    // S = Q K^T for this pass's keys: eight n8 tiles
    float s[kKeyPass / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyPass / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < dkp; kk += 16) {
      uint32_t af[4];
      sbl::ldmatrix_x4(af, qrow + kk);
#pragma unroll
      for (int np = 0; np < kKeyPass / 16; ++np) {
        if (np * 16 < nkp) {
          const int kr = min(k_row0 + kp0 + np * 16 + (lane & 7) + (lane >> 4) * 8, k_last);
          uint32_t bk[4];
          sbl::ldmatrix_x4(bk, k + (long long)kr * ldk + kk + ((lane >> 3) & 1) * 8);
          sbl::mma_bf16(s[2 * np], af, bk[0], bk[1]);
          sbl::mma_bf16(s[2 * np + 1], af, bk[2], bk[3]);
        }
      }
    }
    // scale, bias, keys past nk masked; online softmax of rows g and g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeyPass / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kp0 + j * 8 + 2 * t + (e & 1);
        const int qi = g + (e >> 1) * 8;
        float x = -INFINITY;
        if (key < nk) {
          x = s[j][e] * scale;
          if (bias != nullptr && qi < nq) x += __ldg(bias + (long long)qi * bias_ld + key);
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = __expf(m_run[i] - m_new);  // 0 on the first pass
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeyPass / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += pe;
        s[j][e] = pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < kAttnCols / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // O += P V, 16 keys a step, P as bf16 hi + lo (both products issued)
#pragma unroll
    for (int kk = 0; kk < kKeyPass / 16; ++kk) {
      if (kk * 16 < nkp) {
        uint32_t ph[4], pl[4];
        sbl::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        sbl::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        sbl::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        sbl::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        const int vr =
            min(k_row0 + kp0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, k_last);
        const bf16* vrow = v + (long long)vr * ldk + col0 + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < kAttnCols / 16; ++dp) {
          if (dp * 16 < ncols) {
            uint32_t bv[4];
            sbl::ldmatrix_x4_trans(bv, vrow + dp * 16);
            sbl::mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
            sbl::mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
            sbl::mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
            sbl::mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = g + 8 * i;
    if (qi < nq) {
      const float inv = 1.f / l_run[i];
#pragma unroll
      for (int j = 0; j < kAttnCols / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = j * 8 + 2 * t + c;
          if (col < ncols) out(qi, col, o[j][2 * i + c] * inv);
        }
    }
  }
}

// LayerNorm of the tile's R rows across the cluster.  res holds this CTA's
// Dc columns (from c0) of every row in f32; their (sum, sum of squares) go
// to slot `rank` of every CTA's stats, and after a cluster barrier (which
// also tells that every CTA is done reading its A) each CTA adds the cs
// slots in order and normalises its columns.  The result goes back to res
// (f32) and, rounded, to columns c0.. of A, then to every CTA's A; or,
// where og is given (the layer's last LayerNorm), rounded to og only.
// Where the columns split into a power of two (up to 32) of 8-column
// pieces (path A: 16), a thread takes a piece of a row from its sums to its
// 16-byte stores; else a warp sums a row and a thread normalises a column.
__device__ void cluster_layer_norm(cg::cluster_group& cl, int cs, int rank, float* res, int ldr,
                                   float2* stats, int mp, int R, int D, int Dc, int c0,
                                   const float* __restrict__ gam, const float* __restrict__ bet,
                                   bf16* A, int lda, bf16* og) {
  const int c8s = Dc / 8;
  if (Dc % 8 == 0 && c8s <= 32 && (c8s & (c8s - 1)) == 0 && blockDim.x % c8s == 0) {
    // a row's Dc columns as c8s pieces of 8 on c8s neighbouring lanes, the
    // row's sums by shuffles among them; every pass over the rows takes
    // the whole block, so that every lane of a warp shuffles
    const int c = (threadIdx.x % c8s) * 8;
    const int rstep = blockDim.x / c8s;
    for (int base = 0; base < R; base += rstep) {
      const int m = base + threadIdx.x / c8s;
      float s = 0.f, s2 = 0.f;
      if (m < R) {
        const float* rr = res + m * ldr + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += rr[e];
          s2 += rr[e] * rr[e];
        }
      }
      for (int o = c8s / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      // piece j of the row sends the CTA's sums to CTAs j, j + c8s, ...
      if (m < R) {
        for (int r = c / 8; r < cs; r += c8s)
          cl.map_shared_rank(stats, (unsigned)r)[rank * mp + m] = make_float2(s, s2);
      }
    }
    cl.sync();
    // each piece: its row's (mean, 1 / std) from the cs slots in CTA order,
    // res (f32), and the rounded piece as one 16-byte store to A and to
    // every peer's A, or to og
    float gm[8], bt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gm[e] = __ldg(gam + c0 + c + e);
      bt[e] = __ldg(bet + c0 + c + e);
    }
    for (int m = threadIdx.x / c8s; m < R; m += rstep) {
      float s = 0.f, s2 = 0.f;
      for (int r = 0; r < cs; ++r) {
        const float2 v = stats[r * mp + m];
        s += v.x;
        s2 += v.y;
      }
      const float mu = s / (float)D;
      const float inv = 1.0f / sqrtf(s2 / (float)D - mu * mu + kLnEps);
      float* rr = res + m * ldr + c;
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float y0 = (rr[e] - mu) * inv * gm[e] + bt[e];
        const float y1 = (rr[e + 1] - mu) * inv * gm[e + 1] + bt[e + 1];
        if (og == nullptr) {
          rr[e] = y0;
          rr[e + 1] = y1;
        }
        packed[e / 2] = sbl::pack_bf16(y0, y1);
      }
      const uint4 v = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      if (og != nullptr) {
        *reinterpret_cast<uint4*>(og + (long long)m * D + c0 + c) = v;
      } else {
        bf16* dst = A + m * lda + c0 + c;
        for (int r = 0; r < cs; ++r)
          *reinterpret_cast<uint4*>(cl.map_shared_rank(dst, (unsigned)r)) = v;
      }
    }
    if (og == nullptr) cl.sync();
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int m = warp; m < R; m += nw) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < Dc; c += 32) {
      const float v = res[m * ldr + c];
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane < cs) cl.map_shared_rank(stats, (unsigned)lane)[rank * mp + m] = make_float2(s, s2);
  }
  cl.sync();
  // (mean, 1 / std) of row m to slot 0 of its stats, which only this
  // thread reads; then every (row, column) pair, the vectors' loads
  // independent of one another
  for (int m = threadIdx.x; m < R; m += blockDim.x) {
    float s = 0.f, s2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float2 v = stats[r * mp + m];
      s += v.x;
      s2 += v.y;
    }
    const float mu = s / (float)D;
    const float var = s2 / (float)D - mu * mu;
    stats[m] = make_float2(mu, 1.0f / sqrtf(var + kLnEps));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * Dc; i += blockDim.x) {
    const int m = i / Dc;
    const int c = i - m * Dc;
    const float2 st = stats[m];
    const float y = (res[m * ldr + c] - st.x) * st.y * __ldg(gam + c0 + c) + __ldg(bet + c0 + c);
    if (og != nullptr) {
      og[(long long)m * D + c0 + c] = __float2bfloat16_rn(y);
    } else {
      res[m * ldr + c] = y;
      A[m * lda + c0 + c] = __float2bfloat16_rn(y);
    }
  }
  if (og == nullptr) {
    __syncthreads();
    broadcast_cols(cl, cs, rank, A, lda, R, c0, Dc);
    cl.sync();
  }
}

__global__ void __launch_bounds__(sbl::kRingThreads, 1)
    decoder_layer_mma_kernel(const __grid_constant__ LayerArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = p.cs;
  const int rank = (int)cl.block_rank();
  const int B = p.B, L = p.L, D = p.D, H = p.H, dk = p.dk, DI = p.DI, Tk = p.Tk;
  const int HD = H * dk;
  const int hc = H / cs;
  const int Dc = hc * dk;    // this CTA's columns [c0, c0 + Dc) and heads [rank * hc, ...)
  const int c0 = rank * Dc;
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / cs) * p.Bt;
  const int nb = min(p.Bt, B - b0);
  const int R = nb * L;
  const MmaLayout lay = make_mma_layout(p.Bt * L, D, H, dk, Tk, cs);
  bf16* A = reinterpret_cast<bf16*>(smem_raw + lay.a);
  bf16* U = reinterpret_cast<bf16*>(smem_raw + lay.u);
  float* res = reinterpret_cast<float*>(smem_raw + lay.res);
  float2* stats = reinterpret_cast<float2*>(smem_raw + lay.stats);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + lay.ring);
  const int lda = lay.lda, ldu = lay.ldu, ldr = lay.ldr, dkp = lay.dkp, dcq = lay.dcq;
  const bool aligned = (D % 8) == 0;  // rows of x and ck/cv 16-byte aligned
  // the weights' TMA maps (rows: dirs x out, columns: in)
  auto map = [&](int i) { return p.tma ? &p.maps[i] : nullptr; };
  const bool kv_aligned = aligned && (dk % 8) == 0;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float scale = p.scale;

  const long long row0 = ((long long)dir * B + b0) * L;  // first row of the tile
  const bf16* xg = static_cast<const bf16*>(p.x) + row0 * D;
  bf16* og = static_cast<bf16*>(p.out) + row0 * D;
  const bf16* wq = static_cast<const bf16*>(p.wq) + (long long)dir * HD * D;
  const bf16* wk = static_cast<const bf16*>(p.wk) + (long long)dir * HD * D;
  const bf16* wv = static_cast<const bf16*>(p.wv) + (long long)dir * HD * D;
  const bf16* fc = static_cast<const bf16*>(p.fc) + (long long)dir * D * HD;
  const bf16* wq2 = static_cast<const bf16*>(p.wq2) + (long long)dir * HD * D;
  const bf16* fc2 = static_cast<const bf16*>(p.fc2) + (long long)dir * D * HD;
  const bf16* w1 = static_cast<const bf16*>(p.w1) + (long long)dir * DI * D;
  const bf16* w2 = static_cast<const bf16*>(p.w2) + (long long)dir * D * DI;
  const float* vec = p.vecs + (long long)dir * kVecRows * D;
  const float* b1 = p.b1 + (long long)dir * DI;
  const bf16* ckg = static_cast<const bf16*>(p.ck) + ((long long)dir * B + b0) * Tk * HD;
  const bf16* cvg = static_cast<const bf16*>(p.cv) + ((long long)dir * B + b0) * Tk * HD;

  // this CTA's rows of each weight (its columns of each GEMM)
  auto qkv_w = [&](int part) {
    const bf16* wp = part == 0 ? wq : (part == 1 ? wk : wv);
    return DenseW{wp + (long long)c0 * D, Dc, D, (long long)D, map(part), dir * HD + c0, 0};
  };
  const DenseW fc_w{fc + (long long)c0 * HD, Dc, HD, (long long)HD, map(3), dir * D + c0, 0};
  const DenseW q2_w{wq2 + (long long)c0 * D, Dc, D, (long long)D, map(4), dir * HD + c0, 0};
  const DenseW fc2_w{fc2 + (long long)c0 * HD, Dc, HD, (long long)HD, map(5), dir * D + c0, 0};
  auto w1_w = [&](int f0) {
    return DenseW{w1 + (long long)(f0 + c0) * D, Dc, D, (long long)D, map(6),
                  dir * DI + f0 + c0, 0};
  };
  auto w2_w = [&](int f0) {
    return DenseW{w2 + (long long)c0 * DI + f0, Dc, D, (long long)DI, map(7), dir * D + c0, f0};
  };
  // a product's first stages, issued before work that leaves the ring alone
  auto prefetch = [&](const DenseW& w, int K) {
    sbl::ring_start<kLayerBN, kMmaRows>(ring, w, R, Dc, K);
  };

  // A and U zeroed where they have padding columns (a GEMM's k past the
  // width, a head's columns past d_k), which must read as zeros; rows past R
  // are never read.  Then x -> A, and this CTA's columns of x -> res
  if (D % 16 != 0 || dk % 16 != 0) {
    uint4* z = reinterpret_cast<uint4*>(smem_raw + lay.a);
    const int n16 = (int)((lay.res - lay.a) / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  {
    const int chunks = (D + 7) / 8;
    for (int i = threadIdx.x; i < R * chunks; i += blockDim.x) {
      const int m = i / chunks;
      const int c = (i - m * chunks) * 8;
      if (aligned) {
        sbl::cp_async16(A + m * lda + c, xg + (long long)m * D + c, 16);
      } else {
        sbl::copy8_scalar(A + m * lda + c, xg + (long long)m * D + c, D - c);
      }
    }
  }
  // the tile's cross K and V rows of this CTA's heads towards L2, for the
  // cross-attention's staging much later
  for (int i = threadIdx.x; i < 2 * nb * Tk; i += blockDim.x) {
    const bf16* row = (i & 1 ? cvg : ckg) + (long long)(i >> 1) * HD + c0;
    for (int off = 0; off < Dc; off += 64)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + off));
  }

  const sbl::SmemRows a_rows{A, lda, R - 1};
  const sbl::SmemRows u_rows{U, ldu, R - 1};
  auto rows_of = [](int ld) { return [ld](int m) { return m * ld; }; };
  const int qtiles = (L + 15) / 16;
  const int chunks = (dk + kAttnCols - 1) / kAttnCols;

  // ---- self-attention ------------------------------------------------------
  // q | k | v of this CTA's heads, biased and rounded -> U (the first
  // product's stages requested while x arrives)
  prefetch(qkv_w(0), D);
  sbl::cp_async_wait_all();
  __syncthreads();
  if (Dc % 8 == 0) {
    // 8 columns a thread: one 16-byte read, two 16-byte writes
    const int c8s = Dc / 8;
    for (int i = threadIdx.x; i < R * c8s; i += blockDim.x) {
      const int m = i / c8s;
      const int c = (i - m * c8s) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(A + m * lda + c0 + c);
      const bf16* e8 = reinterpret_cast<const bf16*>(&v);
      float* rr = res + m * ldr + c;
      *reinterpret_cast<float4*>(rr) = make_float4(__bfloat162float(e8[0]), __bfloat162float(e8[1]),
                                                   __bfloat162float(e8[2]), __bfloat162float(e8[3]));
      *reinterpret_cast<float4*>(rr + 4) =
          make_float4(__bfloat162float(e8[4]), __bfloat162float(e8[5]), __bfloat162float(e8[6]),
                      __bfloat162float(e8[7]));
    }
  } else {
    for (int i = threadIdx.x; i < R * Dc; i += blockDim.x) {
      const int m = i / Dc;
      const int c = i - m * Dc;
      res[m * ldr + c] = __bfloat162float(A[m * lda + c0 + c]);
    }
  }
  for (int part = 0; part < 3; ++part) {
    auto col = [&](int n) {  // (U column, bias)
      const int j = n / dk;
      return ColB{part * dcq + j * dkp + (n - j * dk), vec[(BQ + part) * D + c0 + n]};
    };
    auto put = [&](int ro, ColB co, float acc) {
      U[ro + co.n] = __float2bfloat16_rn(acc + co.b);
    };
    sbl::gemm_ring<1, 1>(a_rows, qkv_w(part), R, Dc, D, ring,
                         sbl::make_epilogue(rows_of(ldu), col, put), part == 0);
  }
  prefetch(fc_w, HD);
  // softmax(q k^T * scale + bias) v per (sample, head, 16 rows, 64 columns),
  // rounded, -> this CTA's columns of A (its x is read), then every CTA's A
  for (int task = warp; task < nb * hc * qtiles * chunks; task += n_warps) {
    int rest = task;
    const int ch = rest % chunks;
    rest /= chunks;
    const int qt = rest % qtiles;
    rest /= qtiles;
    const int j = rest % hc;
    const int s = rest / hc;
    const int col0 = ch * kAttnCols;
    const int qrow0 = s * L + qt * 16;
    bf16* dst = A + (long long)qrow0 * lda + c0 + j * dk + col0;
    attend16(U + j * dkp, ldu, qrow0, R - 1, U + dcq + j * dkp, U + 2 * dcq + j * dkp, ldu,
             s * L, R - 1, L, p.bias == nullptr ? nullptr : p.bias + (long long)qt * 16 * L, L,
             min(16, L - qt * 16), dkp, col0, min(kAttnCols, dk - col0), scale,
             [&](int qi, int c, float val) { dst[qi * lda + c] = __float2bfloat16_rn(val); });
  }
  cl.sync();  // every CTA is done with its A (x)
  broadcast_cols(cl, cs, rank, A, lda, R, c0, Dc);
  cl.sync();

  // out-projection + residual, LayerNorm 1: h1 -> res (f32), every A (rounded)
  {
    auto col = [&](int n) { return ColB{n, vec[FC_B * D + c0 + n]}; };
    auto put = [&](int ro, ColB co, float acc) {
      const int n = co.n;
      res[ro + n] = (acc + co.b) + res[ro + n];
    };
    sbl::gemm_ring<1, 1>(a_rows, fc_w, R, Dc, HD, ring,
                         sbl::make_epilogue(rows_of(ldr), col, put), true);
  }
  prefetch(q2_w, D);
  cluster_layer_norm(cl, cs, rank, res, ldr, stats, lay.mp, R, D, Dc, c0, vec + LN1_S * D,
                     vec + LN1_B * D, A, lda, nullptr);

  // ---- cached cross-attention ---------------------------------------------
  {
    auto col = [&](int n) {  // (U column, bias)
      const int j = n / dk;
      return ColB{j * dkp + (n - j * dk), vec[BQ2 * D + c0 + n]};
    };
    auto put = [&](int ro, ColB co, float acc) {
      U[ro + co.n] = __float2bfloat16_rn(acc + co.b);
    };
    sbl::gemm_ring<1, 1>(a_rows, q2_w, R, Dc, D, ring,
                         sbl::make_epilogue(rows_of(ldu), col, put), true);
  }
  {
    // groups of samples whose K and V (this CTA's heads) fit the ring's room
    const long long room = lay.total - lay.ring;
    const int group = max(1, (int)(room / (2LL * lay.kv_sample)));
    const int tkp = lay.tkp;
    const int ldk = dkp + 8;
    const int c8s = dkp / 8;
    for (int s0 = 0; s0 < nb; s0 += group) {
      const int gn = min(group, nb - s0);
      for (int i = threadIdx.x; i < gn * hc * 2 * tkp * c8s; i += blockDim.x) {
        int rest = i;
        const int c8 = rest % c8s;
        rest /= c8s;
        const int key = rest % tkp;
        rest /= tkp;
        const int kv = rest % 2;
        rest /= 2;
        const int j = rest % hc;
        const int s = rest / hc;
        const int cc = c8 * 8;
        bf16* dst = ring + ((long long)((s * hc + j) * 2 + kv) * tkp + key) * ldk + cc;
        if (key < Tk && cc < dk) {
          const bf16* src = (kv ? cvg : ckg) + ((long long)(s0 + s) * Tk + key) * HD + c0 +
                            j * dk + cc;
          if (kv_aligned) {
            sbl::cp_async16(dst, src, 16);
          } else {
            sbl::copy8_scalar(dst, src, dk - cc);
          }
        } else {
          sbl::zero16(dst);
        }
      }
      sbl::cp_async_wait_all();
      __syncthreads();
      for (int task = warp; task < gn * hc * qtiles * chunks; task += n_warps) {
        int rest = task;
        const int ch = rest % chunks;
        rest /= chunks;
        const int qt = rest % qtiles;
        rest /= qtiles;
        const int j = rest % hc;
        const int s = rest / hc;
        const int col0 = ch * kAttnCols;
        const int qrow0 = (s0 + s) * L + qt * 16;
        const bf16* kh = ring + (long long)((s * hc + j) * 2) * tkp * ldk;
        bf16* dst = A + (long long)qrow0 * lda + c0 + j * dk + col0;
        attend16(U + j * dkp, ldu, qrow0, R - 1, kh, kh + (long long)tkp * ldk, ldk, 0, tkp - 1,
                 Tk, nullptr, 0, min(16, L - qt * 16), dkp, col0, min(kAttnCols, dk - col0),
                 scale,
                 [&](int qi, int c, float val) { dst[qi * lda + c] = __float2bfloat16_rn(val); });
      }
      __syncthreads();  // the next group's K and V go where these were
    }
  }
  prefetch(fc2_w, HD);
  cl.sync();  // every CTA is done with its A (h1)
  broadcast_cols(cl, cs, rank, A, lda, R, c0, Dc);
  cl.sync();

  // out-projection + residual, LayerNorm 2: h2 -> res (f32), every A (rounded)
  {
    auto col = [&](int n) { return ColB{n, vec[FC2_B * D + c0 + n]}; };
    auto put = [&](int ro, ColB co, float acc) {
      const int n = co.n;
      res[ro + n] = (acc + co.b) + res[ro + n];
    };
    sbl::gemm_ring<1, 1>(a_rows, fc2_w, R, Dc, HD, ring,
                         sbl::make_epilogue(rows_of(ldr), col, put), true);
  }
  prefetch(w1_w(0), D);
  cluster_layer_norm(cl, cs, rank, res, ldr, stats, lay.mp, R, D, Dc, c0, vec + LN2_S * D,
                     vec + LN2_B * D, A, lda, nullptr);

  // ---- FFN in chunks of D columns of the intermediate -----------------------
  for (int f0 = 0; f0 < DI; f0 += D) {
    {
      // this CTA's Dc columns of relu(h2 w1 + b1), rounded, -> U, then every U
      auto col = [&](int n) { return ColB{c0 + n, b1[f0 + c0 + n]}; };
      auto put = [&](int ro, ColB co, float acc) {
        U[ro + co.n] = __float2bfloat16_rn(fmaxf(acc + co.b, 0.f));
      };
      sbl::gemm_ring<1, 1>(a_rows, w1_w(f0), R, Dc, D, ring,
                           sbl::make_epilogue(rows_of(ldu), col, put), true);
    }
    prefetch(w2_w(f0), D);
    cl.sync();  // every CTA is done with its U (the last chunk, or the cross q)
    broadcast_cols(cl, cs, rank, U, ldu, R, c0, Dc);
    cl.sync();
    {
      // the chunk's w2 partial product into the residual (b2 with the first)
      const bool first = f0 == 0;
      auto col = [&](int n) {
        return ColB{n, first ? vec[B2 * D + c0 + n] : 0.f};
      };
      auto put = [&](int ro, ColB co, float acc) {
        const int n = co.n;
        res[ro + n] = (first ? acc + co.b : acc) + res[ro + n];
      };
      sbl::gemm_ring<1, 1>(u_rows, w2_w(f0), R, Dc, D, ring,
                           sbl::make_epilogue(rows_of(ldr), col, put), true);
    }
    if (f0 + D < DI) prefetch(w1_w(f0 + D), D);
  }
  cluster_layer_norm(cl, cs, rank, res, ldr, stats, lay.mp, R, D, Dc, c0, vec + LN3_S * D,
                     vec + LN3_B * D, A, lda, og);
}

cudaError_t launch_mma(LayerArgs& p, int dirs, cudaStream_t stream) {
  const MmaLayout lay = make_mma_layout(p.Bt * p.L, p.D, p.H, p.dk, p.Tk, p.cs);
  // TMA maps of the weights where their rows allow (a multiple of 16
  // columns: a k16 step past the end of a w2 chunk would read the next one)
  const long long D = p.D, DI = p.DI;
  const struct {
    const void* w;
    long long rows, cols;
  } mats[8] = {{p.wq, dirs * D, D},  {p.wk, dirs * D, D},  {p.wv, dirs * D, D},
               {p.fc, dirs * D, D},  {p.wq2, dirs * D, D}, {p.fc2, dirs * D, D},
               {p.w1, dirs * DI, D}, {p.w2, dirs * D, DI}};
  p.tma = D % 16 == 0;
  for (int i = 0; i < 8; ++i) p.tma = p.tma && sbl::weight_map_fits(mats[i].w, mats[i].cols);
  for (int i = 0; i < 8 && p.tma; ++i) {
    const cudaError_t map_err =
        sbl::make_weight_map(&p.maps[i], mats[i].w, mats[i].rows, mats[i].cols, mats[i].cols);
    if (map_err != cudaSuccess) return map_err;
  }
  cudaError_t err = cudaFuncSetAttribute(decoder_layer_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.B + p.Bt - 1) / p.Bt) * p.cs), (unsigned)dirs, 1);
  cfg.blockDim = dim3(sbl::kRingThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decoder_layer_mma_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block of Bt samples needs on the f32
// route; the wrapper picks Bt with it.
extern "C" long long sbl_decoder_layer_smem_bytes(int Bt, int L, int D, int dk, int Tk, int elem) {
  return make_layout(Bt * L, D, dk, L, Tk, elem).total;
}

// Bytes of dynamic shared memory each CTA of a cluster of cs takes for a
// tile of Bt samples on the bf16 route; the wrapper picks Bt with it
// (ops/decoder_layer.py::pick_mma_tile).
extern "C" long long sbl_decoder_layer_mma_smem_bytes(int Bt, int L, int D, int H, int dk, int Tk,
                                                      int cs) {
  return make_mma_layout(Bt * L, D, H, dk, Tk, cs).total;
}

// Shapes as in LayerArgs; every activation and weight in one dtype (0 =
// float32, 1 = bfloat16), vecs/b1/bias f32.  Needs Bt * L <= 64, H * dk ==
// D, DI a multiple of D; bf16: cs in {1, 2, 4} dividing H (f32: cs = 1).
// Returns the cudaError_t of the launch.
extern "C" int sbl_fused_decoder_layer(const void* x, const void* wq, const void* wk,
                                       const void* wv, const void* fc, const void* wq2,
                                       const void* fc2, const void* w1, const void* w2,
                                       const void* vecs, const void* b1, const void* ck,
                                       const void* cv, const void* bias, void* out, int dirs,
                                       int B, int L, int D, int H, int dk, int DI, int Tk, int Bt,
                                       int cs, float scale, int dtype, int device, void* stream) {
  if (dirs <= 0 || B <= 0 || L <= 0 || Tk <= 0 || Bt <= 0 || Bt * L > kMmaRows || dk <= 0 ||
      H * dk != D || DI <= 0 || DI % D != 0 || cs <= 0 || cs > kMaxCluster || H % cs != 0 ||
      (dtype == 0 && cs != 1))
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
  p.B = B; p.L = L; p.D = D; p.H = H; p.dk = dk; p.DI = DI; p.Tk = Tk; p.Bt = Bt; p.cs = cs;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, dirs, s);
    case 1: return (int)launch_mma(p, dirs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
