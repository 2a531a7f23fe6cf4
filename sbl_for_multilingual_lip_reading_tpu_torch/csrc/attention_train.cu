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
//   counter = (key index j, query index i, head h0 + h, batch row b);
//   bits    = word 0 of Philox4x32-10(counter, key);
//   keep   <=> bits >= uint32(rate * 2^32), the JAX package's threshold.
// An element (b, h, i, j) gets the same bits in K3, K4 and K5 for one seed
// whatever the launch geometry, so the backward regenerates the forward's
// mask by construction, and the plain Philox of ops/attention.py reproduces
// it bit for bit.  The decoder folds its two directions into the batch (2B
// rows), so the batch row in the counter gives each direction its own mask.
// The counter's batch row is the row of the whole batch a data-parallel
// process takes a stripe of: local row b counts as
//   (b / rows) * row_stride + row0 + b % rows
// (row0 = the process's first row, rows = its rows per direction,
// row_stride = the whole batch), so every process draws the masks of its
// rows of the one-process run; (row0, rows) = (0, B) is the identity.
// The counter's head is h0 + h: a tensor-parallel process launches its H
// heads of the model's, which start at head h0, so it draws the masks of
// those heads of the one-process run; h0 = 0 is the identity.  The offset
// is added once a block, outside the Philox rounds.
//
// What bounds them.  At the train step's shapes (Tq, Tk <= 31, d = 64) a
// head's products are a few hundred kFLOP, under a microsecond of the
// card's bf16 tensor-core rate for the whole launch, against the bytes of
// Q, K, V (K4 also dO) and the outputs read or written once: 0.009-0.025
// ms at 3.35 TB/s.  Scalar bodies (the f32 route's, below) take 7-9x that
// in bf16: per-(row, key) work on the CUDA cores (one 2-byte load per
// element to stage, each product a scalar FMA chain out of shared memory,
// one warp per query row walking the score row several times).  The bf16
// bodies put every product on the tensor cores, as K1's does (mma.cuh), so
// what is left is the bytes, the Philox draw (~80 integer operations per
// score, once per element in each kernel) and a block's latency:
//   * one block per (batch row, head), one warp per 16 query rows (K4's
//     second phase: per 16 keys), so the encoder's 30 rows and the
//     decoder's 17 take two warps; Q, K, V (and dO) are staged as bf16 by
//     16-byte cp.async.cg with rows past T zero-filled, padded against
//     ldmatrix bank conflicts, and the first bias elements are loaded while
//     the copies are in flight;
//   * S = Q K^T, dP = dO V^T, P V, dS K, P_drop^T dO and dS^T Q are
//     mma.sync.m16n8k16 products (bf16 in, f32 accumulate) fed by ldmatrix;
//     the f32 A operands (P, P_drop, dS) are split into bf16 hi + lo with
//     both products issued, since the JAX kernels multiply with f32
//     operands; wgmma's 64-row tiles do not fit a head's 17-31 rows, and
//     the tensor cores' rate is not what bounds these kernels;
//   * scores, P, dP and dS stay in registers; row max and sums are taken
//     across the quad that holds a row by shuffles; exp is __expf;
//   * the mask is drawn per score element in the accumulator layout (K3:
//     only for rows < Tq and keys < Tk), and applied to P after the
//     softmax, as the JAX kernel orders it.
// K3 (dropout_attention_fwd_mma_kernel) is K1's body, sbl::mha_fwd_block,
// with the block's mask as its weights: keep * exp(s - max) goes into P V
// and the output is scaled by inv_keep / rowsum at the end, which equals
// the normalise-then-drop order up to f32 rounding and lets an online
// (running max) softmax carry across key tiles, so any Tk works.
// K4 (dropout_attention_bwd_mma_kernel) stages the head's Q, dO, K and V
// whole (bwd_mma_smem_bytes: 28.5 KB at Tq = Tk = 30, d = 64) and runs two
// phases with one barrier between them, so the sums over queries for dK and
// dV and over keys for dQ each stay in one warp's registers: no atomics, no
// f32 scratch in device memory, each gradient rounded once to bf16:
//   1. per 16 query rows: the row max and sum, then P, dP through the mask,
//      D_i = rowsum(dP o P) in f32 from registers (not from a rounded
//      forward output), dS and dQ = scale * dS K.  With one key tile (Tk <=
//      32, every train-step shape) this is one pass over registers; longer
//      rows take three sweeps over the key tiles (max and sum; D_i, drawing
//      the mask; dS and dQ, reading it);
//   2. per 16 key rows: dV += P_drop^T dO and dK += scale * dS^T Q over
//      every 16 queries.  At one key tile and at most 64 query rows (every
//      train-step shape; <D, true>) phase 1 leaves P_drop and dS, split
//      into bf16 hi + lo, in shared-memory tiles, which phase 2 reads
//      transposed by ldmatrix.trans as its A operands.  Otherwise (<D,
//      false>) phase 1 leaves each row's statistics and keep bits (one word
//      per 32 keys, OR-ed across the quad), and phase 2 recomputes S^T =
//      K Q^T and dP^T = V dO^T, P from the statistics and the mask from the
//      bits (no second Philox), reusing P_drop^T and dS^T from the
//      registers.  Phase 2 runs over 32 columns at a time (recomputing at
//      d = 64: all 64), to keep its accumulators in registers.
//   Padded query rows and keys get P_drop = dS = 0 by selection, so they
//   never reach D_i, dK or dV.
// Lengths: the bf16 bodies take any lengths that the f32 bodies take (K3's
// shared memory does not grow with T; K4's is below the f32 body's
// wherever the f32 body fits), so f32_smem_bytes alone bounds them
// (Tq = Tk <= 116 at d = 64, 84 at d = 128), mirrored by ops/attention.py.
//
// f32 inputs keep the scalar bodies (dropout_attention_{fwd,bwd}_f32_kernel):
// a TF32 mma would break the f32 check's tolerance, and the f32 route is
// the card's f32 check, not the main path (which runs bf16).  One block of
// 4 warps per (batch row, head) stages the head's K and V (in K4 also Q and
// dO) as f32 rows padded by one float, one warp per query row scores keys
// l, l + 32, ... on lane l, keeps the score row in shared memory, and K4
// keeps dS and P_drop of the whole (query, key) tile there, one warp per
// key row summing over queries for dK and dV.  Their shared memory grows
// with Tq, Tk and d; past 48 KB the launch opts in, up to the card's 227 KB
// a block.  Every output and gradient is rounded once to the input dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

using sbl::bf16;
using sbl::cp_async_wait_all;
using sbl::kKeyTile;
using sbl::kMaxMmaWarps;
using sbl::mma_abt;
using sbl::mma_pb;
using sbl::pack_bf16;
using sbl::stage_rows;
using sbl::warp_max;
using sbl::warp_sum;

constexpr int kWarps = 4;         // warps of an f32 block
constexpr int kMaxSmem = 232448;  // the card's dynamic shared memory a block

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// word 0 of Philox4x32-10 at counter (j, i, h, b) under the 64-bit seed, as
// K3 and K4 draw it.  The round is written out here and not through
// philox_round (K5's), which computes the same words: routed through it,
// K3's and K4's bodies compile to other SASS, and K4's f32 body runs 4-8%
// and K3's bf16 body 2-3% slower (an ablation build timed on the card).
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
  int row0, rows, row_stride;  // the batch-row map (see the header)
  int h0;            // the counter's first head (see the header)

  // the counter's batch row of the launch's row b
  __device__ __forceinline__ int row(int b) const {
    return (b / rows) * row_stride + row0 + b % rows;
  }
  // the counter's head of the launch's head h
  __device__ __forceinline__ int head(int h) const { return h0 + h; }
  // gb, gh: the counter's batch row and head, row(b) and head(h)
  __device__ __forceinline__ bool keep(int gb, int gh, int i, int j) const {
    return dropout_bits(seed, gb, gh, i, j) >= thresh;
  }
};

// ---------------------------------------------------------------------------
// f32: the scalar bodies
// ---------------------------------------------------------------------------

// Copy a head's (n, D) rows of a flat (.., T, H*D) tensor into shared memory
// as f32 rows of stride D + 1.  src points at row 0 of the head.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src, long long row_stride, int n,
                                      float* dst) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r * (D + 1) + c] = src[(long long)r * row_stride + c];
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

// Bytes of dynamic shared memory the f32 forward (backward = 0) or
// backward (1) body takes at these lengths; it bounds the lengths both
// routes take, and ops/attention.py mirrors it.
__host__ __device__ inline long long f32_smem_bytes(int Tq, int Tk, int D, int backward) {
  const long long pad = D + 1;
  if (!backward) return 4LL * (2LL * Tk * pad + (long long)kWarps * D + (long long)kWarps * Tk);
  return 4LL * ((2LL * Tq + 2LL * Tk) * pad + 2LL * Tq * Tk + (long long)kWarps * Tk);
}

// q: (B, Tq, H*D); k, v: (B, Tk, H*D); bias: null or (1|B, Tq, Tk) f32;
// out: (B, Tq, H*D).  Grid: B*H blocks of kWarps warps.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
dropout_attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 float* __restrict__ out, int Tq, int Tk, int H,
                                 int bias_per_batch, float scale, Dropout drop) {
  constexpr int kPad = D + 1;
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* ks = smem;              // [Tk][kPad]
  float* vs = ks + Tk * kPad;    // [Tk][kPad]
  float* qs = vs + Tk * kPad;    // [kWarps][D], one query row per warp
  float* ps = qs + kWarps * D;   // [kWarps][Tk], its probabilities

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int gb = drop.row(b);
  const int gh = drop.head(h);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rs = (long long)H * D;
  const long long head = (long long)h * D;
  const float* qb = q + (long long)b * Tq * rs + head;
  float* ob = out + (long long)b * Tq * rs + head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage<D>(k + (long long)b * Tk * rs + head, rs, Tk, ks);
  stage<D>(v + (long long)b * Tk * rs + head, rs, Tk, vs);
  __syncthreads();

  float* qrow = qs + warp * D;
  float* prow = ps + warp * Tk;
  for (int row = warp; row < Tq; row += kWarps) {
    for (int c = lane; c < D; c += 32) qrow[c] = qb[(long long)row * rs + c];
    __syncwarp();
    softmax_row<D>(qrow, ks, bb, row, Tk, scale, lane, prow);
    if (drop.on)
      for (int j = lane; j < Tk; j += 32)
        prow[j] = drop.keep(gb, gh, row, j) ? prow[j] * drop.inv_keep : 0.f;
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
      if (lane + 32 * m < D) ob[(long long)row * rs + lane + 32 * m] = acc[m];
    __syncwarp();  // this warp's query and probability rows are rewritten next round
  }
}

// K3's inputs plus dout: (B, Tq, H*D); writes dq (B, Tq, H*D) and dk, dv
// (B, Tk, H*D).  Grid: B*H blocks of kWarps warps.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
dropout_attention_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 const float* __restrict__ dout, float* __restrict__ dq,
                                 float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk,
                                 int H, int bias_per_batch, float scale, Dropout drop) {
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
  const int gb = drop.row(b);
  const int gh = drop.head(h);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rs = (long long)H * D;
  const long long head = (long long)h * D;
  const long long qoff = (long long)b * Tq * rs + head;
  const long long koff = (long long)b * Tk * rs + head;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage<D>(q + qoff, rs, Tq, qs);
  stage<D>(dout + qoff, rs, Tq, gs);
  stage<D>(k + koff, rs, Tk, ks);
  stage<D>(v + koff, rs, Tk, vs);
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
        const bool keep = drop.keep(gb, gh, row, j);
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
      if (lane + 32 * m < D) dq[qoff + (long long)row * rs + lane + 32 * m] = acc[m] * scale;
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
        dk[o + lane + 32 * m] = ka[m] * scale;
        dv[o + lane + 32 * m] = va[m];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// K3's weights for K1's body: the block's keep mask on exp(s - max), drawn
// only for rows < Tq and keys < Tk, and inv_keep in the output's scale.
struct HeadDropout {
  Dropout drop;
  int gb, gh, Tq, Tk;  // the counter's batch row and head

  __device__ __forceinline__ float operator()(int row, int key, float p) const {
    return drop.on && row < Tq && key < Tk && !drop.keep(gb, gh, row, key) ? 0.f : p;
  }
  __device__ __forceinline__ float scale(float inv_l) const {
    return drop.on ? inv_l * drop.inv_keep : inv_l;
  }
};

// q, out: (B, Tq, H*D); k, v: (B, Tk, H*D); bias: null or (1|B, Tq, Tk) f32.
// Grid: B*H blocks of min(ceil(Tq / 16), kMaxMmaWarps) warps.
template <int D>
__global__ void __launch_bounds__(kMaxMmaWarps * 32)
dropout_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const float* __restrict__ bias,
                                 bf16* __restrict__ out, int Tq, int Tk, int H,
                                 int bias_per_batch, float scale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long rs = (long long)H * D;
  const long long qoff = (long long)b * Tq * rs + (long long)h * D;
  const long long koff = (long long)b * Tk * rs + (long long)h * D;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);
  sbl::mha_fwd_block<D>(q + qoff, k + koff, v + koff, bb, out + qoff, rs, Tq, Tk, scale,
                        HeadDropout{drop, drop.row(b), drop.head(h), Tq, Tk}, reinterpret_cast<bf16*>(smem_raw));
}

// Whether K4's bf16 body keeps P_drop and dS of the whole head in shared
// memory for its second phase (one key tile, every query row in one round
// of warps: every train-step shape), instead of recomputing them there.
__host__ __device__ inline bool bwd_mma_tiles(int Tq, int Tk) {
  return Tk <= kKeyTile && Tq <= 16 * kMaxMmaWarps;
}

// Bytes of dynamic shared memory K4's bf16 body takes: Q and dO (rows
// padded to 16), K and V (to key tiles) as bf16 rows of D + 8; per query
// row its max, 1 / sum and D_i (f32) and one keep word per key tile; with
// bwd_mma_tiles, the hi and lo halves of P_drop and dS as bf16 rows of
// kKeyTile + 8.  ops/attention.py mirrors it.
__host__ __device__ inline long long bwd_mma_smem_bytes(int Tq, int Tk, int D) {
  const long long tq = (Tq + 15) / 16 * 16;
  const long long n_ktiles = (Tk + kKeyTile - 1) / kKeyTile;
  const long long tiles = bwd_mma_tiles(Tq, Tk) ? 4LL * tq * (kKeyTile + 8) * 2 : 0LL;
  return 2LL * (2 * tq + 2 * n_ktiles * kKeyTile) * (D + 8) + 4LL * tq * (3 + n_ktiles) + tiles;
}

// K3's inputs plus dout: (B, Tq, H*D); writes dq (B, Tq, H*D) and dk, dv
// (B, Tk, H*D).  Grid: B*H blocks of min(max(ceil(Tq / 16), ceil(Tk /
// 16)), kMaxMmaWarps) warps.  Phase 1 gives each warp 16 query rows, phase 2
// 16 key rows (more take more rounds); in the accumulator layout lane (g,
// t) holds rows g and g + 8 and columns 2 t, 2 t + 1 of each n8 tile.
// kTiles: bwd_mma_tiles holds, and phase 2 reads P_drop and dS from shared
// memory; else it recomputes them from the row statistics and keep bits.
template <int D, bool kTiles>
__global__ void __launch_bounds__(kMaxMmaWarps * 32)
dropout_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const float* __restrict__ bias,
                                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                                 int H, int bias_per_batch, float scale, Dropout drop) {
  static_assert(D % 16 == 0 && D <= 128, "head width");
  constexpr int LD = D + 8;
  constexpr int TL = kKeyTile + 8;           // row of a P_drop / dS tile
  // phase 2's columns per pass.  Reading P_drop and dS from the tiles, a
  // pass costs one more ldmatrix of each, so 32 columns keep dK's and dV's
  // accumulators to 32 registers; recomputing, d = 64 takes one pass and
  // d = 128 four (ptxas spills at two)
  constexpr int kCols = (kTiles || D > 64) && D > 32 ? 32 : D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m_tiles = (Tq + 15) / 16;
  const int n_ktiles = (Tk + kKeyTile - 1) / kKeyTile;
  const int tq = m_tiles * 16;
  const int tk = n_ktiles * kKeyTile;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);              // [tq][LD]
  bf16* gs = qs + tq * LD;                                   // [tq][LD] dO
  bf16* ks = gs + tq * LD;                                   // [tk][LD]
  bf16* vs = ks + tk * LD;                                   // [tk][LD]
  float* row_max = reinterpret_cast<float*>(vs + tk * LD);   // [tq]
  float* row_inv = row_max + tq;                             // [tq] 1 / rowsum(e)
  float* row_dp = row_inv + tq;                              // [tq] D_i
  uint32_t* keep_bits = reinterpret_cast<uint32_t*>(row_dp + tq);  // [tq][n_ktiles]
  // kTiles: P_drop hi, lo and dS hi, lo, each [tq][TL]
  bf16* tiles = reinterpret_cast<bf16*>(keep_bits + tq * n_ktiles);

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int gb = drop.row(b);
  const int gh = drop.head(h);
  const long long rs = (long long)H * D;
  const long long qoff = (long long)b * Tq * rs + (long long)h * D;
  const long long koff = (long long)b * Tk * rs + (long long)h * D;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + (bias_per_batch ? (long long)b * Tq * Tk : 0LL);

  stage_rows<D>(qs, q + qoff, rs, 0, tq, Tq, threadIdx.x, blockDim.x);
  stage_rows<D>(gs, dout + qoff, rs, 0, tq, Tq, threadIdx.x, blockDim.x);
  stage_rows<D>(ks, k + koff, rs, 0, tk, Tk, threadIdx.x, blockDim.x);
  stage_rows<D>(vs, v + koff, rs, 0, tk, Tk, threadIdx.x, blockDim.x);

  // phase 1's bias elements of the 16 rows at row0 and the key tile at key0
  auto load_bias = [&](int row0, int key0, float (&br)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8;
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        br[j][e] = (bb != nullptr && row < Tq && key < Tk)
                       ? __ldg(bb + (long long)row * Tk + key)
                       : 0.f;
      }
    }
  };
  float bias_r[4][4];
  load_bias(warp * 16, 0, bias_r);  // the first tile's, while the copies are in flight
  cp_async_wait_all();
  __syncthreads();

  // scale * Q K^T + bias over key tile kt for the 16 rows at qw; -inf past Tk
  auto scores = [&](const bf16* qw, int kt, const float (&br)[4][4], float (&s)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<D, 4>(s, qw, ks + kt * kKeyTile * LD, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kKeyTile + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < Tk ? s[j][e] * scale + br[j][e] : -INFINITY;
      }
    }
  };
  // the keep words of rows g and g + 8 of the 16 rows at row0 over key
  // tile kt (bit = key - 32 kt; all set without dropout).  draw: from
  // Philox for rows < Tq and keys < Tk, OR-ed across the quad (and kept in
  // keep_bits for the recomputing phase 2); else read from keep_bits
  auto keep_words = [&](int row0, int kt, bool draw, uint32_t (&w)[2]) {
    w[0] = w[1] = 0xffffffffu;
    if (!drop.on) return;
    uint32_t* words = keep_bits + (row0 + g) * n_ktiles + kt;
    if (!draw) {
      w[0] = words[0];
      w[1] = words[8 * n_ktiles];
      return;
    }
    w[0] = w[1] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8;
        const int bit = j * 8 + 2 * t + (e & 1);
        const int key = kt * kKeyTile + bit;
        if (row < Tq && key < Tk && drop.keep(gb, gh, row, key)) w[e >> 1] |= 1u << bit;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w[i] |= __shfl_xor_sync(0xffffffffu, w[i], 1);
      w[i] |= __shfl_xor_sync(0xffffffffu, w[i], 2);
    }
    if (!kTiles && t == 0) {
      words[0] = w[0];
      words[8 * n_ktiles] = w[1];
    }
  };
  auto kept = [&](const uint32_t (&w)[2], int j, int e) {
    return ((w[e >> 1] >> (j * 8 + 2 * t + (e & 1))) & 1u) != 0u;
  };
  // dO V^T over key tile kt through the mask: keep ? dp * inv_keep : 0
  auto dprobs = [&](const bf16* gw, int kt, const uint32_t (&w)[2], float (&dp)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_abt<D, 4>(dp, gw, vs + kt * kKeyTile * LD, lane);
    if (!drop.on) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = kept(w, j, e) ? dp[j][e] * drop.inv_keep : 0.f;
    }
  };
  auto quad_sum = [&](float (&x)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], 1);
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
    }
  };
  // rows r0 + g and r0 + g + 8 (those below n) of the accumulator tiles acc
  // times mul, rounded once to bf16, to out (row stride rs) at columns c0 +
  // 8 j + 2 t
  auto store = [&](bf16* out, int r0, int n, const auto& acc, int c0, float mul) {
    constexpr int kTilesN = sizeof(acc) / sizeof(acc[0]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < n) {
        bf16* o = out + (long long)row * rs + c0 + 2 * t;
#pragma unroll
        for (int j = 0; j < kTilesN; ++j)
          *reinterpret_cast<uint32_t*>(o + 8 * j) =
              pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
      }
    }
  };

  // phase 1: per 16 query rows, the row statistics, the mask and dQ
  for (int mt = warp; mt < m_tiles; mt += warps) {
    const int row0 = mt * 16;
    const bf16* qw = qs + row0 * LD;
    const bf16* gw = gs + row0 * LD;
    float s[4][4], dp[4][4];
    uint32_t w[2];
    // each row's max and sum over the key tiles; s keeps the last tile's
    // exp(score - max)
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_ktiles; ++kt) {
      if (mt != warp || kt > 0) load_bias(row0, kt * kKeyTile, bias_r);
      scores(qw, kt, bias_r, s);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        corr[i] = __expf(m_run[i] - m_new);  // 0 on the first tile
        m_run[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - m_run[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      }
      quad_sum(sum);
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * corr[i] + sum[i];
    }
    const float inv_l[2] = {1.f / l_run[0], 1.f / l_run[1]};

    float dsum[2] = {0.f, 0.f};  // D_i of rows g and g + 8
    if (n_ktiles == 1) {
      // one key tile: P, dP, D_i, dS and dQ from the registers of s
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= inv_l[e >> 1];
      }
      keep_words(row0, 0, true, w);
      dprobs(gw, 0, w, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[j][e] * s[j][e];
      }
      quad_sum(dsum);
      if constexpr (kTiles) {
        // P_drop and dS, split into hi and lo, to the tiles for phase 2;
        // padded rows and keys exactly 0
        bf16* pd_hi = tiles;
        bf16* pd_lo = pd_hi + tq * TL;
        bf16* ds_hi = pd_lo + tq * TL;
        bf16* ds_lo = ds_hi + tq * TL;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + g + 8 * i;
            const int col = j * 8 + 2 * t;
            float pd[2], ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * i + c;
              const bool valid = row < Tq && col + c < Tk;
              const float p = s[j][e];
              pd[c] = valid && kept(w, j, e) ? (drop.on ? p * drop.inv_keep : p) : 0.f;
              ds[c] = valid ? p * (dp[j][e] - dsum[i]) : 0.f;
            }
            uint32_t hi, lo;
            sbl::split_bf16(pd[0], pd[1], hi, lo);
            *reinterpret_cast<uint32_t*>(pd_hi + row * TL + col) = hi;
            *reinterpret_cast<uint32_t*>(pd_lo + row * TL + col) = lo;
            sbl::split_bf16(ds[0], ds[1], hi, lo);
            *reinterpret_cast<uint32_t*>(ds_hi + row * TL + col) = hi;
            *reinterpret_cast<uint32_t*>(ds_lo + row * TL + col) = lo;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dsum[e >> 1];
      }
      float dqa[D / 8][4] = {};
      mma_pb<D, 2, D>(dqa, s, ks, 0, lane);
      store(dq + qoff, row0, Tq, dqa, 0, scale);
    } else if constexpr (!kTiles) {
      // D_i over every key tile, drawing the mask; then dS and dQ, reading it
      for (int kt = 0; kt < n_ktiles; ++kt) {
        load_bias(row0, kt * kKeyTile, bias_r);
        scores(qw, kt, bias_r, s);
        keep_words(row0, kt, true, w);
        dprobs(gw, kt, w, dp);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[j][e] - m_run[e >> 1]) * inv_l[e >> 1];
            dsum[e >> 1] += dp[j][e] * p;
          }
        }
      }
      quad_sum(dsum);
      __syncwarp();  // the quad's keep words are read by all its lanes
      // at d = 128 over two column halves, recomputing S and dP for each,
      // so that dQ's accumulators fit the registers beside the sweep's
      constexpr int kQCols = D > 64 ? D / 2 : D;
#pragma unroll 1
      for (int c0 = 0; c0 < D; c0 += kQCols) {
        float dqa[kQCols / 8][4] = {};
        for (int kt = 0; kt < n_ktiles; ++kt) {
          load_bias(row0, kt * kKeyTile, bias_r);
          scores(qw, kt, bias_r, s);
          keep_words(row0, kt, false, w);
          dprobs(gw, kt, w, dp);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = __expf(s[j][e] - m_run[e >> 1]) * inv_l[e >> 1];
              s[j][e] = p * (dp[j][e] - dsum[e >> 1]);
            }
          }
          mma_pb<D, 2, kQCols>(dqa, s, ks + kt * kKeyTile * LD, c0, lane);
        }
        store(dq + qoff, row0, Tq, dqa, c0, scale);
      }
    }
    if (!kTiles && t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + g + 8 * i;
        row_max[row] = m_run[i];
        row_inv[row] = inv_l[i];
        row_dp[row] = dsum[i];
      }
    }
  }
  __syncthreads();

  // phase 2: per 16 key rows, dV = P_drop^T dO and dK = scale * dS^T Q,
  // summed over every 16 queries with P_drop^T and dS^T as the A operands
  const int n_tiles = (Tk + 15) / 16;
  for (int nt = warp; nt < n_tiles; nt += warps) {
    const int key0 = nt * 16;
    const bf16* kw = ks + key0 * LD;
    const bf16* vw = vs + key0 * LD;
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += kCols) {
      float dka[kCols / 8][4], dva[kCols / 8][4];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
        dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
      }
      for (int qt = 0; qt < m_tiles; ++qt) {
        const int q0 = qt * 16;
        if constexpr (kTiles) {
          // the transposed 16 x 16 blocks of the tiles: rows are this
          // warp's keys, columns the 16 queries
          const int at = (q0 + (lane & 7) + (lane >> 4) * 8) * TL + key0 + ((lane >> 3) & 1) * 8;
          uint32_t ph[4], pl[4], sh[4], sl[4];
          sbl::ldmatrix_x4_trans(ph, tiles + at);
          sbl::ldmatrix_x4_trans(pl, tiles + tq * TL + at);
          sbl::ldmatrix_x4_trans(sh, tiles + 2 * tq * TL + at);
          sbl::ldmatrix_x4_trans(sl, tiles + 3 * tq * TL + at);
          sbl::mma_hl_b<D, kCols>(dva, ph, pl, gs + q0 * LD, c0, lane);
          sbl::mma_hl_b<D, kCols>(dka, sh, sl, qs + q0 * LD, c0, lane);
        } else {
          float br[2][4];
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + g + (e >> 1) * 8;
              const int qi = q0 + jn * 8 + 2 * t + (e & 1);
              br[jn][e] = (bb != nullptr && key < Tk && qi < Tq)
                              ? __ldg(bb + (long long)qi * Tk + key)
                              : 0.f;
            }
          }
          // S^T and dP^T: rows are this warp's keys, columns the 16 queries
          float st[2][4], dpt[2][4];
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            st[jn][0] = st[jn][1] = st[jn][2] = st[jn][3] = 0.f;
            dpt[jn][0] = dpt[jn][1] = dpt[jn][2] = dpt[jn][3] = 0.f;
          }
          mma_abt<D, 2>(st, kw, qs + q0 * LD, lane);
          mma_abt<D, 2>(dpt, vw, gs + q0 * LD, lane);
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + g + (e >> 1) * 8;
              const int qi = q0 + jn * 8 + 2 * t + (e & 1);
              float pd = 0.f, ds = 0.f;
              if (key < Tk && qi < Tq) {
                const float x = st[jn][e] * scale + br[jn][e];
                const float p = __expf(x - row_max[qi]) * row_inv[qi];
                float dpv = dpt[jn][e];
                pd = p;
                if (drop.on) {
                  const bool keep = (keep_bits[qi * n_ktiles + key / kKeyTile] >>
                                     (key % kKeyTile)) & 1u;
                  pd = keep ? p * drop.inv_keep : 0.f;
                  dpv = keep ? dpv * drop.inv_keep : 0.f;
                }
                ds = p * (dpv - row_dp[qi]);
              }
              st[jn][e] = pd;   // P_drop^T
              dpt[jn][e] = ds;  // dS^T
            }
          }
          mma_pb<D, 1, kCols>(dva, st, gs + q0 * LD, c0, lane);
          mma_pb<D, 1, kCols>(dka, dpt, qs + q0 * LD, c0, lane);
        }
      }
      store(dv + koff, key0, Tk, dva, c0, 1.f);
      store(dk + koff, key0, Tk, dka, c0, scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------
//
// What bounds it: the integer pipes.  Each element costs one Philox4x32-10
// word (ten rounds of two 32 x 32 -> 64-bit products and two three-way
// XORs: some 36 integer instructions once the last rounds' unused words
// are dropped) and writes one byte, so at (480,8,17,17) its 1.1 MB take
// 0.33 us of device-memory time against a few us of integer issue (32-bit
// multiplies on the FMA pipe and logic on the ALU pipe, each 64 lanes a
// clock an SM on compute capability 9.0).  What else it spends must stay
// small beside the draw: three divisions of a 64-bit flat index an element
// (a software routine each) would cost more than the draw itself.  Below
// that, a launch costs about 5 us on the card (a one-element fill, timed
// as the kernels are), more than the draws at the train step's shapes.
//
// The design:
//   * a thread owns 16 consecutive flat elements and stores them with one
//     16-byte st.global (a run that ends past n stores its elements
//     singly); n < 2^31, so every index is 32-bit;
//   * its first element's (b, h, i, j) comes from three divisions by
//     multiply-high with the divisors' magic numbers (FastDiv, computed on
//     the host), once a thread; the other 15 step j with a carry into i, h
//     and b, by selects, so the body is one straight line and its static
//     SASS is what a thread executes (chip_smoke.py bounds K5 by it);
//     carries by branch time the same;
//   * the ten round keys are computed once a thread (they depend on the
//     seed alone), not once an element; the 16 draws of a thread are
//     independent, so their multiplies interleave;
//   * one wave: the grid is the smaller of n / 16 / kMaskThreads and the
//     blocks the card holds at once (occupancy query), and a grid-stride
//     loop takes the rest.
// The bits are the ones dropout_bits gives K3 and K4: the same rounds on
// the same counter and keys.

constexpr int kMaskThreads = 128;
constexpr int kMaskRun = 16;  // elements a thread stores at once

// one round of Philox4x32 on the counter c under the round key (k0, k1)
__device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                             uint32_t& c3, uint32_t k0, uint32_t k1) {
  const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
  const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
  c0 = hi1 ^ c1 ^ k0;
  c1 = lo1;
  c2 = hi0 ^ c3 ^ k1;
  c3 = lo0;
}

// n / d for n < 2^31 by one multiply-high, an add and a shift: m and s are
// the round-up magic number of d (Granlund and Montgomery), from the host.
struct FastDiv {
  uint32_t d, m, s;
  explicit FastDiv(uint32_t divisor) : d(divisor), s(0) {
    while (s < 31 && (1u << s) < d) ++s;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const { return (__umulhi(n, m) + n) >> s; }
};

// out: (B, H, Tq, Tk) bytes, 1 = keep; n = B * H * Tq * Tk < 2^31.
// kMapped: the counter's batch row goes through the batch-row map (row0,
// rows, row_stride) and its head starts at h0 (the header); otherwise both
// are the launch's.
template <bool kMapped>
__global__ void __launch_bounds__(kMaskThreads)
    dropout_keep_mask_kernel(unsigned char* __restrict__ out, uint32_t n, FastDiv by_tk,
                             FastDiv by_tq, FastDiv by_h, unsigned long long seed,
                             uint32_t thresh, uint32_t row0, uint32_t rows,
                             uint32_t row_stride, uint32_t h0) {
  uint32_t k0[10], k1[10];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k0[r] = static_cast<uint32_t>(seed) + r * kPhiloxW0;
    k1[r] = static_cast<uint32_t>(seed >> 32) + r * kPhiloxW1;
  }
  const uint32_t Tk = by_tk.d, Tq = by_tq.d, H = by_h.d;
  const uint32_t runs = (n + kMaskRun - 1) / kMaskRun;
  for (uint32_t g = blockIdx.x * kMaskThreads + threadIdx.x; g < runs;
       g += gridDim.x * kMaskThreads) {
    const uint32_t e0 = g * kMaskRun;
    const uint32_t row = by_tk.div(e0);  // (b, h, i)
    const uint32_t head = by_tq.div(row);  // (b, h)
    uint32_t j = e0 - row * Tk, i = row - head * Tq;
    uint32_t b = by_h.div(head), h = head - b * H;
    // mapped: b's group and its place in it, carried with b
    uint32_t bq = kMapped ? b / rows : 0u, br = kMapped ? b % rows : 0u;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int u = 0; u < kMaskRun; ++u) {
      uint32_t c0 = j, c1 = i, c2 = kMapped ? h0 + h : h, c3 = kMapped ? bq * row_stride + row0 + br : b;
#pragma unroll
      for (int r = 0; r < 10; ++r) philox_round(c0, c1, c2, c3, k0[r], k1[r]);
      w[u / 4] |= static_cast<uint32_t>(c0 >= thresh) << (8 * (u % 4));
      // the next element: carries by selects, so the 16 draws stay one
      // straight line
      const bool cj = ++j == Tk;
      j = cj ? 0u : j;
      i += cj;
      const bool ci = i == Tq;
      i = ci ? 0u : i;
      h += ci;
      const bool ch = h == H;
      h = ch ? 0u : h;
      b += ch;
      if (kMapped) {
        br += ch;
        const bool cb = br == rows;
        br = cb ? 0u : br;
        bq += cb;
      }
    }
    if (e0 + kMaskRun <= n) {
      *reinterpret_cast<uint4*>(out + e0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int u = 0; u < kMaskRun; ++u) {
        if (e0 + u < n) out[e0 + u] = (w[u / 4] >> (8 * (u % 4))) & 0xffu;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The shapes both routes take: the f32 bodies' shared memory bounds the
// lengths, and the bf16 bodies take all of them.
bool shape_ok(int B, int Tq, int Tk, int H, int D) {
  return B > 0 && H > 0 && (D == 16 || D == 32 || D == 64 || D == 128) && Tq > 0 && Tk > 0 &&
         f32_smem_bytes(Tq, Tk, D, 0) <= kMaxSmem && f32_smem_bytes(Tq, Tk, D, 1) <= kMaxSmem;
}

Dropout make_dropout(unsigned long long seed, unsigned int thresh, float inv_keep, int on,
                     int row0, int rows, int row_stride, int h0) {
  Dropout d;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.on = on;
  d.row0 = row0;
  d.rows = rows;
  d.row_stride = row_stride;
  d.h0 = h0;
  return d;
}

// A batch-row map that keeps every counter row below 2^31.
bool rows_ok(int B, int row0, int rows, int row_stride) {
  if (row0 < 0 || rows <= 0 || row_stride < 0) return false;
  const long long last = (long long)((B - 1) / rows) * row_stride + row0 + (B - 1) % rows;
  return last < (1LL << 31);
}

// A head offset that keeps every counter head below 2^31.
bool heads_ok(int H, int h0) { return h0 >= 0 && (long long)h0 + H <= (1LL << 31); }

int warps_for(int rows) {
  const int tiles = (rows + 15) / 16;
  return tiles < kMaxMmaWarps ? tiles : kMaxMmaWarps;
}

// Launch kernel as blocks of `threads` with smem bytes of dynamic shared
// memory, opting in past the 48 KB a launch gets without.
template <typename Kernel, typename... Args>
cudaError_t launch_with(Kernel kernel, unsigned blocks, int threads, size_t smem,
                        cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       int B, int Tq, int Tk, int H, int bias_per_batch, float scale,
                       Dropout drop, int dtype, cudaStream_t stream) {
  const unsigned blocks = (unsigned)B * (unsigned)H;
  if (dtype == 0)
    return launch_with(dropout_attention_fwd_f32_kernel<D>, blocks, kWarps * 32,
                       (size_t)f32_smem_bytes(Tq, Tk, D, 0), stream,
                       static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(bias),
                       static_cast<float*>(out), Tq, Tk, H, bias_per_batch, scale, drop);
  const int warps = warps_for(Tq);
  return launch_with(dropout_attention_fwd_mma_kernel<D>, blocks, warps * 32,
                     sizeof(bf16) * (size_t)sbl::mma_smem_elems(D, warps), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const float*>(bias),
                     static_cast<bf16*>(out), Tq, Tk, H, bias_per_batch, scale, drop);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                       int H, int bias_per_batch, float scale, Dropout drop, int dtype,
                       cudaStream_t stream) {
  const unsigned blocks = (unsigned)B * (unsigned)H;
  if (dtype == 0)
    return launch_with(dropout_attention_bwd_f32_kernel<D>, blocks, kWarps * 32,
                       (size_t)f32_smem_bytes(Tq, Tk, D, 1), stream,
                       static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(bias),
                       static_cast<const float*>(dout), static_cast<float*>(dq),
                       static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H,
                       bias_per_batch, scale, drop);
  const int warps = warps_for(Tq > Tk ? Tq : Tk);
  return launch_with(bwd_mma_tiles(Tq, Tk) ? dropout_attention_bwd_mma_kernel<D, true>
                                           : dropout_attention_bwd_mma_kernel<D, false>,
                     blocks, warps * 32, (size_t)bwd_mma_smem_bytes(Tq, Tk, D), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const float*>(bias),
                     static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H,
                     bias_per_batch, scale, drop);
}

// Check the launch's dtype, shape and (bf16: 16-byte staging copies)
// pointers, select the device, and return 0 or the error to report.
int prepare(int B, int Tq, int Tk, int H, int D, int dtype, int device,
            std::initializer_list<const void*> ptrs) {
  if (!shape_ok(B, Tq, Tk, H, D) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  return (int)cudaSetDevice(device);
}

// Return LAUNCH's instantiation for the head width D, called with the
// remaining arguments.
#define SBL_TRAIN_DISPATCH(LAUNCH, ...)                              \
  switch (D) {                                                       \
    case 16: return (int)LAUNCH<16>(__VA_ARGS__);                    \
    case 32: return (int)LAUNCH<32>(__VA_ARGS__);                    \
    case 64: return (int)LAUNCH<64>(__VA_ARGS__);                    \
    case 128: return (int)LAUNCH<128>(__VA_ARGS__);                  \
    default: return (int)cudaErrorInvalidValue;                      \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (pointers 16-byte aligned); D in {16,
// 32, 64, 128}; Tq, Tk such that f32_smem_bytes fits a block (kMaxSmem).
// thresh = uint32(rate * 2^32), inv_keep = 1 / (1 - rate), dropout_on =
// rate > 0; (row0, rows, row_stride) the batch-row map and h0 the first
// head of the header.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int sbl_small_mha_dropout_fwd_flat(const void* q, const void* k, const void* v,
                                              const void* bias, void* out, int B, int Tq,
                                              int Tk, int H, int D, int bias_per_batch,
                                              float scale, unsigned long long seed,
                                              unsigned int thresh, float inv_keep,
                                              int dropout_on, int row0, int rows,
                                              int row_stride, int h0, int dtype, int device,
                                              void* stream) {
  if (!rows_ok(B, row0, rows, row_stride) || !heads_ok(H, h0)) return (int)cudaErrorInvalidValue;
  const int err = prepare(B, Tq, Tk, H, D, dtype, device, {q, k, v, out});
  if (err != 0) return err;
  const Dropout drop = make_dropout(seed, thresh, inv_keep, dropout_on, row0, rows, row_stride, h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SBL_TRAIN_DISPATCH(launch_fwd, q, k, v, bias, out, B, Tq, Tk, H, bias_per_batch, scale, drop,
                     dtype, s)
}

extern "C" int sbl_small_mha_dropout_bwd_flat(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout, void* dq,
                                              void* dk, void* dv, int B, int Tq, int Tk, int H,
                                              int D, int bias_per_batch, float scale,
                                              unsigned long long seed, unsigned int thresh,
                                              float inv_keep, int dropout_on, int row0,
                                              int rows, int row_stride, int h0, int dtype,
                                              int device, void* stream) {
  if (!rows_ok(B, row0, rows, row_stride) || !heads_ok(H, h0)) return (int)cudaErrorInvalidValue;
  const int err = prepare(B, Tq, Tk, H, D, dtype, device, {q, k, v, dout, dq, dk, dv});
  if (err != 0) return err;
  const Dropout drop = make_dropout(seed, thresh, inv_keep, dropout_on, row0, rows, row_stride, h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SBL_TRAIN_DISPATCH(launch_bwd, q, k, v, bias, dout, dq, dk, dv, B, Tq, Tk, H, bias_per_batch,
                     scale, drop, dtype, s)
}

// out: (B, H, Tq, Tk) torch.bool (one byte per element), 16-byte aligned;
// B * H * Tq * Tk < 2^31; (row0, rows, row_stride) the batch-row map and h0
// the first head of the header (the identity (0, B, B) and h0 = 0 take the
// unmapped kernel).
extern "C" int sbl_dropout_keep_mask_flat(void* out, int B, int H, int Tq, int Tk,
                                          unsigned long long seed, unsigned int thresh,
                                          int row0, int rows, int row_stride, int h0,
                                          int device, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !aligned16(out)) return (int)cudaErrorInvalidValue;
  if (!rows_ok(B, row0, rows, row_stride) || !heads_ok(H, h0)) return (int)cudaErrorInvalidValue;
  const bool mapped = !(row0 == 0 && rows >= B && h0 == 0);
  const auto kernel = mapped ? dropout_keep_mask_kernel<true> : dropout_keep_mask_kernel<false>;
  const long long n = (long long)B * H * Tq * Tk;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMaskThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)kMaskRun * kMaskThreads;
  const long long want = (n + per_block - 1) / per_block;
  const long long resident = per_sm * sms > 0 ? (long long)per_sm * sms : 1;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  kernel<<<blocks, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(out), (uint32_t)n, FastDiv(Tk), FastDiv(Tq), FastDiv(H), seed,
      thresh, (uint32_t)row0, (uint32_t)rows, (uint32_t)row_stride, (uint32_t)h0);
  return (int)cudaGetLastError();
}
