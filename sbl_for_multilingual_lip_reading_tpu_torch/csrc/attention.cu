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
// The bf16 body (small_mha_mma_kernel) is built so that nothing but those
// bytes costs time:
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

namespace {

using sbl::warp_max;
using sbl::warp_sum;
using bf16 = __nv_bfloat16;

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kKeyTile = 32;     // keys staged per tile (four n8 score tiles)
constexpr int kMaxMmaWarps = 4;  // warps of a block, 16 query rows each

// bf16 elements of dynamic shared memory: K and V tiles, 16 Q rows per warp
__host__ __device__ constexpr int mma_smem_elems(int D, int warps) {
  return (2 * kKeyTile + 16 * warps) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Stage rows [row0, row0 + nrows) of one head (row stride `stride`
// elements) into shared memory rows of D + 8; rows at or past `nvalid` are
// zero-filled.  Threads tid, tid + nthreads, ... each copy 16 bytes.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride, int row0,
                                           int nrows, int nvalid, int tid, int nthreads) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < nrows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < nvalid;
    cp_async16(dst + r * (D + 8) + c, ok ? src + (long long)(row0 + r) * stride + c : src,
               ok ? 16 : 0);
  }
}

// q, out: Tq rows of D per (batch row, head); k, v: Tk rows; bias: null or
// a (Tq, Tk) f32 block per (batch row, head) at the layout's strides.
// Grid: B*H blocks of min(ceil(Tq / 16), kMaxMmaWarps) warps.
template <int D>
__global__ void __launch_bounds__(kMaxMmaWarps * 32)
small_mha_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, int Tq, int Tk, int H, Layout lay, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head width");
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kKeyTile][LD]
  bf16* vs = ks + kKeyTile * LD;                 // [kKeyTile][LD]
  bf16* qs = vs + kKeyTile * LD;                 // [warps * 16][LD]

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t = lane & 3;   // its column pair within an 8-wide tile
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long rs = lay.row;
  const long long qoff = b * lay.q_batch + h * lay.q_head;
  const long long koff = b * lay.k_batch + h * lay.k_head;
  const bf16* qb = q + qoff;
  const bf16* kb = k + koff;
  const bf16* vb = v + koff;
  bf16* ob = out + qoff;
  const float* bb = nullptr;
  if (bias != nullptr) bb = bias + b * lay.bias_batch + h * lay.bias_head;
  bf16* qw = qs + warp * 16 * LD;  // this warp's 16 query rows

  const int m_tiles = (Tq + 15) / 16;
  const int n_ktiles = (Tk + kKeyTile - 1) / kKeyTile;

  // every warp runs the same rounds and key tiles, so the block-wide
  // barriers are reached uniformly; `active` only gates the math
  for (int r0 = 0; r0 < m_tiles; r0 += warps) {
    const int mt = r0 + warp;
    const bool active = mt < m_tiles;
    const int row0 = mt * 16;
    if (active) stage_rows<D>(qw, qb, rs, row0, 16, Tq, lane, 32);

    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
    float l_run[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int key0 = kt * kKeyTile;
      if (n_ktiles > 1 || r0 == 0) {
        if (n_ktiles > 1) __syncthreads();  // every warp is done with the last tile
        stage_rows<D>(ks, kb, rs, key0, kKeyTile, Tk, threadIdx.x, blockDim.x);
        stage_rows<D>(vs, vb, rs, key0, kKeyTile, Tk, threadIdx.x, blockDim.x);
      }
      // this lane's bias elements, loaded while the copies are in flight
      float bias_r[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + g + (e >> 1) * 8;
          const int key = key0 + j * 8 + 2 * t + (e & 1);
          bias_r[j][e] = (bb != nullptr && active && row < Tq && key < Tk)
                             ? __ldg(bb + (long long)row * Tk + key)
                             : 0.f;
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;

      // S = Q K^T over this key tile: four n8 tiles of keys
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale, bias, mask the keys past Tk; online softmax per row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + 2 * t + (e & 1);
          const float x = key < Tk ? s[j][e] * scale + bias_r[j][e] : -INFINITY;
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
        corr[i] = __expf(m_run[i] - m_new);  // 0 on the first tile
        m_run[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[j][e] - m_run[e >> 1]);
          s[j][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l_run[i] = l_run[i] * corr[i] + sum[i];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }

      // O += P V, P split into hi + lo bf16 parts, 16 keys per k-step
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + g + 8 * i;
        if (row < Tq) {
          const float inv = 1.f / l_run[i];
          bf16* orow = ob + (long long)row * rs + 2 * t;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
        }
      }
    }
    __syncwarp();  // this warp's Q rows are staged again in the next round
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out,
                        int B, int Tq, int Tk, int H, Layout lay, float scale,
                        cudaStream_t stream) {
  const int m_tiles = (Tq + 15) / 16;
  const int warps = m_tiles < kMaxMmaWarps ? m_tiles : kMaxMmaWarps;
  const size_t smem = sizeof(bf16) * (size_t)mma_smem_elems(D, warps);  // <= 34.8 KB
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
