// Tensor-core building blocks of the port's bf16 attention bodies
// (attention.cu: K1/K12; attention_train.cu: K3/K4; the attention of
// decoder_layer.cu: K11) and of gemm_ring.cuh, for Hopper (sm_90a):
// 16-byte cp.async staging of bf16 rows into shared memory, ldmatrix,
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), the hi + lo bf16 split of
// an f32 A operand, the tile products every body is built from (A B^T from
// staged rows; A B with A split in registers), and the forward body
// itself, which K1/K12 run without dropout and K3 with it.
//
// Shared-memory rows hold D bf16 plus 8 of padding: a row is then 16 bytes
// past a multiple of 128, so the eight row addresses of an ldmatrix fall in
// eight different bank groups at every head width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sbl {

using bf16 = __nv_bfloat16;

constexpr int kKeyTile = 32;     // keys per score tile (four n8 tiles)
constexpr int kMaxMmaWarps = 4;  // warps of a block, 16 rows each

// bf16 elements of the forward body's dynamic shared memory: K and V
// tiles, 16 Q rows per warp
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

// acc[n] += A B^T over the head width, for n < NT (NT even): A is 16
// staged rows at a, B is 8 NT staged rows at b, both rows of D (+ 8).  The
// accumulator layout: lane (g = lane / 4, t = lane % 4) holds acc[n][0..1]
// at row g, columns 8 n + 2 t and + 1, and acc[n][2..3] at row g + 8.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                        int lane) {
  static_assert(D % 16 == 0 && NT % 2 == 0, "tile shape");
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bk[0], bk[1]);
      mma_bf16(acc[2 * np + 1], af, bk[2], bk[3]);
    }
  }
}

// acc[n] += A B[:, col0 + 8 n ...] for n < NC / 8 over one k-step of 16,
// with A = hi + lo given as two bf16 A fragments (both products issued):
// B is 16 staged rows at b, read by ldmatrix.trans.
template <int D, int NC>
__device__ __forceinline__ void mma_hl_b(float (&acc)[NC / 8][4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const bf16* b, int col0,
                                         int lane) {
  static_assert(NC % 16 == 0 && NC <= D, "tile shape");
  constexpr int LD = D + 8;
#pragma unroll
  for (int dp = 0; dp < NC / 16; ++dp) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 + dp * 16 +
                              (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
    mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
    mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
    mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
  }
}

// acc[n] += P B[:, col0 + 8 n ...] for n < NC / 8: P is 16 x 16 KS f32 held
// in the accumulator layout of 2 KS n8 tiles (the FlashAttention-2
// register reuse: a product's output is the next one's A operand), issued
// as hi = bf16(P) and lo = bf16(P - hi), so that P keeps ~2^-17 of itself
// as the f32 operands of the JAX kernels do; B is 16 KS staged rows at b.
template <int D, int KS, int NC>
__device__ __forceinline__ void mma_pb(float (&acc)[NC / 8][4], const float (&p)[2 * KS][4],
                                       const bf16* b, int col0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ph[4], pl[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
    mma_hl_b<D, NC>(acc, ph, pl, b + kk * 16 * (D + 8), col0, lane);
  }
}

// The weights of the deterministic attention: P V takes P as it is.
struct NoDropout {
  __device__ __forceinline__ float operator()(int, int, float p) const { return p; }
  __device__ __forceinline__ float scale(float inv_l) const { return inv_l; }
};

// One (batch row, head) of out = softmax(Q K^T * scale + bias) V, with
// drop(row, key, e) the weight that P V takes for the unnormalised e =
// exp(s - running max) and drop.scale(1 / rowsum) the output's scale.
// q, out: Tq rows of D at row stride rs; k, v: Tk rows; bias: null or a
// (Tq, Tk) f32 block.  Run by one block of min(ceil(Tq / 16),
// kMaxMmaWarps) warps, one warp per 16 query rows (more rows take more
// rounds), with mma_smem_elems(D, warps) bf16 of shared memory at smem.
//
// Q, K and V are staged by 16-byte cp.async (rows past Tq / Tk zero-
// filled), the bias elements a lane needs are loaded while the copies are
// in flight, S = Q K^T and P V run on the tensor cores, the scores stay in
// registers (keys past Tk set to -inf; exp is __expf, ~2^-21 relative),
// the row max and sum are taken across the quad that holds a row with two
// shuffles each, and an online (running max) softmax carries across key
// tiles, so any Tk works (K and V are staged again per tile and per round
// of rows when there is more than one tile).
template <int D, class Drop>
__device__ __forceinline__ void mha_fwd_block(const bf16* __restrict__ qb,
                                              const bf16* __restrict__ kb,
                                              const bf16* __restrict__ vb,
                                              const float* __restrict__ bb,
                                              bf16* __restrict__ ob, long long rs, int Tq,
                                              int Tk, float scale, const Drop& drop,
                                              bf16* smem) {
  static_assert(D % 16 == 0 && D <= 128, "head width");
  constexpr int LD = D + 8;
  bf16* ks = smem;               // [kKeyTile][LD]
  bf16* vs = ks + kKeyTile * LD; // [kKeyTile][LD]
  bf16* qs = vs + kKeyTile * LD; // [warps * 16][LD]

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t = lane & 3;   // its column pair within an 8-wide tile
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
      mma_abt<D, 4>(s, qw, ks, lane);

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
          sum[e >> 1] += p;
          s[j][e] = drop(row0 + g + (e >> 1) * 8, key0 + j * 8 + 2 * t + (e & 1), p);
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

      // O += P V, 16 keys per k-step
      mma_pb<D, 2, D>(o, s, vs, 0, lane);
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + g + 8 * i;
        if (row < Tq) {
          const float inv = drop.scale(1.f / l_run[i]);
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

}  // namespace sbl
