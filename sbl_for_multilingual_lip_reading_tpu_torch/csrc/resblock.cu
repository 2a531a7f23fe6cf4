// K10: one whole eval-mode ResNet BasicBlock in one kernel, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ops/resblock.py::fused_resblock of the JAX
// package:
//   h   = relu(conv3x3(x, w1) * a1 + b1)        rounded to the compute dtype
//   out = relu(conv3x3(h, w2) * a2 + b2 + x)    the residual added in f32
// for a stride-1 block whose input and output widths are equal, with the
// eval BatchNorms folded into the per-channel affines (a, b).  x and out are
// the port's NCHW (N, C, S, S) activations, read and written in place: no
// transposed copy of an activation is made.  The weights arrive as
// (C, 3, 3, C) = (out, ky, kx, in), the wrapper's re-laying of the OIHW
// parameter (9 C^2 elements, once per call): read as a row-major (C, 9C)
// matrix, the W[n][k] of an implicit GEMM with k = (ky*3 + kx)*C + ci, the
// TPU kernel's own K order, in which one tap's input channels are contiguous.
//
// What bounds it: operations.  A block does 2 * 2 * N*S*S*9*C*C FLOP (1.1 to
// 1.3 TFLOP at N = 15360 for each of the five eligible blocks of ResNet-18)
// on 0.5 to 1.9 GB of activations.  Both routes keep the intermediate h out
// of device memory: a thread block owns Bt samples and a band of BH output
// rows (whole planes where they fit, several samples to a block), stages the
// x rows the band needs in shared memory channels last, runs conv1 as an
// implicit GEMM over the h rows conv2 needs into a shared-memory h band of
// the same form, then conv2 from that band, and adds the residual from the
// staged x.
//
// The bf16 route (resblock_mma_kernel), warpgroup MMAs through
// gemm_ring.cuh:
//  * A comes from the staged band by ldmatrix, one address per pixel row:
//    the pixel's offset plus the tap's, or a zero row for a tap outside the
//    plane, so the band is stored without a halo and never copied again;
//  * the weight k slices come by TMA through the ring's 3 stages, shared by
//    every pixel of the tile: a whole 22 x 22 plane (484 pixels) at C = 64,
//    3 planes of 11 x 11 at C = 128, 5 of 6 x 6 at C = 256, 10 of 3 x 3 at
//    C = 512.  (At C = 64 both convolutions' 147 KB of weights could stay
//    resident, but then a plane's x and h bands would no longer fit beside
//    them: three bands of rows would recompute 18% of conv1, while the
//    ring's 147 KB per 484-pixel tile from L2 run under its MMA work.)
//  * x is read with warp-coalesced loads (a warp's lanes on neighbouring
//    pixels of one channel, 8 channels a thread) and written to the band as
//    one 16-byte run per pixel; conv2's epilogue writes the block's output
//    over the staged x it has just read as the residual, and the band goes
//    back to NCHW the same way (8 channels of a pixel from one 16-byte read,
//    each channel's store coalesced across the warp);
//  * the epilogues (affine from shared memory, ReLU, rounding, residual)
//    are applied to the accumulators in registers.
//
// The f32 route (resblock_kernel<float>) is the card's f32 check: the band
// staged with a zero halo, both convolutions through gemm_tile.cuh's f32
// FMA tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_ring.cuh"
#include "gemm_tile.cuh"
#include "mma.cuh"

namespace {

using sbl::bf16;
using sbl::from_f32;
using sbl::gemm_tile;
using sbl::to_f32;

// channels of a staged pixel, padded by 16 bytes: pixels stay 16-byte
// aligned and neighbouring pixels' runs start in different banks
__host__ __device__ inline int padded_channels(int C, int elem) { return C + 16 / elem; }

// Rows of the staged x a band needs: its h rows (at most BH + 2, all inside
// the plane) and one more above and below.
__host__ __device__ inline int x_rows(int S, int BH) { return (BH + 2 < S ? BH + 2 : S) + 2; }

// A of the implicit GEMM: row m is one output pixel, whose handle is the
// offset of its window's top-left pixel in the staged buffer; k walks
// (ky, kx, ci).
template <typename T>
struct PatchA {
  const T* buf;
  int rows;      // rows of the output band this GEMM computes
  int S;         // output columns
  int buf_rows;  // rows of the staged buffer per sample
  int buf_w;     // its width, S + 2
  int C;
  int CP;        // padded_channels
  __device__ __forceinline__ int base(int m) const {
    const int per = rows * S;
    const int s = m / per;
    const int rem = m - s * per;
    const int r = rem / S;
    const int c = rem - r * S;
    return ((s * buf_rows + r) * buf_w + c) * CP;
  }
  __device__ __forceinline__ int offset(int k) const {
    const int tap = k / C;
    const int ci = k - tap * C;
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    return (ky * buf_w + kx) * CP + ci;
  }
  __device__ __forceinline__ float at(int b, int k) const { return to_f32(buf[b + offset(k)]); }
};

template <typename T>
__global__ void __launch_bounds__(sbl::kGemmThreads)
resblock_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w2,
                const float* __restrict__ aff, T* __restrict__ out, int N, int C, int S, int Bt,
                int BH, int nbands) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  T* xs = reinterpret_cast<T*>(stage + sbl::kGemmStageFloats);
  const int CP = padded_channels(C, (int)sizeof(T));
  const int XR = x_rows(S, BH);
  const int HR = BH + 2;  // h rows r0-1 .. r0+BH, those outside the plane zero
  const int XW = S + 2;   // columns -1 .. S
  T* hs = xs + (long long)Bt * XR * XW * CP;

  const int band = blockIdx.x % nbands;
  const int n_base = (blockIdx.x / nbands) * Bt;
  const int r0 = band * BH;
  // the h rows conv2 reads that lie inside the plane: only these are computed
  const int h_lo = max(r0 - 1, 0);
  const int h_hi = min(r0 + BH, S - 1);
  const int nh = h_hi - h_lo + 1;
  const int j0 = h_lo - (r0 - 1);      // their first row in the h buffer
  const int n_out = min(BH, S - r0);   // output rows of this band
  const int x_off = r0 - h_lo + 1;     // x buffer row of output row 0
  const float* a1 = aff;
  const float* b1 = aff + C;
  const float* a2 = aff + 2 * C;
  const float* b2 = aff + 3 * C;
  const int K = 9 * C;

  // stage x rows h_lo-1 .. h_hi+1 with a zero halo: a warp takes one NCHW row
  // at a time (its lanes the columns, so the device reads are contiguous)
  // and writes it channels last; zero the h band (its halo stays zero)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const T zero = from_f32<T>(0.f);
  for (int s = 0; s < Bt; ++s) {
    const int n = n_base + s;
    for (int c = warp; c < C; c += n_warps) {
      for (int row = 0; row < XR; ++row) {
        const int gy = h_lo - 1 + row;
        const bool row_ok = n < N && row < nh + 2 && gy >= 0 && gy < S;
        const T* src = x + (((long long)(row_ok ? n : 0) * C + c) * S + (row_ok ? gy : 0)) * S;
        T* dst = xs + ((long long)(s * XR + row) * XW) * CP + c;
        for (int col = lane; col < XW; col += 32) {
          const int gx = col - 1;
          dst[col * CP] = (row_ok && gx >= 0 && gx < S) ? src[gx] : zero;
        }
      }
    }
  }
  {
    uint4* hz = reinterpret_cast<uint4*>(hs);
    const int n16 = (int)((long long)Bt * HR * XW * CP * sizeof(T) / sizeof(uint4));
    for (int i = threadIdx.x; i < n16; i += blockDim.x) hz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // Per row of the current 64-row tile, where its results go: filled before
  // the tile's GEMMs, so that the epilogue divides nothing.
  __shared__ int row_smem[sbl::kTileM];         // offset in hs (conv1) or xs (conv2)
  __shared__ long long row_out[sbl::kTileM];    // offset in out, -1 for a padding sample

  // conv1 over the nh rows of h inside the plane
  {
    const PatchA<T> a{xs, nh, S, XR, XW, C, CP};
    const int M = Bt * nh * S;
    auto epi = [&](int m, int n, float acc) {
      const float v = fmaxf(acc * a1[n] + b1[n], 0.f);
      hs[row_smem[m & (sbl::kTileM - 1)] + n] = from_f32<T>(v);
    };
    for (int m0 = 0; m0 < M; m0 += sbl::kTileM) {
      __syncthreads();  // the previous tile's epilogue has read the table
      if (threadIdx.x < sbl::kTileM && m0 + threadIdx.x < M) {
        const int m = m0 + threadIdx.x;
        const int per = nh * S;
        const int s = m / per;
        const int rem = m - s * per;
        const int lr = rem / S;
        const int xc = rem - lr * S;
        row_smem[threadIdx.x] = ((s * HR + j0 + lr) * XW + xc + 1) * CP;
      }
      for (int n0 = 0; n0 < C; n0 += sbl::kTileN)
        gemm_tile<T>(a, M, K, w1, (long long)K, C, m0, n0, stage, epi);
    }
  }
  __syncthreads();

  // conv2 over the band's output rows, affine, residual in f32, ReLU, store
  {
    const PatchA<T> a{hs, n_out, S, HR, XW, C, CP};
    const int M = Bt * n_out * S;
    const long long plane = (long long)S * S;
    auto epi = [&](int m, int n, float acc) {
      const long long o = row_out[m & (sbl::kTileM - 1)];
      if (o < 0) return;
      const float res = to_f32(xs[row_smem[m & (sbl::kTileM - 1)] + n]);
      const float y = (acc * a2[n] + b2[n]) + res;
      out[o + n * plane] = from_f32<T>(fmaxf(y, 0.f));
    };
    for (int m0 = 0; m0 < M; m0 += sbl::kTileM) {
      __syncthreads();
      if (threadIdx.x < sbl::kTileM && m0 + threadIdx.x < M) {
        const int m = m0 + threadIdx.x;
        const int per = n_out * S;
        const int s = m / per;
        const int rem = m - s * per;
        const int orow = rem / S;
        const int xc = rem - orow * S;
        const int nn = n_base + s;
        row_smem[threadIdx.x] = ((s * XR + orow + x_off) * XW + xc + 1) * CP;
        row_out[threadIdx.x] =
            nn < N ? ((long long)nn * C * S + r0 + orow) * S + xc : -1LL;
      }
      for (int n0 = 0; n0 < C; n0 += sbl::kTileN)
        gemm_tile<T>(a, M, K, w2, (long long)K, C, m0, n0, stage, epi);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* w2, const void* aff, void* out,
                   int N, int C, int S, int Bt, int BH, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resblock_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nbands = (S + BH - 1) / BH;
  const long long blocks = (long long)((N + Bt - 1) / Bt) * nbands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  resblock_kernel<T><<<(unsigned)blocks, sbl::kGemmThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const float*>(aff), static_cast<T*>(out), N, C, S, Bt, BH, nbands);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The bf16 route, on the tensor cores.

constexpr int kConvBN = 64;     // output channels of a ring stage: one wgmma's
constexpr int kConvMaxMB = 4;   // 64-row tiles per warpgroup: a pass covers 2 x 4 x 64 = 512 pixels

__host__ __device__ inline long long align16(long long v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int conv_c8(int C) { return (C + 7) / 8 * 8; }
// a staged pixel's channels: C rounded up to 16, plus 8, so that pixels are
// an odd number of 16-byte units apart and ldmatrix's eight row addresses
// fall in eight different bank groups
__host__ __device__ inline int conv_cp(int C) { return (C + 15) / 16 * 16 + 8; }
// rows of x and of h a band of BH output rows stages (at most)
__host__ __device__ inline int band_x_rows(int S, int BH) { return BH + 4 < S ? BH + 4 : S; }
__host__ __device__ inline int band_h_rows(int S, int BH) { return BH + 2 < S ? BH + 2 : S; }

// shared memory of a block, in bytes from the start: the x band, the h
// band, a zero row, the folded BatchNorms (a1, b1, a2, b2 as f32), the ring
struct ConvLayout {
  long long xs, hs, zero, aff, ring, total;
};

__host__ __device__ inline ConvLayout make_conv_layout(int C, int S, int Bt, int BH) {
  const long long cp = conv_cp(C);
  ConvLayout o;
  long long off = 0;
  o.xs = off;   off = align16(off + 2LL * Bt * band_x_rows(S, BH) * S * cp);
  o.hs = off;   off = align16(off + 2LL * Bt * band_h_rows(S, BH) * S * cp);
  o.zero = off; off = align16(off + 2LL * cp);
  o.aff = off;  off = align16(off + 16LL * C);
  o.ring = off; off += sbl::ring_bytes(kConvBN);
  o.total = off;
  return o;
}

// gemm_ring's A: pixel m of a band staged channels last (rows_alloc rows of
// S pixels per sample, the first at plane row row_lo), whose rows from row0
// the GEMM walks; k = tap * C8 + ci.  A tap outside the plane (and k past
// the 9 taps) reads the zero row.
struct BandPatch {
  const bf16* buf;
  const bf16* zero;
  int M;           // pixels of the GEMM
  int per;         // of them per sample
  int S, CP, C8;
  int c8_shift;    // log2(C8) where C8 is a power of two, else -1
  int rows_alloc;  // staged rows per sample
  int row_lo;      // plane row of staged row 0
  int row0;        // plane row of the GEMM's first pixel row
  struct Row {
    int off;
    unsigned mask;  // bit tap: the tap's pixel is inside the plane
  };
  struct KCol {
    int delta, ci, tap;
  };
  __device__ __forceinline__ Row row(int m) const {
    Row r{0, 0u};
    if (m < M) {
      const int s = m / per;
      const int rem = m - s * per;
      const int rr = rem / S;
      const int col = rem - rr * S;
      const int prow = row0 + rr;
      r.off = ((s * rows_alloc + prow - row_lo) * S + col) * CP;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int y = prow + tap / 3 - 1;
        const int xx = col + tap % 3 - 1;
        if (y >= 0 && y < S && xx >= 0 && xx < S) r.mask |= 1u << tap;
      }
    }
    return r;
  }
  __device__ __forceinline__ KCol kcol(int k) const {
    const int tap = c8_shift >= 0 ? k >> c8_shift : k / C8;
    const int ci = k - tap * C8;
    return {((tap / 3 - 1) * S + (tap % 3 - 1)) * CP + ci, ci, tap};
  }
  __device__ __forceinline__ const bf16* addr(Row r, KCol k) const {
    return ((r.mask >> k.tap) & 1u) ? buf + r.off + k.delta : zero + k.ci;
  }
};

// gemm_ring's W: the (C, 9C) weight, k = tap * C8 + ci (zero for ci >= C);
// through its TMA map where there is one (C a multiple of 8, so C8 = C)
struct ConvW {
  const bf16* w;
  int C, C8;
  const CUtensorMap* map;
  static constexpr int map_row = 0, map_col = 0;
  __device__ __forceinline__ const bf16* row(int n) const {
    return n < C ? w + (long long)n * 9 * C : nullptr;
  }
  __device__ __forceinline__ void fetch8(bf16* dst, const bf16* r, int k) const {
    if (r == nullptr || k >= 9 * C8) {
      sbl::zero16(dst);
    } else {
      const int tap = k / C8;
      const int ci = k - tap * C8;
      sbl::copy8_scalar(dst, r + tap * C + ci, C - ci);
    }
  }
};

__device__ __forceinline__ uint32_t pack_bits(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// MB: 64-row tiles per warpgroup, so that a GEMM pass covers 128 * MB
// pixels (the host takes the fewest that cover conv1's, at most kConvMaxMB)
template <int MB>
__global__ void __launch_bounds__(sbl::kRingThreads, 1)
    resblock_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const bf16* __restrict__ w2, const float* __restrict__ aff,
                        bf16* __restrict__ out, int N, int C, int S, int Bt, int BH, int nbands,
                        const __grid_constant__ CUtensorMap map1,
                        const __grid_constant__ CUtensorMap map2, int tma) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const ConvLayout lay = make_conv_layout(C, S, Bt, BH);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.xs);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + lay.hs);
  bf16* zero = reinterpret_cast<bf16*>(smem_raw + lay.zero);
  float* saff = reinterpret_cast<float*>(smem_raw + lay.aff);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + lay.ring);
  const int C8 = conv_c8(C);
  const int CP = conv_cp(C);
  const int XR = band_x_rows(S, BH);
  const int HR = band_h_rows(S, BH);
  const int band = blockIdx.x % nbands;
  const int n_base = (blockIdx.x / nbands) * Bt;
  const int nbt = min(Bt, N - n_base);  // samples of this block
  const int r0 = band * BH;
  const int no = min(BH, S - r0);       // output rows r0 .. r0 + no - 1
  const int hlo = max(r0 - 1, 0);       // the h rows conv2 reads: hlo .. hhi
  const int hhi = min(r0 + BH, S - 1);
  const int nh = hhi - hlo + 1;
  const int xlo = max(hlo - 1, 0);      // the x rows conv1 reads: xlo .. xhi
  const int xhi = min(hhi + 1, S - 1);
  const int nx = xhi - xlo + 1;
  const long long plane = (long long)S * S;
  const float* a1 = saff;
  const float* b1 = saff + C;
  const float* a2 = saff + 2 * C;
  const float* b2 = saff + 3 * C;
  const int K = 9 * C8;
  const int groups = C8 / 8;
  const int c8_shift = (C8 & (C8 - 1)) == 0 ? __ffs(C8) - 1 : -1;

  for (int i = threadIdx.x; i < CP; i += blockDim.x) zero[i] = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) saff[i] = aff[i];
  if (C8 != C) {
    // h's channels C .. C8 are read as A and must be zero
    uint4* hz = reinterpret_cast<uint4*>(hs);
    const int n16 = (int)((lay.zero - lay.hs) / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) hz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // x rows xlo .. xhi, channels last: a thread takes 8 channels of one pixel
  // (8 loads, each coalesced across the warp's neighbouring pixels) and
  // stores them as one 16-byte run
  {
    const int xpix = nx * S;
    for (int i = threadIdx.x; i < nbt * groups * xpix; i += blockDim.x) {
      const int pix = i % xpix;
      const int rest = i / xpix;
      const int grp = rest % groups;
      const int s = rest / groups;
      const int c = grp * 8;
      const bf16* src = x + ((long long)(n_base + s) * C + c) * plane + (long long)xlo * S + pix;
      const bf16 z = __float2bfloat16_rn(0.f);
      bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c + e < C ? src[e * plane] : z;
      *reinterpret_cast<uint4*>(xs + ((long long)s * XR * S + pix) * CP + c) =
          make_uint4(pack_bits(v[0], v[1]), pack_bits(v[2], v[3]), pack_bits(v[4], v[5]),
                     pack_bits(v[6], v[7]));
    }
  }
  __syncthreads();

  auto same = [](int n) { return n; };
  // conv1 over the h rows hlo .. hhi of each sample -> the h band, rounded
  {
    const int M = nbt * nh * S;
    const int per = nh * S;
    const BandPatch a{xs, zero, M, per, S, CP, C8, c8_shift, XR, xlo, hlo};
    const ConvW w{w1, C, C8, tma ? &map1 : nullptr};
    auto row = [&](int m) { return (m + (m / per) * (HR - nh) * S) * CP; };
    auto put = [&](int ro, int n, float acc) {
      hs[ro + n] = __float2bfloat16_rn(fmaxf(acc * a1[n] + b1[n], 0.f));
    };
    sbl::gemm_ring<2, MB>(a, w, M, C, K, ring, sbl::make_epilogue(row, same, put));
  }
  // conv2 over the output rows; affine, residual (the staged x) in f32,
  // ReLU, rounded, over the staged x
  {
    const int M = nbt * no * S;
    const int per = no * S;
    const BandPatch a{hs, zero, M, per, S, CP, C8, c8_shift, HR, hlo, r0};
    const ConvW w{w2, C, C8, tma ? &map2 : nullptr};
    auto row = [&](int m) {
      const int s = m / per;
      return ((s * XR + r0 - xlo) * S + m - s * per) * CP;
    };
    auto put = [&](int ro, int n, float acc) {
      const float y = acc * a2[n] + b2[n] + __bfloat162float(xs[ro + n]);
      xs[ro + n] = __float2bfloat16_rn(fmaxf(y, 0.f));
    };
    sbl::gemm_ring<2, MB>(a, w, M, C, K, ring, sbl::make_epilogue(row, same, put));
  }
  // the output band back to NCHW: 8 channels of a pixel from one 16-byte
  // read, each channel's store coalesced across the warp
  {
    const int opix = no * S;
    for (int i = threadIdx.x; i < nbt * groups * opix; i += blockDim.x) {
      const int pix = i % opix;
      const int rest = i / opix;
      const int grp = rest % groups;
      const int s = rest / groups;
      const int c = grp * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          xs + ((long long)(s * XR + r0 - xlo) * S + pix) * CP + c);
      const bf16* e8 = reinterpret_cast<const bf16*>(&v);
      bf16* dst = out + ((long long)(n_base + s) * C + c) * plane + (long long)r0 * S + pix;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < C) dst[e * plane] = e8[e];
    }
  }
}

template <int MB>
cudaError_t launch_mma_mb(const void* x, const void* w1, const void* w2, const void* aff,
                          void* out, int N, int C, int S, int Bt, int BH, cudaStream_t stream) {
  const ConvLayout lay = make_conv_layout(C, S, Bt, BH);
  cudaError_t err = cudaFuncSetAttribute(resblock_mma_kernel<MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return err;
  const int nbands = (S + BH - 1) / BH;
  const long long blocks = (long long)((N + Bt - 1) / Bt) * nbands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the weights' TMA maps ((C, 9C) row-major) where C is a multiple of 8
  CUtensorMap map1{}, map2{};
  const int tma = C % 8 == 0 && sbl::weight_map_fits(w1, 9LL * C) &&
                  sbl::weight_map_fits(w2, 9LL * C);
  if (tma) {
    err = sbl::make_weight_map(&map1, w1, C, 9LL * C, 9LL * C);
    if (err == cudaSuccess) err = sbl::make_weight_map(&map2, w2, C, 9LL * C, 9LL * C);
    if (err != cudaSuccess) return err;
  }
  resblock_mma_kernel<MB><<<(unsigned)blocks, sbl::kRingThreads, (size_t)lay.total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const float*>(aff), static_cast<bf16*>(out), N, C, S, Bt, BH, nbands, map1,
      map2, tma);
  return cudaGetLastError();
}

// The fewest 64-row tiles per warpgroup whose pass covers conv1's pixels
// (Bt samples of the h rows a band needs), at most kConvMaxMB.
cudaError_t launch_mma(const void* x, const void* w1, const void* w2, const void* aff, void* out,
                       int N, int C, int S, int Bt, int BH, cudaStream_t stream) {
  const int pixels = Bt * band_h_rows(S, BH) * S;
  switch (pixels <= 128 ? 1 : pixels <= 256 ? 2 : pixels <= 384 ? 3 : kConvMaxMB) {
    case 1: return launch_mma_mb<1>(x, w1, w2, aff, out, N, C, S, Bt, BH, stream);
    case 2: return launch_mma_mb<2>(x, w1, w2, aff, out, N, C, S, Bt, BH, stream);
    case 3: return launch_mma_mb<3>(x, w1, w2, aff, out, N, C, S, Bt, BH, stream);
    default: return launch_mma_mb<kConvMaxMB>(x, w1, w2, aff, out, N, C, S, Bt, BH, stream);
  }
}

}  // namespace

// Bytes of dynamic shared memory a block of (Bt samples, BH rows) needs on
// the f32 route (elem = 4); the wrapper picks (Bt, BH) with it.
extern "C" long long sbl_resblock_smem_bytes(int C, int S, int Bt, int BH, int elem) {
  const long long xw = S + 2;
  return (long long)sizeof(float) * sbl::kGemmStageFloats +
         (long long)elem * Bt * padded_channels(C, elem) * (x_rows(S, BH) * xw + (BH + 2) * xw);
}

// The same on the bf16 route; the wrapper picks (Bt, BH) with it
// (ops/resblock.py::pick_mma_tile).
extern "C" long long sbl_resblock_mma_smem_bytes(int C, int S, int Bt, int BH) {
  return make_conv_layout(C, S, Bt, BH).total;
}

// x, out: (N, C, S, S); w1, w2: (C, 3, 3, C) = (out, ky, kx, in) in x's
// dtype; aff: (4, C) f32 rows a1, b1, a2, b2.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sbl_fused_resblock(const void* x, const void* w1, const void* w2, const void* aff,
                                  void* out, int N, int C, int S, int Bt, int BH, int dtype,
                                  int device, void* stream) {
  if (N <= 0 || C <= 0 || S <= 0 || Bt <= 0 || BH <= 0 || BH > S) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w1, w2, aff, out, N, C, S, Bt, BH,
                                      (size_t)sbl_resblock_smem_bytes(C, S, Bt, BH, 4), s);
    case 1: return (int)launch_mma(x, w1, w2, aff, out, N, C, S, Bt, BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
