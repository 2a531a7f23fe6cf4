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
// matrix that is the W[n][k] operand of gemm_tile with k = (ky*3 + kx)*C + ci,
// the TPU kernel's own K order, in which one tap's input channels are
// contiguous for both operands.
//
// What bounds it: operations.  A block does 2 * 2 * N*S*S*9*C*C FLOP (1.1 to
// 1.3 TFLOP at N = 15360 for each of the five eligible blocks of ResNet-18)
// on 0.5 to 1.9 GB of activations.  The design keeps the intermediate h out
// of device memory: a thread block owns Bt samples and a band of BH output
// rows, stages the x rows the band needs with a zero halo in shared memory,
// channels last ([row][col][C + pad], so that the 16 input channels a
// thread stages per k step are one contiguous, aligned run), runs conv1 as
// an implicit GEMM over the h rows that lie inside the plane into a
// shared-memory h band of the same form whose halo stays zero, then conv2
// from that band, and adds the residual from the staged x.  Small planes
// (S <= 11) are taken whole, several samples to a block, so that the
// 2 * 9 * C * C weights that every block streams from L2 are amortised over
// enough pixels; the host picks (Bt, BH) from the shared memory it has.  The
// GEMM tile (gemm_tile.cuh) runs bf16 on the tensor cores (warp-level mma)
// and f32 on the CUDA cores.  A cuDNN composition of the block is still
// faster (PERF.md): the tile runs one mma step per barrier pair with eight
// warps to an SM; wgmma over TMA-fed stages is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"

namespace {

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
  __device__ __forceinline__ T raw(int b, int k) const { return buf[b + offset(k)]; }
  // 8 channels from a multiple of 8 stay inside one tap when 8 divides C
  __device__ __forceinline__ bool vec_ok(int, int) const { return (C & 7) == 0; }
  __device__ __forceinline__ uint4 raw8(int b, int k) const {
    return *reinterpret_cast<const uint4*>(buf + b + offset(k));
  }
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

}  // namespace

// Bytes of dynamic shared memory a block of (Bt samples, BH rows) needs;
// the wrapper picks (Bt, BH) with it.  elem = 4 (f32) or 2 (bf16).
extern "C" long long sbl_resblock_smem_bytes(int C, int S, int Bt, int BH, int elem) {
  const long long xw = S + 2;
  return (long long)sizeof(float) * sbl::kGemmStageFloats +
         (long long)elem * Bt * padded_channels(C, elem) * (x_rows(S, BH) * xw + (BH + 2) * xw);
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
  const size_t smem = (size_t)sbl_resblock_smem_bytes(C, S, Bt, BH, dtype == 0 ? 4 : 2);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w1, w2, aff, out, N, C, S, Bt, BH, smem, s);
    case 1: return (int)launch<__nv_bfloat16>(x, w1, w2, aff, out, N, C, S, Bt, BH, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
