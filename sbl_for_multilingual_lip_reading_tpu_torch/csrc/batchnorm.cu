// K7 and K8: per-channel statistics of train-mode BatchNorm over an NCHW
// tensor, for Hopper (sm_90a).
//
// Replace the TPU kernels ops/batchnorm.py::channel_sums (K7: sum x and
// sum x^2 per channel) and ::channel_sums_pair (K8: sum dy and
// sum dy * (x - mean) * inv per channel) of the JAX package.  The TPU kernels
// reduce (N, HW, C) blocks; the port keeps activations NCHW, so these reduce
// an (N, C, HW) tensor over N and HW for each C: the same sums, another
// memory order.  Input f32 or bf16, sums in f32.
//
// What bounds them: one read of the input (K8: of dy and x), a few flops per
// element, so device-memory bandwidth (~0.53 ms for the stem's 1.78 GB of
// bf16 at 3.35 TB/s, twice that for K8).  The trunk's planes are small (HW =
// 1936 at the stem down to 9 in layer4), so a block per channel would walk
// runs of 18 bytes.  The design reads contiguous runs instead: a block owns
// a group of CG adjacent channels (CG * HW <= 2048 positions, one run of
// each sample's row) and a chunk of samples; each of its 256 threads owns up
// to 8 fixed positions of the run and accumulates them over the chunk's
// samples in registers, so a warp's loads are 32 neighbouring elements.
// The block then sums its positions per channel through shared memory (one
// warp per channel, a fixed shuffle tree) into a (chunks, C) partial
// buffer, and a second launch sums the partials per channel in chunk order.
// No float atomics anywhere: the order of every sum is fixed, so two runs
// are bit-identical.
//
// Accuracy: each term (x, x*x; dy, dy*xhat) is formed in f32, as the plain
// version forms it, and every sum runs in double (per position over the
// chunk's samples, per channel in shared memory, over the chunks), so each
// channel's result is its exact sum rounded once to f32, whatever the
// tiling, and equals the plain version's but for a double rounding near a
// tie.  f32 chains of up to N/chunks adds would sit several ulps off: the
// means and variances then move by an ulp, ReLU and max-pool route some
// gradients elsewhere, and the kernel path's B=16 gradients left the plain
// path's by 3e-3 where they must stay within 1e-3.  The double adds and
// conversions stay below the memory time on Hopper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kMaxRun = kThreads * kPerThread;  // positions per block run

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// x (and dy for kPair): (N, C, HW).  Block (g, k) sums channels
// [g*cg, min(C, (g+1)*cg)) over samples [k*chunk, min(N, (k+1)*chunk)) into
// part0/part1[k * C + c].
template <typename T, bool kPair>
__global__ void __launch_bounds__(kThreads)
    channel_sums_partial(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean, const float* __restrict__ inv,
                         double* __restrict__ part0, double* __restrict__ part1, int N,
                         int C, int HW, int cg, int chunk) {
  __shared__ double s0[kMaxRun];
  __shared__ double s1[kMaxRun];
  const int c0 = blockIdx.x * cg;
  const int n_ch = min(cg, C - c0);
  const int run = n_ch * HW;
  const int n_lo = blockIdx.y * chunk;
  const int n_hi = min(N, n_lo + chunk);
  const long long row = (long long)C * HW;

  double a0[kPerThread], a1[kPerThread];
  float m[kPerThread], iv[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    a0[j] = 0.0;
    a1[j] = 0.0;
    m[j] = 0.0f;
    iv[j] = 0.0f;
    const int p = threadIdx.x + j * kThreads;
    if (kPair && p < run) {
      m[j] = mean[c0 + p / HW];
      iv[j] = inv[c0 + p / HW];
    }
  }
  for (int n = n_lo; n < n_hi; ++n) {
    const long long base = n * row + (long long)c0 * HW;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = threadIdx.x + j * kThreads;
      if (p < run) {
        const float v = sbl::to_f32(x[base + p]);
        if (kPair) {
          const float g = sbl::to_f32(dy[base + p]);
          const float gx = __fmul_rn(g, __fmul_rn(__fsub_rn(v, m[j]), iv[j]));
          a0[j] += (double)g;
          a1[j] += (double)gx;
        } else {
          a0[j] += (double)v;
          a1[j] += (double)__fmul_rn(v, v);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p < run) {
      s0[p] = a0[j];
      s1[p] = a1[j];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = warp; ch < n_ch; ch += kThreads / 32) {
    double t0 = 0.0, t1 = 0.0;
    for (int p = ch * HW + lane; p < (ch + 1) * HW; p += 32) {
      t0 += s0[p];
      t1 += s1[p];
    }
    t0 = warp_sum_f64(t0);
    t1 = warp_sum_f64(t1);
    if (lane == 0) {
      part0[(long long)blockIdx.y * C + c0 + ch] = t0;
      part1[(long long)blockIdx.y * C + c0 + ch] = t1;
    }
  }
}

// out0/out1[c] = sum over k of part0/part1[k * C + c], k ascending, in
// double, rounded once to f32.
__global__ void channel_sums_finish(const double* __restrict__ part0,
                                    const double* __restrict__ part1, float* __restrict__ out0,
                                    float* __restrict__ out1, int C, int chunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double t0 = 0.0, t1 = 0.0;
  for (int k = 0; k < chunks; ++k) {
    t0 += part0[(long long)k * C + c];
    t1 += part1[(long long)k * C + c];
  }
  out0[c] = (float)t0;
  out1[c] = (float)t1;
}

template <bool kPair>
int launch(const void* x, const void* dy, const float* mean, const float* inv, double* part,
           float* out, int N, int C, int HW, int cg, int chunk, int chunks, int dtype,
           int device, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || cg <= 0 || chunk <= 0 || chunks <= 0 ||
      chunks > 65535 || (long long)cg * HW > kMaxRun || (long long)chunk * chunks < N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (C + cg - 1) / cg;
  const dim3 grid((unsigned)groups, (unsigned)chunks);
  double* part1 = part + (long long)chunks * C;
  if (dtype == 0) {
    channel_sums_partial<float, kPair><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), mean, inv, part, part1,
        N, C, HW, cg, chunk);
  } else if (dtype == 1) {
    channel_sums_partial<__nv_bfloat16, kPair><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), mean,
        inv, part, part1, N, C, HW, cg, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  channel_sums_finish<<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, part1, out, out + C, C, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, C, HW) contiguous, f32 (dtype 0) or bf16 (dtype 1).  part: 2 *
// chunks * C double scratch; out: 2 * C f32, [sum x | sum x^2].  cg channels
// per block (cg * HW <= 2048), chunks blocks along N of chunk samples each
// (chunk * chunks >= N).  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int sbl_channel_sums(const void* x, void* part, void* out, int N, int C, int HW,
                                int cg, int chunk, int chunks, int dtype, int device,
                                void* stream) {
  return launch<false>(x, nullptr, nullptr, nullptr, static_cast<double*>(part),
                       static_cast<float*>(out), N, C, HW, cg, chunk, chunks, dtype, device,
                       stream);
}

// dy, x: (N, C, HW) contiguous, the same dtype; mean, inv: (C,) f32.  out:
// 2 * C f32, [sum dy | sum dy * (x - mean) * inv].  Otherwise as above.
extern "C" int sbl_channel_sums_pair(const void* dy, const void* x, const void* mean,
                                     const void* inv, void* part, void* out, int N, int C,
                                     int HW, int cg, int chunk, int chunks, int dtype,
                                     int device, void* stream) {
  return launch<true>(x, dy, static_cast<const float*>(mean), static_cast<const float*>(inv),
                      static_cast<double*>(part), static_cast<float*>(out), N, C, HW, cg, chunk,
                      chunks, dtype, device, stream);
}
