// K7 and K8: per-channel statistics of train-mode BatchNorm over an NCHW
// tensor, for Hopper (sm_90a).
//
// Replace the TPU kernels ops/batchnorm.py::channel_sums (K7: sum x and
// sum x^2 per channel) and ::channel_sums_pair (K8: sum dy and
// sum dy * (x - mean) * inv per channel) of the JAX package.  The TPU kernels
// reduce (N, HW, C) blocks; the port keeps activations NCHW, so these reduce
// an (N, C, HW) tensor over N and HW for each C: the same sums, another
// memory order.  Input f32 or bf16, f32 results.
//
// What bounds them: one read of the input (K8: of dy and x) and a few
// operations an element, so device-memory bandwidth (0.53 ms for the stem's
// 1.78 GB of bf16 at 3.35 TB/s, twice that for K8).  To stream at that rate
// an SM needs some 32 KB of loads in flight, in 16-byte loads; and K7's
// bf16 route reads 7 elements a clock an SM, against 16 f32 -> f64
// conversions a clock an SM, so it can afford one conversion an element,
// not two.
//
// Geometry (ops/batchnorm.py::tiling picks it, and the CPU tests emulate the
// index arithmetic below).  A block of 256 threads owns a group of cg
// adjacent channels, whose run of cg * HW positions is contiguous in every
// sample's row, and a chunk of samples.  Its 2048 position slots (8 a
// thread) hold `phases` = 2048 / (cg * HW) copies of the run, one per
// sample phase, so the deep layers' short runs (HW = 9) still fill the
// block: slot f reads run position f % run of samples n_lo + f / run,
// + phases, ...  A thread owns its positions as pieces of EPV contiguous
// elements: on the vector route one 16-byte load a piece (8 bf16 or 4 f32),
// when the row C * HW and the run are multiples of EPV and the pointers are
// 16-byte aligned, so every piece is; otherwise the scalar route, the same
// kernel with EPV = 1 (8 single elements a thread).  The channel of each
// owned position is fixed per thread, so a piece may straddle two channels
// (HW = 9, 36, 121) at no cost.  The sample loop is software-pipelined:
// the next U samples' loads are issued before the current U samples' adds,
// two register stages, up to 192 bytes a thread (96 KB an SM at 2 blocks).
// Blocks: as many chunks per group as fill the card once (chunks = blocks
// resident / groups), so no block waits for a second wave and a block's
// own reduction happens once.
//
// Reduction, in a fixed order with no float atomics, so two calls are
// bit-identical: each position sums its samples in order; the block then
// sums its positions per channel through shared memory (a warp per channel,
// lanes over (phase, position), a fixed shuffle tree) into a (2, chunks, C)
// partial buffer; the block that arrives last at its group (an integer
// arrival counter, which it resets to 0 for the next call) sums the group's
// partials in chunk order, lanes over chunks and a fixed shuffle tree.  One
// launch a call.
//
// Accuracy: each term (x, x*x; dy, dy*xhat) is formed in f32, as the plain
// version forms it.  Sums that can cancel (x, dy, dy*xhat) run in double
// throughout.  K7's sum of squares, whose terms are all >= 0, runs per
// position as a compensated f32 pair (TwoSum: hi + lo is exact after each
// add but for the rounding of lo), folded into double once: over n terms
// its error is below (n u)^2 of the sum (u = 2^-24; 1.2e-8 at the stem's
// 1800 samples a position), at most a fifth of an f32 ulp, and it saves
// the second conversion an element.  So each channel's result is its exact sum rounded
// once to f32, whatever the tiling, and equals the plain version's but for
// a rounding near a tie.  f32 chains would sit several ulps off: the means
// and variances then move by an ulp, ReLU and max-pool route some gradients
// elsewhere, and the kernel path's B=16 gradients left the plain path's by
// 3e-3 where they must stay within 1e-3.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPositions = 8;                    // positions a thread owns
constexpr int kMaxRun = kThreads * kPositions;   // position slots of a block
// blocks an SM holds: 128 registers a thread (K8's scalar route, whose 8
// slots of dy, x, mean and inv need more, takes one block an SM and does
// not spill)
constexpr int kMinBlocks = 2;

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (hi, lo) += t, hi + lo exact: Knuth's TwoSum of hi and t, its rounding
// error added into lo.  Each operation rounded as written (no contraction).
__device__ __forceinline__ void two_sum_add(float& hi, float& lo, float t) {
  const float s = __fadd_rn(hi, t);
  const float tp = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, tp)), __fsub_rn(t, tp));
  hi = s;
  lo = __fadd_rn(lo, err);
}

// One piece: EPV contiguous elements of T read by one load, 16 bytes on
// the vector route, one element on the scalar route (EPV = 1).
template <typename T, int EPV>
struct Piece {
  static_assert(EPV * sizeof(T) == 16, "a vector piece is 16 bytes");
  uint4 v;
  __device__ __forceinline__ void load(const T* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int e) const {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {
      // bf16: element e is the low (e even) or high half of word e / 2
      return __uint_as_float(e % 2 == 0 ? w[e / 2] << 16 : w[e / 2] & 0xffff0000u);
    }
  }
};

template <typename T>
struct Piece<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = __ldg(p); }
  __device__ __forceinline__ float at(int) const { return sbl::to_f32(v); }
};

// x (and dy for kPair): (N, C, HW).  Block (g, k) sums channels
// [g*cg, min(C, (g+1)*cg)) over samples [k*N/chunks, (k+1)*N/chunks) into
// part[k * C + c] and part[(chunks + k) * C + c]; the last block of group g
// to arrive writes out[c] and out[C + c].
template <typename T, bool kPair, int EPV, int U>
__global__ void __launch_bounds__(kThreads, kPair && EPV == 1 ? 1 : kMinBlocks)
    channel_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ mean, const float* __restrict__ inv,
                        double* __restrict__ part, unsigned* __restrict__ arrivals,
                        float* __restrict__ out, int N, int C, int HW, int cg, int chunks) {
  constexpr int S = kPositions / EPV;  // pieces a thread owns
  __shared__ double red[2][kMaxRun];
  __shared__ bool last;
  const int g = blockIdx.x, k = blockIdx.y;
  const int c0 = g * cg;
  const int n_ch = min(cg, C - c0);
  const int run = cg * HW;                 // positions of a full group's run
  const int phases = kMaxRun / run;
  const int pieces = run / EPV;            // pieces of a full run
  const int live = n_ch * HW / EPV;        // pieces of this group's run
  const long long row = (long long)C * HW;
  const int n_lo = (int)((long long)k * N / chunks);
  const int n_hi = (int)((long long)(k + 1) * N / chunks);
  const long long step = (long long)phases * row;

  // piece j of this thread: slot f = threadIdx.x + j * kThreads, phase
  // f / pieces, piece f % pieces of the run; cnt[j] samples of the chunk
  // fall to its phase (0 for a slot past the run or the phases); at[j] is
  // the offset of its first sample's piece in x and dy
  long long at[S];
  int cnt[S];
  float m[S][EPV], iv[S][EPV];  // K8: mean and inv of each owned position
  // the sums of each owned position: sum x and, for K8, sum dy * xhat in
  // double; K7's sum x^2 as a compensated f32 pair (hi + lo)
  double a0[S][EPV], a1[S][EPV];
  float h1[S][EPV], l1[S][EPV];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int f = threadIdx.x + j * kThreads;
    const int ph = f / pieces, v = f - ph * pieces;
    const bool on = ph < phases && v < live;
    cnt[j] = on ? max(0, (n_hi - n_lo - ph + phases - 1) / phases) : 0;
    at[j] = on ? (long long)(n_lo + ph) * row + (long long)c0 * HW + (long long)v * EPV : 0;
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      a0[j][e] = 0.0;
      a1[j][e] = 0.0;
      h1[j][e] = 0.0f;
      l1[j][e] = 0.0f;
      const int c = on ? c0 + (v * EPV + e) / HW : 0;
      m[j][e] = kPair && on ? mean[c] : 0.0f;
      iv[j][e] = kPair && on ? inv[c] : 0.0f;
    }
  }
  const int iters = (n_hi - n_lo + phases - 1) / phases;

  Piece<T, EPV> xa[U][S], xb[U][S], ga[U][S], gb[U][S];
  auto load = [&](Piece<T, EPV>(&xs)[U][S], Piece<T, EPV>(&gs)[U][S], int i0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (i0 + u < cnt[j]) {
          const long long o = at[j] + (long long)(i0 + u) * step;
          xs[u][j].load(x + o);
          if constexpr (kPair) gs[u][j].load(dy + o);
        }
  };
  auto add = [&](Piece<T, EPV>(&xs)[U][S], Piece<T, EPV>(&gs)[U][S], int i0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (i0 + u < cnt[j]) {
#pragma unroll
          for (int e = 0; e < EPV; ++e) {
            const float v = xs[u][j].at(e);
            if constexpr (kPair) {
              const float gv = gs[u][j].at(e);
              const float gx = __fmul_rn(gv, __fmul_rn(__fsub_rn(v, m[j][e]), iv[j][e]));
              a0[j][e] += (double)gv;
              a1[j][e] += (double)gx;
            } else {
              a0[j][e] += (double)v;
              two_sum_add(h1[j][e], l1[j][e], __fmul_rn(v, v));
            }
          }
        }
  };
  // two register stages: the next U samples' loads go out before the
  // current U samples' adds
  load(xa, ga, 0);
  for (int i0 = 0; i0 < iters; i0 += 2 * U) {
    load(xb, gb, i0 + U);
    add(xa, ga, i0);
    load(xa, ga, i0 + 2 * U);
    add(xb, gb, i0 + U);
  }

  // the block's positions, per channel: slot f's element e sits at
  // red[q][f * EPV + e] = red[q][phase * run + position]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* part1 = part + (long long)chunks * C;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int f = threadIdx.x + j * kThreads;
    if (f < phases * pieces) {
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        red[0][f * EPV + e] = a0[j][e];
        red[1][f * EPV + e] = kPair ? a1[j][e] : (double)h1[j][e] + (double)l1[j][e];
      }
    }
  }
  __syncthreads();
  for (int ch = warp; ch < n_ch; ch += kThreads / 32) {
    double t0 = 0.0, t1 = 0.0;
    for (int i = lane; i < phases * HW; i += 32) {
      const int ph = i / HW;
      const int at_i = ph * run + ch * HW + (i - ph * HW);
      t0 += red[0][at_i];
      t1 += red[1][at_i];
    }
    t0 = warp_sum_f64(t0);
    t1 = warp_sum_f64(t1);
    if (lane == 0) {
      part[(long long)k * C + c0 + ch] = t0;
      part1[(long long)k * C + c0 + ch] = t1;
    }
  }

  // the last block of the group to arrive sums its partials in chunk order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + g, 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int ch = warp; ch < n_ch; ch += kThreads / 32) {
    double t0 = 0.0, t1 = 0.0;
    for (int kk = lane; kk < chunks; kk += 32) {
      t0 += __ldcg(part + (long long)kk * C + c0 + ch);
      t1 += __ldcg(part1 + (long long)kk * C + c0 + ch);
    }
    t0 = warp_sum_f64(t0);
    t1 = warp_sum_f64(t1);
    if (lane == 0) {
      out[c0 + ch] = (float)t0;
      out[C + c0 + ch] = (float)t1;
    }
  }
  if (threadIdx.x == 0) arrivals[g] = 0;
}

// samples a register stage holds (U), chosen by measurement: K7 4 bf16
// samples (4 loads a thread) or 3 f32 samples of its 2 pieces (at 2 the f32
// stem takes 4% longer; at 4 the body spills and is no faster); K8 2 bf16
// or 1 f32 sample of dy and x (4 loads); the scalar route one sample (8 or
// 16 loads)
template <bool kPair, int EPV>
constexpr int stage_samples() {
  if (EPV == 1) return 1;
  if (kPair) return 2 * EPV / kPositions;
  return EPV == 8 ? 4 : 3;
}

template <typename T, bool kPair, int EPV>
void* kernel_of() {
  return reinterpret_cast<void*>(channel_sums_kernel<T, kPair, EPV, stage_samples<kPair, EPV>()>);
}

template <bool kPair>
void* pick(int vec, int dtype) {
  if (dtype == 0) return vec ? kernel_of<float, kPair, 4>() : kernel_of<float, kPair, 1>();
  if (dtype == 1)
    return vec ? kernel_of<__nv_bfloat16, kPair, 8>() : kernel_of<__nv_bfloat16, kPair, 1>();
  return nullptr;
}

template <bool kPair>
int launch(const void* x, const void* dy, const float* mean, const float* inv, double* part,
           unsigned* arrivals, float* out, int N, int C, int HW, int cg, int chunks, int vec,
           int dtype, int device, void* stream) {
  void* kernel = pick<kPair>(vec, dtype);
  const int epv = vec ? 16 / (dtype == 0 ? 4 : 2) : 1;
  if (kernel == nullptr || N <= 0 || C <= 0 || HW <= 0 || cg <= 0 || cg > C ||
      (long long)cg * HW > kMaxRun || chunks <= 0 || chunks > N || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  // the vector route: every piece 16 bytes and 16-byte aligned
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  if (vec && (((long long)C * HW) % epv != 0 || ((long long)cg * HW) % epv != 0 ||
              !aligned(x) || (kPair && !aligned(dy))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int groups = (C + cg - 1) / cg;
  const dim3 grid((unsigned)groups, (unsigned)chunks);
  void* args[] = {&x, &dy, &mean, &inv, &part, &arrivals, &out, &N, &C, &HW, &cg, &chunks};
  err = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, 0,
                         static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // namespace

// x: (N, C, HW) contiguous, f32 (dtype 0) or bf16 (dtype 1).  part: 2 *
// chunks * C double scratch; arrivals: ceil(C / cg) unsigned counters, 0
// before the call and 0 after it; out: 2 * C f32, [sum x | sum x^2].  cg
// channels per block (cg * HW <= 2048), chunks blocks along N (chunks <= N).
// vec 1: the 16-byte route (C * HW and cg * HW multiples of 16 bytes' worth
// of elements, x 16-byte aligned), vec 0: the scalar route.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sbl_channel_sums(const void* x, void* part, void* arrivals, void* out, int N,
                                int C, int HW, int cg, int chunks, int vec, int dtype,
                                int device, void* stream) {
  return launch<false>(x, nullptr, nullptr, nullptr, static_cast<double*>(part),
                       static_cast<unsigned*>(arrivals), static_cast<float*>(out), N, C, HW,
                       cg, chunks, vec, dtype, device, stream);
}

// dy, x: (N, C, HW) contiguous, the same dtype; mean, inv: (C,) f32.  out:
// 2 * C f32, [sum dy | sum dy * (x - mean) * inv].  Otherwise as above (the
// vector route also needs dy 16-byte aligned).
extern "C" int sbl_channel_sums_pair(const void* dy, const void* x, const void* mean,
                                     const void* inv, void* part, void* arrivals, void* out,
                                     int N, int C, int HW, int cg, int chunks, int vec,
                                     int dtype, int device, void* stream) {
  return launch<true>(x, dy, static_cast<const float*>(mean), static_cast<const float*>(inv),
                      static_cast<double*>(part), static_cast<unsigned*>(arrivals),
                      static_cast<float*>(out), N, C, HW, cg, chunks, vec, dtype, device,
                      stream);
}

// Blocks of the K7 (pair 0) or K8 (pair 1) kernel of a route (vec) and
// dtype that one SM holds at once, or minus the cudaError_t of the query.
extern "C" long long sbl_channel_sums_blocks_per_sm(int pair, int vec, int dtype, int device) {
  void* kernel = pair ? pick<true>(vec, dtype) : pick<false>(vec, dtype);
  if (kernel == nullptr) return -(long long)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -(long long)err;
}
