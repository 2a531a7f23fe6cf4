// K13: one cached self-attention step of an autoregressive decoder, read
// straight from its flat K/V caches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's MultiHeadAttention.decode_step
// (models/layers.py) is plain einsums, which XLA fuses.  In the port the same
// einsums cast each layer's whole caches to f32, permute them into bmm
// layout and run two GEMVs, a step and a layer at a time; this kernel does
// the whole attention core of the step in one launch:
//   write k_new, v_new into slot `step` of the caches (N, L, H*d);
//   s_j = q . k_j * scale for the slots j <= step, per (row, head);
//   out = sum_j softmax(s)_j v_j, in q's dtype.
// Slots after `step` are never read: that is the plain version's MASK_FILL
// on them (exp(-1e9 - max) is 0 in f32), without reading them.
//
// What bounds it: the bytes.  A (row, head) is a GEMV of up to L keys of d,
// ~1 FLOP per byte of the cache, far below the card's ~295 bf16 FLOP a byte,
// so the least time is the valid slots of both caches read once, q, k_new
// and v_new read and the output and the two slots written: at the CTC
// beam's (2560 rows, 33 slots, 12 heads of 64) in bf16, 2560 x 1536 B x
// (2 step + 6), 23.6 MB at step 0 (7 us at 3.35 TB/s) to 244 MB at step 31
// (73 us).  The design moves those bytes and nothing else:
//   * one warp per (row, head), kWarps of them a block: the warps share
//     nothing (no shared memory, no barrier), so the block is small and
//     registers alone set how many warps an SM holds (kMinBlocks x kWarps =
//     28 at <= 72 registers, no spill; at 64 the body spills and is no
//     faster, at 80 it is slower).  A block of a whole row (12 warps at 87
//     registers) fitted once on an SM: 12 warps, 19 waves of 132 rows, and
//     ~40 us at step 0 where the bytes take 7;
//   * a head's row of a slot (d elements, 128 B at d = 64 in bf16) is read
//     in 16-byte pieces by d / (16 / sizeof(T)) neighbouring lanes, so a
//     warp reads 32 / lanes slots a pass (four at d = 64 in bf16), each
//     slot's pieces contiguous: the reads coalesce, and the row's heads
//     together cover the slot's H*d contiguous bytes;
//   * kUnroll passes of K and V loads are issued before any is used, so a
//     warp keeps 32 lanes x kUnroll x 32 B in flight;
//   * the dot products accumulate in f32 and are summed over a slot's
//     lanes with shuffles; the softmax runs in f32 as an online (running
//     max) softmax per slot group of the warp, rescaled once a round of
//     kUnroll passes by the round's largest logit (the round's exps do not
//     wait on one another), and the groups' (max, sum, output) are merged
//     with shuffles at the end, so the probabilities
//     are never stored: no shared memory, no barrier.  They stay f32 where
//     the plain version rounds them to the compute dtype before P V, which
//     is at least as close to the float32 reference;
//   * the lanes that hold slot `step` take k_new and v_new from the inputs
//     and store them into the caches; nothing else reads that slot in the
//     launch, so there is no hazard, and no other slot is written.
// f32 runs the same body on pieces of four floats (its card check route), four
// blocks an SM: at 72 or 80 registers its narrower heads spill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;      // warps of a block, one (row, head) each
constexpr int kMinBlocks = 7;  // blocks an SM holds: 28 warps, <= 72 registers
constexpr int kMinBlocksF32 = 4;  // f32 (the check route): <= 128 registers
constexpr int kUnroll = 4;     // passes whose loads are in flight together

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// a 16-byte piece as f32 values
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]), bf16x2(f[4], f[5]),
                    bf16x2(f[6], f[7]));
}

// Grid: ceil(N * H / kWarps) blocks of kWarps warps, warp w of the grid on
// row w / H, head w % H.  q, k_new, v_new, out: (N, H*D); k_cache, v_cache:
// (N, L, H*D); all contiguous and 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, sizeof(T) == 2 ? kMinBlocks : kMinBlocksF32)
cached_attention_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                             const T* __restrict__ v_new, T* __restrict__ k_cache,
                             T* __restrict__ v_cache, T* __restrict__ out, int N, int L,
                             int H, int step, float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements a piece
  constexpr int kLanes = D / kVec;       // lanes that read one slot of a head
  constexpr int kGroups = 32 / kLanes;   // slots a warp reads a pass
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "head width");
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)N * H) return;     // the whole warp
  const int lane = threadIdx.x & 31;
  const int part = lane % kLanes;        // this lane's piece of the head's row
  const int group = lane / kLanes;       // this lane's slot within a pass
  const long long hd = (long long)H * D;
  const long long row = w / H;
  const long long col = (w % H) * D + part * kVec;
  const long long at = row * hd + col;   // in q, k_new, v_new, out

  float qf[kVec];
  unpack(load16(q + at), qf);
  float m = -INFINITY, l = 0.f, acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  T* kc = k_cache + row * L * hd + col;
  T* vc = v_cache + row * L * hd + col;

  // every lane runs the same passes (the shuffles need the whole warp); a
  // lane whose slot lies past `step` loads nothing and weighs nothing
  for (int j0 = 0; j0 <= step; j0 += kGroups * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kGroups + group;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < step) {
        kr[u] = load16(kc + j * hd);
        vr[u] = load16(vc + j * hd);
      } else if (j == step) {
        kr[u] = load16(k_new + at);
        vr[u] = load16(v_new + at);
        store16(kc + j * hd, kr[u]);
        store16(vc + j * hd, vr[u]);
      }
    }
    // the pass's logits, then one rescale of the running state by their max
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      unpack(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = j0 + u * kGroups + group <= step ? dot * scale : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = s[u] == -INFINITY ? 0.f : expf(s[u] - m_new);
      float vf[kVec];
      unpack(vr[u], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = m_new;
  }

  // merge the slot groups' softmax states; a group that held no slot has
  // m = -inf, l = 0 and weighs nothing (two such groups stay empty)
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_new = fmaxf(m, m_o);
    const float a = m == -INFINITY ? 0.f : expf(m - m_new);
    const float b = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * a + l_o * b;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * a + acc_o * b;
    }
    m = m_new;
  }
  if (group == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= inv;
    store16(out + at, pack(acc));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
                   void* v_cache, void* out, int N, int L, int H, int step, float scale,
                   cudaStream_t stream) {
  const long long blocks = ((long long)N * H + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cached_attention_step_kernel<T, D><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<T*>(out), N, L, H, step,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, void* out, int N, int L, int H, int D, int step,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k_new, v_new, k_cache, v_cache, out, N, L, H, step, scale, s);
    case 32: return launch<T, 32>(q, k_new, v_new, k_cache, v_cache, out, N, L, H, step, scale, s);
    case 64: return launch<T, 64>(q, k_new, v_new, k_cache, v_cache, out, N, L, H, step, scale, s);
    case 128:
      return launch<T, 128>(q, k_new, v_new, k_cache, v_cache, out, N, L, H, step, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// K13: q, k_new, v_new, out (N, H*D); k_cache, v_cache (N, L, H*D), slot
// `step` written; 0 <= step < L; dtype 0 = float32, 1 = bfloat16; D in {16,
// 32, 64, 128}; every pointer 16-byte aligned.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sbl_cached_attention_step(const void* q, const void* k_new, const void* v_new,
                                         void* k_cache, void* v_cache, void* out, int N, int L,
                                         int H, int D, int step, float scale, int dtype,
                                         int device, void* stream) {
  if (N <= 0 || L <= 0 || H <= 0 || step < 0 || step >= L) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k_new) && aligned16(v_new) && aligned16(k_cache) &&
        aligned16(v_cache) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_width<float>(q, k_new, v_new, k_cache, v_cache, out, N, L, H, D, step,
                                      scale, s);
    case 1:
      return (int)launch_width<bf16>(q, k_new, v_new, k_cache, v_cache, out, N, L, H, D, step,
                                     scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
