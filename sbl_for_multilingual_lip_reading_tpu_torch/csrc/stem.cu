// K2: the temporal frame stack feeding the Conv3D-as-2D stem, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ops/stem.py::stack_frames of the JAX package:
//   (B, T, H, W) -> (B, T, kt, H, W),  out[b, t, k] = in[b, t + k - kt/2],
// zero outside [0, T).
//
// What bounds it: a pure copy.  At B=512, T=30, 88x88 bf16 it writes 1.19 GB
// and reads 0.24 GB, so it is bound by device-memory bandwidth.  The design
// moves 16 bytes per thread access (an 88x88 bf16 plane is 15,488 B =
// 968 x 16 B), so planes and pointers must be 16-byte aligned; the wrapper
// checks, and so does the entry point.  One thread owns one 16-byte vector of a
// plane and writes it into all kt output planes of its (b, t), so every
// store is a full 16-byte vector, neighbouring threads store neighbouring
// vectors, and each input vector is re-read kt times from L2 rather than
// from device memory.  The copy is dtype-agnostic: it moves bytes, so the
// output is bit-exact for every element type, and the zero pad is the all-
// zero bit pattern (+0.0).
//
// K9 (below K2 in this file) fuses the eval ingest into the same pass; its
// note stands at its kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using V = uint4;  // 16 bytes

__global__ void stack_frames_kernel(const V* __restrict__ in, V* __restrict__ out, int T, int kt,
                                    long long n_bt, long long vec_per_plane) {
  const long long off = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (off >= vec_per_plane) return;
  const int pad = kt / 2;
  for (long long bt = blockIdx.y; bt < n_bt; bt += gridDim.y) {
    const int t = (int)(bt % T);
    V* o = out + bt * kt * vec_per_plane + off;
    for (int kk = 0; kk < kt; ++kk) {
      const int src = t + kk - pad;
      V val{};
      if (src >= 0 && src < T) val = in[(bt + kk - pad) * vec_per_plane + off];
      o[(long long)kk * vec_per_plane] = val;
    }
  }
}

// K9: eval ingest + temporal stack in one pass.  Replaces the TPU kernel
// ops/stem.py::stack_frames_u8 of the JAX package:
//   out[b, t, k, r, c] = norm(clip[b, t + k - kt/2, c0 + r, c0 + c]),  zero
// outside [0, T), with norm(v) = v * (1 / (255 STD)) - MEAN / STD and c0 the
// center crop's offset.  No n_frames zeroing, as in the TPU kernel: it serves
// fixed-length batches.
//
// What bounds it: bytes.  At B=512, T=30, 96x96 -> 88x88 it reads 141.6 MB
// of uint8 and writes 1,189 MB of bf16, so it is bound by the writes.  The
// crop starts c0 = 4 bytes into each source row, so the source is read by
// bytes (K2's 16-byte loads do not apply); the design gives each thread VEC
// (4 when the crop is a multiple of 4, else 1) neighbouring pixels of one
// output plane position and has it write them into all kt slots of its
// (b, t): every store is VEC elements wide (8 bytes of bf16, 16 of f32),
// neighbouring threads store neighbouring vectors, and each source byte is
// read kt times, from L2 after the first.  The normalization is __fmul_rn
// then __fsub_rn, two roundings never contracted into an FMA, as the plain
// version computes it: the kernel is bit-exact against it.
template <typename T, int VEC>
__global__ void stack_frames_u8_kernel(const uint8_t* __restrict__ clips, T* __restrict__ out,
                                       int T_, int H, int W, int crop, int c0, int kt,
                                       long long n_bt, float inv_std, float shift) {
  const int vec_per_row = crop / VEC;
  const int vec_per_plane = crop * vec_per_row;
  const int off = blockIdx.x * blockDim.x + threadIdx.x;
  if (off >= vec_per_plane) return;
  const int r = off / vec_per_row;
  const int c = (off - r * vec_per_row) * VEC;
  const int pad = kt / 2;
  const long long src_off = (long long)(c0 + r) * W + c0 + c;
  const long long plane = (long long)crop * crop;
  for (long long bt = blockIdx.y; bt < n_bt; bt += gridDim.y) {
    const int t = (int)(bt % T_);
    T* o = out + bt * kt * plane + (long long)r * crop + c;
    for (int kk = 0; kk < kt; ++kk) {
      const int src = t + kk - pad;
      __align__(16) T vals[VEC];
      if (src >= 0 && src < T_) {
        const uint8_t* px = clips + (bt + kk - pad) * (long long)H * W + src_off;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          vals[e] = sbl::from_f32<T>(__fsub_rn(__fmul_rn((float)px[e], inv_std), shift));
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = sbl::from_f32<T>(0.0f);
      }
      T* dst = o + (long long)kk * plane;
      if (VEC == 4 && sizeof(T) == 2) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(vals);
      } else if (VEC == 4 && sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = vals[e];
      }
    }
  }
}

template <typename T>
cudaError_t launch_u8(const void* clips, void* out, long long B, int T_, int H, int W, int crop,
                      int c0, int kt, float inv_std, float shift, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long n_bt = B * (long long)T_;
  const unsigned gy = (unsigned)(n_bt < 65535 ? n_bt : 65535);
  const uint8_t* c = static_cast<const uint8_t*>(clips);
  T* o = static_cast<T*>(out);
  // the vector stores need the crop a multiple of 4 and out 16-byte aligned
  if (crop % 4 == 0 && (uintptr_t)out % 16 == 0) {
    const int vecs = crop * (crop / 4);
    stack_frames_u8_kernel<T, 4><<<dim3((unsigned)((vecs + kThreads - 1) / kThreads), gy),
                                   kThreads, 0, stream>>>(c, o, T_, H, W, crop, c0, kt, n_bt,
                                                           inv_std, shift);
  } else {
    const int vecs = crop * crop;
    stack_frames_u8_kernel<T, 1><<<dim3((unsigned)((vecs + kThreads - 1) / kThreads), gy),
                                   kThreads, 0, stream>>>(c, o, T_, H, W, crop, c0, kt, n_bt,
                                                           inv_std, shift);
  }
  return cudaGetLastError();
}

}  // namespace

// clips: (B, T, H, W) uint8; out: (B, T, kt, crop, crop) in f32 (dtype 0) or
// bf16 (dtype 1); c0: the crop's offset into rows and columns.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sbl_stack_frames_u8(const void* clips, void* out, long long B, int T, int H, int W,
                                   int crop, int c0, int kt, float inv_std, float shift,
                                   int dtype, int device, void* stream) {
  if (B <= 0 || T <= 0 || kt <= 0 || crop <= 0 || c0 < 0 || c0 + crop > H || c0 + crop > W)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_u8<float>(clips, out, B, T, H, W, crop, c0, kt, inv_std, shift, s);
    case 1:
      return (int)launch_u8<__nv_bfloat16>(clips, out, B, T, H, W, crop, c0, kt, inv_std, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// in: (B, T, plane) and out: (B, T, kt, plane), plane = plane_bytes bytes,
// both pointers and plane_bytes multiples of 16.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sbl_stack_frames(const void* in, void* out, long long B, int T,
                                long long plane_bytes, int kt, int device, void* stream) {
  if (B <= 0 || T <= 0 || plane_bytes <= 0 || kt <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)in | (uintptr_t)out | (uintptr_t)plane_bytes) % sizeof(V) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kThreads = 256;
  const long long n_bt = B * (long long)T;
  const long long vec_per_plane = plane_bytes / (long long)sizeof(V);
  const long long gx = (vec_per_plane + kThreads - 1) / kThreads;
  const long long gy = n_bt < 65535 ? n_bt : 65535;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stack_frames_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(in), static_cast<V*>(out), T, kt, n_bt, vec_per_plane);
  return (int)cudaGetLastError();
}
