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
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

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
