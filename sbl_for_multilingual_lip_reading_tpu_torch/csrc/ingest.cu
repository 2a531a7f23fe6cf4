// K6: the training ingest, uint8 clips + augmentation plans -> normalized
// crops, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/ingest.py::ingest_train of the JAX package:
//   out[b, t, r, c] = clip[b, fm, oy + r, ox + (flip ? crop-1-c : c)]
//                     * (1 / (255 STD)) - MEAN / STD
// with fm = frame_map[b, t] (FrameRemoval), (oy, ox) = offsets[b, t]
// (per-frame RandomCrop), flip[b] (whole-clip HorizontalFlip), and the slots
// t >= n_frames[b] zeroed after the normalization.
//
// What bounds it: a gather and an affine map.  At B=240, T=30, 96x96 -> 88x88
// bf16 it reads at most the 66 MB of clips and writes 111 MB, so device-memory
// bandwidth bounds it (~0.05 ms at 3.35 TB/s).  The design: one block per
// (b, t) output frame, which reads its plan once; its threads walk the
// crop x crop pixels in row-major order, so neighbouring threads read
// neighbouring bytes of a source row (in reverse when flipped) and store
// neighbouring outputs.  The normalization is __fmul_rn then __fsub_rn: two
// roundings, never contracted into one FMA, as the plain version computes
// it, so the kernel is bit-exact against it.  Plans are clamped into the
// frame (the plans of make_train_plans always are), so the kernel never
// reads outside the clip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void ingest_train_kernel(const uint8_t* __restrict__ clips,
                                    const int* __restrict__ offsets,
                                    const uint8_t* __restrict__ flip,
                                    const int* __restrict__ frame_map,
                                    const int* __restrict__ n_frames, T* __restrict__ out,
                                    int T_, int H, int W, int crop, float inv_std,
                                    float shift) {
  const long long bt = blockIdx.x;
  const int b = (int)(bt / T_);
  const int t = (int)(bt % T_);
  const int n_pix = crop * crop;
  T* o = out + bt * n_pix;
  if (n_frames != nullptr && t >= n_frames[b]) {
    for (int p = threadIdx.x; p < n_pix; p += blockDim.x) o[p] = sbl::from_f32<T>(0.0f);
    return;
  }
  const int src = min(max(frame_map[bt], 0), T_ - 1);
  const int oy = min(max(offsets[2 * bt], 0), H - crop);
  const int ox = min(max(offsets[2 * bt + 1], 0), W - crop);
  const bool fl = flip[b] != 0;
  const uint8_t* frame = clips + ((long long)b * T_ + src) * H * W + (long long)oy * W + ox;
  for (int p = threadIdx.x; p < n_pix; p += blockDim.x) {
    const int r = p / crop;
    const int c = p - r * crop;
    const float v = (float)frame[r * W + (fl ? crop - 1 - c : c)];
    o[p] = sbl::from_f32<T>(__fsub_rn(__fmul_rn(v, inv_std), shift));
  }
}

}  // namespace

// clips (B, T, H, W) uint8; offsets (B, T, 2) int32 (y, x); flip (B,) uint8;
// frame_map (B, T) int32; n_frames (B,) int32 or null; out (B, T, crop,
// crop) in f32 (dtype 0) or bf16 (dtype 1).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int sbl_ingest_train(const void* clips, const void* offsets, const void* flip,
                                const void* frame_map, const void* n_frames, void* out, int B,
                                int T, int H, int W, int crop, float inv_std, float shift,
                                int dtype, int device, void* stream) {
  if (B <= 0 || T <= 0 || crop <= 0 || crop > H || crop > W) return (int)cudaErrorInvalidValue;
  if ((long long)B * T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kThreads = 256;
  const dim3 grid((unsigned)(B * T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(clips);
  const int* off = static_cast<const int*>(offsets);
  const uint8_t* fl = static_cast<const uint8_t*>(flip);
  const int* fm = static_cast<const int*>(frame_map);
  const int* nf = static_cast<const int*>(n_frames);
  if (dtype == 0) {
    ingest_train_kernel<float><<<grid, kThreads, 0, s>>>(
        c, off, fl, fm, nf, static_cast<float*>(out), T, H, W, crop, inv_std, shift);
  } else if (dtype == 1) {
    ingest_train_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        c, off, fl, fm, nf, static_cast<__nv_bfloat16*>(out), T, H, W, crop, inv_std, shift);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
