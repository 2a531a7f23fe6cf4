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
// bandwidth bounds it (~0.05 ms at 3.35 TB/s), provided the instructions
// issued for each output stay few: the card issues some 33 T thread
// instructions a second, about 600 for each byte it can move in that time,
// and a kernel walking single pixels (a division and a remainder by the
// crop, a one-byte load, an I2F at 16 a clock an SM, a two-byte store) spends
// about 40 an output and is bound by issue, not by bytes.
//
// The design: whole 16-byte output pieces a thread, no per-pixel arithmetic
// but the normalization.
//   * A piece is 16 bytes of output (8 bf16 or 4 f32) of one output row; a
//     row holds crop / EPV pieces, and a frame's pieces are contiguous, so
//     each piece is one 16-byte st.global and a warp stores 512 contiguous
//     bytes.  Padded slots store 16-byte zeros and read nothing.
//   * A block of 256 threads owns one output frame; a thread's pieces are
//     threadIdx.x, + 256, ... of the frame.  Their (row, piece) comes from
//     one division a thread, then steps of 256 pieces by a carry (256 = dr
//     rows + dc pieces), never a division a pixel.
//   * The source bytes of a piece (EPV consecutive bytes of one source row,
//     from column ox + c0, or from ox + crop - EPV - c0 reversed when the
//     clip is flipped) lie in at most two aligned words of EPV bytes of the
//     row: both words are loaded (the same word twice when the bytes are
//     aligned), and a funnel shift by 8 * (s mod 4) takes the bytes out.
//     The row's words are in L1 after the first warp reads them, so the
//     second read costs no device-memory bytes.
//   * A thread issues the loads of U pieces (bf16 4, f32 8: 64 bytes of
//     loads in flight a thread) before converting any of them.
//   * u8 -> f32 without I2F: __byte_perm makes the word 0x4B0000vv, the f32
//     2^23 + v exactly, and subtracting 2^23 leaves v exactly, on the f32
//     pipe.  The byte selector of the perm also reverses a flipped piece.
//   * One block a frame (B * T blocks), as the hardware schedules them.
//     Measured in ablation builds against one wave of blocks from the
//     occupancy query, each walking frames blockIdx.x, + gridDim.x, ...:
//     4-5% faster in both dtypes (the f32 vector body's 67 registers hold
//     3 blocks an SM, and a wave spreads 7,200 frames unevenly).  Slower,
//     too: half the pieces a round (1%), blocks of 128 threads (1-2%) or
//     512 (29-47%), registers capped at 64 for 4 blocks an SM (2-8%),
//     streaming stores (st.global.cs, 0-1%).
// The normalization is __fmul_rn then __fsub_rn: two roundings, never
// contracted into one FMA, as the plain version computes it, so the kernel
// is bit-exact against it; pairs go to bf16 by __floats2bfloat162_rn (round
// to nearest even, as the plain version's cast).
//
// Routes.  The vector route (EPV = 16 bytes / sizeof(T)) needs the crop a
// whole number of pieces (crop % EPV == 0), the source rows whole words
// (W % EPV == 0), and both pointers 16-byte aligned; otherwise the scalar
// route, the same kernel with EPV = 1 (a one-byte load and one store an
// output).  ops/ingest.py::route mirrors the choice.
//
// Plans are clamped into the frame (the plans of make_train_plans always
// are), so the kernel never reads outside the clip: a piece's last byte is
// at column <= ox + crop - 1 <= W - 1, and its second word ends at or before
// the row's end since W is a whole number of words.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPieceBytes = 16;

// v in 0..255, the byte `sel` of `word`, as an exact f32 without I2F
__device__ __forceinline__ float byte_as_f32(uint32_t word, uint32_t sel) {
  return __fsub_rn(__int_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | sel)), 8388608.0f);
}

__device__ __forceinline__ float normalize(float v, float inv_std, float shift) {
  return __fsub_rn(__fmul_rn(v, inv_std), shift);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The source of one piece: EPV bytes of a row from byte s on (in reverse
// order when flipped).  Vector route: the two aligned words of EPV bytes
// that hold them; scalar route: the byte.
template <int EPV>
struct Source;

template <>
struct Source<8> {  // bf16: 8 bytes in two aligned 8-byte words
  uint2 w0, w1;
  int s;
  __device__ __forceinline__ void load(const uint8_t* row, int at) {
    const uint2* words = reinterpret_cast<const uint2*>(row);
    s = at;
    w0 = __ldg(words + (at >> 3));
    w1 = __ldg(words + ((at + 7) >> 3));
  }
  // (lo, hi): the 8 bytes in source order, lo bytes 0-3
  __device__ __forceinline__ void bytes(uint32_t& lo, uint32_t& hi) const {
    const bool upper = (s & 4) != 0;
    const uint32_t a = upper ? w0.y : w0.x;
    const uint32_t b = upper ? w1.x : w0.y;
    const uint32_t c = upper ? w1.y : w1.x;
    const uint32_t sh = 8u * (s & 3);
    lo = __funnelshift_r(a, b, sh);
    hi = __funnelshift_r(b, c, sh);
  }
};

template <>
struct Source<4> {  // f32: 4 bytes in two aligned 4-byte words
  uint32_t w0, w1;
  int s;
  __device__ __forceinline__ void load(const uint8_t* row, int at) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
    s = at;
    w0 = __ldg(words + (at >> 2));
    w1 = __ldg(words + ((at + 3) >> 2));
  }
  __device__ __forceinline__ uint32_t bytes() const {
    return __funnelshift_r(w0, w1, 8u * (s & 3));
  }
};

template <>
struct Source<1> {  // the scalar route: one byte
  uint32_t v;
  __device__ __forceinline__ void load(const uint8_t* row, int at) { v = __ldg(row + at); }
};

// Convert one piece and store it at o.  rev (0 or 3) reverses a flipped
// piece's bytes: output e takes source byte e ^ rev of its word.
template <typename T, int EPV>
__device__ __forceinline__ void store_piece(T* o, const Source<EPV>& src, uint32_t rev,
                                            float inv_std, float shift) {
  if constexpr (EPV == 8) {
    uint32_t lo, hi;
    src.bytes(lo, hi);
    const uint32_t first = rev ? hi : lo;  // outputs 0-3
    const uint32_t second = rev ? lo : hi;  // outputs 4-7
    float f[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = normalize(byte_as_f32(first, e ^ rev), inv_std, shift);
      f[e + 4] = normalize(byte_as_f32(second, e ^ rev), inv_std, shift);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                              pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  } else if constexpr (EPV == 4) {
    const uint32_t w = src.bytes();
    float4 f;
    f.x = normalize(byte_as_f32(w, 0 ^ rev), inv_std, shift);
    f.y = normalize(byte_as_f32(w, 1 ^ rev), inv_std, shift);
    f.z = normalize(byte_as_f32(w, 2 ^ rev), inv_std, shift);
    f.w = normalize(byte_as_f32(w, 3 ^ rev), inv_std, shift);
    *reinterpret_cast<float4*>(o) = f;
  } else {
    *o = sbl::from_f32<T>(normalize(byte_as_f32(src.v, 0), inv_std, shift));
  }
}

template <typename T, int EPV>
__device__ __forceinline__ void store_zero(T* o) {
  if constexpr (EPV == 1) {
    *o = sbl::from_f32<T>(0.0f);
  } else {
    *reinterpret_cast<uint4*>(o) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the next piece of this thread, kThreads pieces on: dr rows and dc pieces
__device__ __forceinline__ void step(int& r, int& c, int dr, int dc, int ppr) {
  c += dc;
  r += dr;
  if (c >= ppr) {
    c -= ppr;
    ++r;
  }
}

// Output frame blockIdx.x in pieces of EPV outputs (EPV = 1: the scalar
// route); U pieces' loads are issued before any is converted.  ppr = crop /
// EPV pieces a row.
template <typename T, int EPV, int U>
__global__ void __launch_bounds__(kThreads)
    ingest_train_kernel(const uint8_t* __restrict__ clips, const int* __restrict__ offsets,
                        const uint8_t* __restrict__ flip, const int* __restrict__ frame_map,
                        const int* __restrict__ n_frames, T* __restrict__ out, int T_, int H,
                        int W, int crop, int ppr, float inv_std, float shift) {
  const int bt = blockIdx.x;
  const int b = bt / T_;
  const int t = bt - b * T_;
  const int dr = kThreads / ppr;
  const int dc = kThreads - dr * ppr;
  int r = threadIdx.x / ppr;
  int c = threadIdx.x - r * ppr;
  T* o = out + (long long)bt * crop * crop;
  if (n_frames != nullptr && t >= __ldg(n_frames + b)) {
    for (; r < crop; step(r, c, dr, dc, ppr)) store_zero<T, EPV>(o + r * crop + c * EPV);
    return;
  }
  const int src = min(max(__ldg(frame_map + bt), 0), T_ - 1);
  const int oy = min(max(__ldg(offsets + 2 * bt), 0), H - crop);
  const int ox = min(max(__ldg(offsets + 2 * bt + 1), 0), W - crop);
  const bool fl = __ldg(flip + b) != 0;
  const uint8_t* frame = clips + ((long long)(b * T_ + src) * H + oy) * W;
  // piece c's first source byte: ox + c * EPV, or ox + crop - EPV - c * EPV
  const int s0 = fl ? ox + crop - EPV : ox;
  const int ds = fl ? -EPV : EPV;
  const uint32_t rev = fl ? 3u : 0u;  // unused on the scalar route
  while (r < crop) {
    Source<EPV> src_bytes[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      at[u] = r < crop ? r * crop + c * EPV : -1;
      if (at[u] >= 0) src_bytes[u].load(frame + r * W, s0 + ds * c);
      step(r, c, dr, dc, ppr);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (at[u] >= 0) store_piece<T, EPV>(o + at[u], src_bytes[u], rev, inv_std, shift);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % kPieceBytes) == 0; }

template <typename T, int EPV, int U>
int launch(const uint8_t* clips, const int* offsets, const uint8_t* flip, const int* frame_map,
           const int* n_frames, T* out, int B, int T_, int H, int W, int crop, float inv_std,
           float shift, cudaStream_t s) {
  ingest_train_kernel<T, EPV, U><<<(unsigned)(B * T_), kThreads, 0, s>>>(
      clips, offsets, flip, frame_map, n_frames, out, T_, H, W, crop, crop / EPV, inv_std, shift);
  return (int)cudaGetLastError();
}

// The vector route's piece width for T, or the scalar route (1): see the
// note above; ops/ingest.py::route mirrors it.
template <typename T>
int route(const void* clips, const void* out, int W, int crop) {
  constexpr int epv = kPieceBytes / (int)sizeof(T);
  return crop % epv == 0 && W % epv == 0 && aligned16(clips) && aligned16(out) ? epv : 1;
}

template <typename T>
int dispatch(const void* clips, const void* offsets, const void* flip, const void* frame_map,
             const void* n_frames, void* out, int B, int T_, int H, int W, int crop,
             float inv_std, float shift, cudaStream_t s) {
  const uint8_t* c = static_cast<const uint8_t*>(clips);
  const int* off = static_cast<const int*>(offsets);
  const uint8_t* fl = static_cast<const uint8_t*>(flip);
  const int* fm = static_cast<const int*>(frame_map);
  const int* nf = static_cast<const int*>(n_frames);
  T* o = static_cast<T*>(out);
  constexpr int epv = kPieceBytes / (int)sizeof(T);
  if (route<T>(clips, out, W, crop) == epv) {
    return launch<T, epv, 32 / epv>(c, off, fl, fm, nf, o, B, T_, H, W, crop, inv_std, shift,
                                    s);
  }
  return launch<T, 1, 8>(c, off, fl, fm, nf, o, B, T_, H, W, crop, inv_std, shift, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(clips, offsets, flip, frame_map, n_frames, out, B, T, H, W, crop,
                           inv_std, shift, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(clips, offsets, flip, frame_map, n_frames, out, B, T, H, W,
                                   crop, inv_std, shift, s);
  }
  return (int)cudaErrorInvalidValue;
}
