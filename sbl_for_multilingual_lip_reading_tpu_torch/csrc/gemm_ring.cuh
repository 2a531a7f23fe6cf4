// The tensor-core GEMM mainloop of the bf16 routes of the fused decoder
// layer (decoder_layer.cu, K11) and the fused ResNet block (resblock.cu,
// K10), for Hopper (sm_90a):
//
//   C[m][n] = sum_k A(m, k) * W[n][k]      m < M, n < N, k < K
//
// W is a weight matrix in device memory whose rows are the output columns
// (the port's Dense weights (out, in); a conv weight re-laid as (out, ky,
// kx, in)).  Its k slices stream through a ring of kRingStages shared-memory
// stages, each BN rows x kRingBK k, brought by TMA (cp.async.bulk.tensor:
// one thread issues a stage's 64-row boxes, which complete on the stage's
// mbarrier) kRingStages - 1 steps ahead of the step that multiplies, so the
// L2 latency of the weights runs under the tensor-core work of the steps
// before and the copies take no issue slots of the warps.  A stage holds W
// as rows of 128 bytes with the 128-byte swizzle, the K-major layout a
// wgmma shared-memory descriptor names.  (A W whose rows TMA cannot map, a
// row stride that is not a multiple of 16 bytes, goes through registers
// into the same layout; a failed map of one it can map fails the launch.)
// A caller may start a product's first stages (ring_start) before work
// that leaves the ring alone.
//
// The products are warpgroup MMAs (wgmma.mma_async m64n64k16, f32
// accumulators in registers): the block's two warpgroups split the rows
// (WGM = 2) or the stage's columns (WGM = 1); a warpgroup holds MB 64 x 64
// tiles.  B is read from the stage through its descriptor.  A stays in
// shared memory for the whole product and goes to registers by ldmatrix,
// one address per row: a row-major activation tile (K11) or an implicit
// im2col patch whose row addresses carry the tap offsets and point at a
// zero row for taps outside the plane (K10), so A is never copied; a
// shared-memory descriptor could not express that gather, registers can.
// A step's wgmma run in groups of k16 steps; a group's A registers load
// while the group before multiplies, and a step's last group runs on while
// the block passes the barrier that frees the stage before it for the next
// load.  No branch surrounds a wgmma (a divergent path would serialise
// them).  The epilogue is applied to the accumulators in registers: no f32
// round trip through shared memory.  Rows past a pass (WGM * MB * 64) take
// further passes over the ring, N past BN further column tiles, all as one
// flat sequence of stages, so the pipeline does not drain between them.
//
// Every thread of the block calls gemm_ring with the same arguments; it
// synchronises the block, and ends with a barrier after which the ring may
// be reused.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace sbl {

constexpr int kRingThreads = 256;         // 8 warps: two warpgroups
constexpr int kRingBK = 64;               // k of one stage
constexpr int kRingStages = 3;
constexpr int kWgN = 64;                  // columns of one wgmma
constexpr int kTmaRows = 64;              // rows of W a TMA copy brings

// bytes of a ring whose stages hold BN rows of W: its barriers, then the
// stages from the next multiple of the 1024 bytes of the 128-byte swizzle's
// pattern
__host__ __device__ constexpr long long ring_bytes(int BN) {
  return (long long)kRingStages * BN * kRingBK * 2 + 2048;
}

// Whether TMA can map a row-major bf16 matrix at base with a row stride of
// ld elements: base and the stride multiples of 16 bytes.
inline bool weight_map_fits(const void* base, long long ld) {
  return (ld * 2) % 16 == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// A 2D TMA map of a row-major bf16 matrix (rows x cols, row stride ld
// elements; weight_map_fits) in kTmaRows x kRingBK boxes, stored 128-byte
// swizzled: what gemm_ring's stages hold.  Built on the host through the
// driver's entry point (no link to the driver library).  Returns the error
// where the entry point is missing or the driver refuses the map: the
// caller fails the launch rather than take the register path.
inline cudaError_t make_weight_map(CUtensorMap* map, const void* base, long long rows,
                                   long long cols, long long ld) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * 2)};
  const cuuint32_t box[2] = {(cuuint32_t)kRingBK, (cuuint32_t)kTmaRows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// this thread's arrival, announcing `bytes` of asynchronous copies to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a kTmaRows x kRingBK box of the map at (column c0, row c1) into shared
// memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void zero16(bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// 8 elements of src (those with e < valid, zero past them) as one 16-byte
// shared-memory store: the path for rows that are not 16-byte aligned
__device__ __forceinline__ void copy8_scalar(bf16* dst, const bf16* src, int valid) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned short lo = 2 * e < valid ? __bfloat16_as_ushort(src[2 * e]) : 0;
    const unsigned short hi = 2 * e + 1 < valid ? __bfloat16_as_ushort(src[2 * e + 1]) : 0;
    w[e] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A wgmma shared-memory descriptor of a K-major operand stored as rows of
// 128 bytes (64 bf16 of k) with the 128-byte swizzle, 8-row groups 1024
// bytes apart: the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B.  p is
// the first row's k offset (the swizzle is applied to the address bits).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (this warp's 16 rows of a 64 x 64 f32 warpgroup tile, the accumulator
// layout of mma.m16n8k16 per 8 columns) = A (64 x 16 bf16; this warp's 16
// rows in registers, the mma.m16n8k16 A layout) * B (16 x 64 through desc)
// + D where accumulate, else + 0.  Issued by the four warps of a
// warpgroup; completes asynchronously.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Keeps the compiler from moving code that touches the accumulators across
// the asynchronous wgmma (which would serialise them).
template <int MB>
__device__ __forceinline__ void fence_accumulators(float (&acc)[MB][8][4]) {
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[b][j][e])::"memory");
}

// The epilogue: row(m) and col(n) give handles (computed once per row and
// per column of a warp's tile), put(row, col, v) takes the f32 result.
template <class RowF, class ColF, class PutF>
struct Epilogue {
  RowF row;
  ColF col;
  PutF put;
};

template <class RowF, class ColF, class PutF>
__device__ __forceinline__ Epilogue<RowF, ColF, PutF> make_epilogue(RowF r, ColF c, PutF p) {
  return {r, c, p};
}

// The ring in a region of ring_bytes(BN): its stages' barriers (stage s
// has landed) at the start, the stages from the next multiple of 1024.
struct Ring {
  uint64_t* bars;
  bf16* st;
  __device__ __forceinline__ explicit Ring(void* raw)
      : bars(static_cast<uint64_t*>(raw)),
        st(reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + 64 + 1023) &
                                   ~static_cast<uintptr_t>(1023))) {}
};

// Fills ring stage `stage` with rows n0 .. n0 + BN - 1, k0 .. k0 + kRingBK
// - 1 of W: by TMA (thread 0 arms the stage's barrier with the bytes of its
// boxes and issues them), or, for a W that TMA cannot map, by the threads
// through registers (16 bytes a row chunk, stored in the same swizzled
// places), the barrier armed with no bytes.
template <int BN, class WSrc>
__device__ __forceinline__ void ring_fill(const Ring& r, const WSrc& w, int stage, int n0, int k0) {
  constexpr int kStage = BN * kRingBK;
  bf16* st = r.st + stage * kStage;
  uint64_t* bar = &r.bars[stage];
  if (w.map != nullptr) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, (unsigned)(kStage * 2));
#pragma unroll
      for (int bx = 0; bx < BN / kTmaRows; ++bx)
        tma_load_2d(st + bx * kTmaRows * kRingBK, w.map, w.map_col + k0,
                    w.map_row + n0 + bx * kTmaRows, bar);
    }
  } else {
    for (int c = threadIdx.x; c < BN * (kRingBK / 8); c += kRingThreads) {
      const int rr = c / (kRingBK / 8);
      const int ch = c % (kRingBK / 8);
      w.fetch8(st + rr * kRingBK + ((ch ^ (rr & 7)) * 8), w.row(n0 + rr), k0 + ch * 8);
    }
    // the stores (generic proxy) before the wgmma reads (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) mbar_arrive_expect_tx(bar, 0u);
  }
}

// Fills stage i of the flat sequence of (column tile, k step) of a product
// with nk k steps and ntiles column tiles.
template <int BN, class WSrc>
__device__ __forceinline__ void ring_load(const Ring& r, const WSrc& w, int nk, int ntiles, int i) {
  ring_fill<BN>(r, w, i % kRingStages, ((i / nk) % ntiles) * BN, (i % nk) * kRingBK);
}

// Starts a product of M rows, N columns of K (passes of kRowsPerPass
// rows) on the ring in raw: (re)initialises its barriers and issues its
// first kRingStages - 1 stages.  A caller may start the next product this
// way before work that does not touch the ring, so that its first stages
// arrive meanwhile (gemm_ring(..., true)).  Every thread of the block calls
// it.
template <int BN, int kRowsPerPass, class WSrc>
__device__ void ring_start(void* raw, const WSrc& w, int M, int N, int K) {
  const Ring r(raw);
  const int nk = (((K + 15) & ~15) + kRingBK - 1) / kRingBK;
  const int ntiles = (N + BN - 1) / BN;
  const int total = (M + kRowsPerPass - 1) / kRowsPerPass * ntiles * nk;
  __syncthreads();  // the region's last users are done
  if (threadIdx.x == 0) {
    if (w.map != nullptr)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(w.map))
                   : "memory");
#pragma unroll
    for (int s = 0; s < kRingStages; ++s) mbar_init(&r.bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the region's last writes may have been generic (another use of it)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s)
    if (s < total) ring_load<BN>(r, w, nk, ntiles, s);
  if (w.map == nullptr) __syncthreads();  // the register path's stores are in place
}

// ASrc: row(m) gives a lane's row handle (m may be >= M: the handle must
// then address finite values), kcol(k) a lane's column handle for the 8
// elements from k (a multiple of 8, < K rounded up to 16), addr(row, kcol)
// their shared-memory address (16-byte aligned).
// WSrc: N rows of K elements.  Where map is given, row n, element k of W
// is at (column map_col + k, row map_row + n) of the TMA map, and elements
// past K of a row may be anything (A is zero there); else row(n) gives
// row n (null where n >= N) and fetch8(dst, row, k) puts its elements k ..
// k + 7 at dst, zero past K.
// WGM: warpgroups along the rows (2) or the columns (1); MB: 64-row tiles a
// warpgroup holds, so that a pass covers WGM * MB * 64 rows and a stage
// (2 / WGM) * 64 columns.  Every tile of a pass is multiplied, rows past M
// too.  started: the caller has run ring_start for this product.
template <int WGM, int MB, class ASrc, class WSrc, class Epi>
__device__ void gemm_ring(const ASrc& a, const WSrc& w, int M, int N, int K, void* raw,
                          const Epi& epi, bool started = false) {
  constexpr int WGN = 2 / WGM;
  constexpr int BN = WGN * kWgN;
  constexpr int kStage = BN * kRingBK;     // elements: BN rows of 128 bytes
  constexpr int kRowsPerPass = WGM * MB * 64;
  // k16 steps per wgmma group: an even number of groups a step, so that the
  // two A register buffers alternate across steps too
  constexpr int KG = MB <= 2 ? 2 : 1;
  static_assert((kRingBK / 16 / KG) % 2 == 0, "groups in pairs");
  static_assert(WGM == 1 || WGM == 2, "two warpgroups");
  const Ring ring(raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int wgm = wg % WGM;
  const int wgn = wg / WGM;
  const int wq = warp & 3;  // the warp's 16 rows of each 64-row tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int K16 = (K + 15) & ~15;
  const int nk = (K16 + kRingBK - 1) / kRingBK;
  const int ntiles = (N + BN - 1) / BN;
  const int mpasses = (M + kRowsPerPass - 1) / kRowsPerPass;

  // the first wgmma of a column tile starts the sum (accumulate = 0), so
  // nothing else writes the accumulators
  float acc[MB][8][4];
  typename ASrc::Row rows[MB];

  if (!started) ring_start<BN, kRowsPerPass>(raw, w, M, N, K);
  // The steps walk (pass, column tile, k step) with counters, not divisions
  // (a step's own work is a few instructions a thread): the stage a step
  // reads and its barrier's parity; and the step kRingStages - 1 ahead that
  // the step loads, its stage (the one the step before read), column tile
  // and k step, while loads remain.
  int stage = 0;
  unsigned parity = 0;
  int loads = mpasses * ntiles * nk - (kRingStages - 1);
  int ld_k = (kRingStages - 1) % nk;
  int ld_t = ((kRingStages - 1) / nk) % ntiles;
  uint32_t af[2][KG][MB][4];
  for (int pass = 0; pass < mpasses; ++pass) {
    const int wg_row0 = pass * kRowsPerPass + wgm * MB * 64;
    for (int nt = 0; nt < ntiles; ++nt) {
      const int ncol0 = nt * BN + wgn * kWgN;  // this warpgroup's first column
#pragma unroll
      for (int b = 0; b < MB; ++b) rows[b] = a.row(wg_row0 + b * 64 + wq * 16 + (lane & 15));
      for (int kstep = 0; kstep < nk; ++kstep) {
        mbar_wait(&ring.bars[stage], parity);
        const bf16* st = ring.st + stage * kStage + wgn * kWgN * kRingBK;
        const uint64_t desc0 = smem_desc_sw128(st);
        // groups of KG k16 steps: a group's A registers load while the group
        // before it multiplies.  No branch around the wgmma (a divergent path
        // would serialise them): a warpgroup past N or M multiplies padding,
        // and a k16 step past K multiplies a zero A.
#pragma unroll
        for (int kg = 0; kg < kRingBK / 16; kg += KG) {
          const int buf = (kg / KG) & 1;
#pragma unroll
          for (int q = 0; q < KG; ++q) {
            const int k = kstep * kRingBK + (kg + q) * 16;
            const uint32_t keep = k < K16 ? ~0u : 0u;
            const auto kcl = a.kcol(min(k, K16 - 16) + (lane >> 4) * 8);
#pragma unroll
            for (int b = 0; b < MB; ++b) {
              ldmatrix_x4(af[buf][q][b], a.addr(rows[b], kcl));
#pragma unroll
              for (int e = 0; e < 4; ++e) af[buf][q][b][e] &= keep;
            }
          }
          wgmma_fence();
          fence_accumulators<MB>(acc);
#pragma unroll
          for (int q = 0; q < KG; ++q) {
            const int kk = kg + q;
            // the descriptor's address field counts 16 bytes: a k16 step is 32
            const uint64_t desc = desc0 + (uint64_t)(2 * kk);
            const int accumulate = kstep > 0 || kk > 0;
#pragma unroll
            for (int b = 0; b < MB; ++b) wgmma_m64n64k16(acc[b], af[buf][q][b], desc, accumulate);
          }
          wgmma_commit();
          // every group but this one is done: the other A buffer is free, and
          // after the first group of a step, the whole of the step before
          wgmma_wait<1>();
        }
        // everyone is done with the step before, whose stage the next load
        // refills while this step's last group multiplies
        __syncthreads();
        if (loads > 0) {
          ring_fill<BN>(ring, w, stage == 0 ? kRingStages - 1 : stage - 1, ld_t * BN,
                        ld_k * kRingBK);
          --loads;
          if (++ld_k == nk) {
            ld_k = 0;
            if (++ld_t == ntiles) ld_t = 0;
          }
        }
        if (++stage == kRingStages) {
          stage = 0;
          parity ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_accumulators<MB>(acc);
      // the epilogue on the accumulators in registers: lane (g, t) holds
      // rows g and g + 8 of its warp's 16, columns 2t and 2t + 1 of each 8
      using ColH = decltype(epi.col(0));
      ColH chs[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) chs[j][c] = epi.col(min(ncol0 + j * 8 + 2 * t + c, N - 1));
#pragma unroll
      for (int b = 0; b < MB; ++b) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wg_row0 + b * 64 + wq * 16 + g + 8 * h;
          if (m < M) {
            const auto rh = epi.row(m);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (ncol0 + j * 8 + 2 * t + c < N) epi.put(rh, chs[j][c], acc[b][j][2 * h + c]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// A as rows of a row-major bf16 tile in shared memory; rows past `last`
// read row `last` (their results are not stored).
struct SmemRows {
  const bf16* p;
  int ld;
  int last;
  using Row = const bf16*;
  __device__ __forceinline__ Row row(int m) const { return p + (long long)min(m, last) * ld; }
  __device__ __forceinline__ int kcol(int k) const { return k; }
  __device__ __forceinline__ const bf16* addr(Row r, int k) const { return r + k; }
};

}  // namespace sbl
