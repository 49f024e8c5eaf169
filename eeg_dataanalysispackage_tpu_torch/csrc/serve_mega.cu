// The serve megakernel for Hopper (sm_90a): a micro-batch of windows laid
// out at a regular stride -> one linear margin per window, with the
// features kept in shared memory and never written to device memory. The
// samples are int16 (INT_16 recordings, scaled by their resolutions on the
// card) or float32 (other formats, staged already scaled with unit
// resolutions): every instantiation below exists for both (template
// argument Sample, as in ingest_features.cu; the float32 ones are named
// K5-f32s, K5-int8-f32s, K5-int4-f32s, K6-f32s, K6-w8-f32s and K6-w4-f32s).
//
// Replaces the TPU kernel eeg_dataanalysispackage_tpu/ops/serve_mega.py:259
// (_make_mega_kernel, launched by _mega_program at :329, pallas_call :467),
// at precision "f32", "int8" and "int4" (its masked quantize at :312-315).
// The Pallas kernel views the stream as rows of 128 lanes so that every
// window cut is a static, tile-aligned slice, and takes the margin as an
// MXU product against the weights padded to a (48, 128) matrix. Neither
// constraint exists here: window i starts at i * stride, and the margin is
// a 48-term dot in a fixed order.
//
// Per window i < capacity (one block computes it wholly, so its margin is
// bit-identical whatever batch or grid it rides in):
//   y      = window_features.cuh's C*16 coefficients of the window at
//            i * stride (the same engine and instructions as the fused
//            ingest kernel, so the features equal that kernel's bit for bit)
//   f      = y / max(||y||, 1e-30)
//   f      = quantize_feature(f)     (the int8 and int4 instantiations only:
//            window_features.cuh's quantize step, the one the fused ingest
//            kernel's int8/int4 epilogue runs)
//   out[i] = sum_k f_k * weights_k   (warp 0: lane l sums k = l, l + 32, ...
//            by FMAs, then a butterfly; fixed order, no atomics), before the
//            intercept.
// An all-zero (padded) window gives exactly 0.0. bf16 has no megakernel:
// its rung differs in the contraction's operands, not in the finished row.
//
// Bound on the H100: bytes. Per window at C = 3 the function reads C*612
// int16 samples (baseline and analysis segments) and writes one float:
// about 3.7 KB, against 2*C*512*16 + 2*48 = 49 kFLOP. At 32,768 windows
// that is 120.5 MB, 0.036 ms at 3.35 TB/s, against 0.024 ms for 1.61
// GFLOP at 67 TFLOP/s (f32, no tensor cores). Float32 samples double the
// bytes read (about 7.3 KB a window, 0.072 ms at 32,768 windows). At one
// serve batch (64 windows) the bound is under 0.2 us and one window's
// chain sets the time.
//
// K6, the tenant-stacked instantiation (kMulti, f32 only), replaces the TPU
// kernel eeg_dataanalysispackage_tpu/ops/serve_mega.py:484
// (_mega_multi_program, pallas_call :645, built at serve/multiplex.py:864):
// the same kernel, with the weights of row i at stack + lanes[i] * C*16 of a
// tenant-major (128, C*16) stack instead of one vector. The Pallas kernel
// takes the whole (tile_b, 128) margin matrix in one MXU dot and picks each
// row's tenant column outside the kernel (a dynamic lane slice does not
// compile in Mosaic); here the pick is one pointer offset inside the kernel,
// so no 128-column product is computed, and the 48-term dot keeps K5's
// fixed order: a tenant's margin is bit-identical to K5 run with that
// tenant's weights. Bound: K5's bytes plus 4 B of lane per window (at
// 32,768 windows ~120.6 MB, 0.036 ms at 3.35 TB/s); the stack (24 KB) is
// read from L2.
//
// K6-w8 and K6-w4, the quantized tenant stack (weights_precision int8 and
// int4, serve/multiplex.py): the same kernel with template argument Wt,
// reading row lanes[i] of the packed stack, (128, C*16) int8 levels or
// (128, C*8) uint8 nibble pairs, and that lane's float32 scale. The
// reference dequantizes the whole stack in XLA before its f32 kernel
// (ops/serve_mega.py:562-578, wrap_quantized); here each term is
// dequantized where it is used (packed_term: the exact level, then one
// float32 multiply), in K6's order, so a margin equals K6's on the
// dequantized f32 stack bit for bit. The resident stack is 6,144 or 3,072
// bytes plus 512 of scales against the f32 stack's 24,576. Bound: K6's.
//
// Every other window and coefficient count (all instantiations above)
// runs serve_mega_any_kernel, the generic engine of window_features_any.cuh
// in the design its plan picks (the warp-specialised ring design, or the
// phase-by-phase one for tiles of few outputs; its notes give both designs
// and their bounds): the warp that finishes a window dots its row in the
// ring epilogue's lane order.
//
// Design at 512 / 16: two, picked per launch on float32 samples
// (ops/serve_mega_cuda.py mega_design, a pure function of the capacity,
// the channels and the card, passed to the launchers as `design`; int16
// samples always run the first). The margins are the same bit for bit in
// both: the tile design computes run_windows' partials and runs the same
// reduce_and_norm and MegaMargins::epilogue on them.
//
// run_windows (window_features.cuh; int16 samples, and float32 launches
// below the crossover): a persistent wave of blocks, each keeping its next
// window's samples in flight as 16-byte cp.async chunks while it computes
// one (every window starts on a 16-byte boundary, stride 896 x 2 B or x 4
// B, and its analysis segment 3 samples into a chunk of 8 int16 or 4 float
// samples); warp 0's epilogue, the norm and the dot, overlaps warps 1..7's
// means and staging of the next window, and for the int8/int4 rungs, with
// the quantize step, their centre as well. K6's warp 0 loads the row's
// lane, then its weights, before the reduce and the norm, so both loads
// overlap them. What bounds it (PERF.md section 6): each block's chain of
// dependent steps a window, of which four blocks a multiprocessor run at
// once: about 36% of the bound at 32,768 float32 windows (0.196-0.212 ms),
// while one serve batch is one window's chain (0.0042-0.0048 ms at 64).
//
// The tile design (window_tiles.cuh run_tiles_f32s, serve_mega_kernel_tiles:
// float32 samples from the crossover, 8 windows a multiprocessor, 1,056 on
// the H100): one persistent block of 736 threads a multiprocessor walks
// tiles of 4 windows through a ring of TMA-fed stages, warp roles handing
// work on through mbarriers (staging, centring, contraction, two epilogue
// warps a window), the weights or the tenant stack resident in shared
// memory (TileMargins below). Its notes give the roles. What bounds it
// (PERF.md section 6, chip_tiles.py): the staging alone streams the
// launch's bytes at 0.094-0.096 ms for 32,768 windows (2.5 TB/s); the
// centring and the contraction sharing the multiprocessor with it take the
// launch to 0.122-0.132 ms (55-58% of the bound, 1.25-1.33x the library
// call's SGEMM).
// Below about 1,024 windows a launch is a handful of tiles a
// multiprocessor and the ring's fixed start-up (W, the first stage's
// copies and centring) is not hidden: there run_windows is faster.
//
// The one-window-per-block kernel before run_windows staged 2 bytes a
// thread at a time and ran seven barriers a window; it reached 10% of the
// bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_features.cuh"
#include "window_features_any.cuh"
#include "window_tiles.cuh"

namespace {

using namespace window_features;

// The tenant stack's resident precision (serve/multiplex.py
// weights_precision; the launcher's code, as ops/decode_ingest.PRECISIONS
// numbers the rungs): f32 weights, or int8 levels / int4 nibbles with one
// float32 scale a lane.
enum class Weights : int { kF32 = 0, kInt8 = 2, kInt4 = 3 };

// Term i of a packed stack row: float(q_i) * scale for int8, or
// (float(nibble) - 8) * scale for int4 (element 2j in the low nibble of
// byte j, 2j + 1 in the high one): the exact small integer, then one
// float32 multiply, never contracted into the margin's FMA, so the term
// equals the dequantized f32 stack's element (ops/quant.py
// dequantize_weight_stack) bit for bit.
template <Weights Wt>
__device__ __forceinline__ float packed_term(const uint8_t* __restrict__ row, float scale,
                                             int i) {
  if constexpr (Wt == Weights::kInt8) {
    return __fmul_rn(static_cast<float>(reinterpret_cast<const int8_t*>(row)[i]), scale);
  } else {
    const unsigned byte = row[i >> 1];
    const unsigned nibble = (i & 1) ? byte >> 4 : byte & 0xFu;
    return __fmul_rn(__fsub_rn(static_cast<float>(nibble), 8.0f), scale);
  }
}

// Bytes of one packed stack row of nfeat terms.
__host__ __device__ constexpr int packed_row_bytes(Weights wt, int nfeat) {
  return wt == Weights::kInt4 ? nfeat / 2 : nfeat;
}

// Margins of the megakernel: window `row` starts at row * stride and warp 0
// dots its row with `weights` (kMulti: with row lanes[row] of the
// tenant-major stack `weights`; K6). Wt: the stack's precision (K6-w8,
// K6-w4: `weights` holds the packed rows, `scales` each lane's scale).
template <Precision P, bool kMulti, Weights Wt>
struct MegaMargins {
  static_assert(Wt == Weights::kF32 || kMulti, "a packed stack is the tenant stack's");
  int stride;
  const float* __restrict__ weights;
  const int* __restrict__ lanes;
  float* __restrict__ out;
  int channels;
  const float* __restrict__ scales;

  // capacity * stride fits an int (the wrapper checks the stream length)
  __device__ __forceinline__ int start(int row) const { return row * stride; }
  __device__ __forceinline__ void epilogue(int row, const RingSmem& s, int lane) const {
    // the quantize step's addresses derive from the lane: opaque to the
    // compiler, they are computed here rather than held across the window
    // loop, where they do not fit 64 registers beside W's column
    if constexpr (quantized(P)) asm volatile("" : "+r"(lane));
    const int nfeat = channels * kFeatures;
    if constexpr (Wt != Weights::kF32) {
      // K6-w8/w4: the row's lane, its packed row and scale, loaded ahead
      // of the reduce and the norm; the terms in K6's order
      const int t = lanes[row];
      const uint8_t* prow = reinterpret_cast<const uint8_t*>(weights) +
                            static_cast<long long>(t) * packed_row_bytes(Wt, nfeat);
      const float scale = scales[t];
      const float w0 = lane < nfeat ? packed_term<Wt>(prow, scale, lane) : 0.0f;
      const float w1 = lane + 32 < nfeat ? packed_term<Wt>(prow, scale, lane + 32) : 0.0f;
      const float denom = reduce_and_norm(channels, s, lane);
      for (int i = lane; i < nfeat; i += 32) s.feat[i] = s.feat[i] / denom;
      float m = 0.0f;
      if (lane < nfeat) m = fmaf(s.feat[lane], w0, m);
      if (lane + 32 < nfeat) m = fmaf(s.feat[lane + 32], w1, m);
      for (int i = lane + 64; i < nfeat; i += 32) {
        m = fmaf(s.feat[i], packed_term<Wt>(prow, scale, i), m);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m += __shfl_xor_sync(0xffffffffu, m, off);
      if (lane == 0) out[row] = m;
      return;
    } else {
      // K6: the row's lane, then the first two terms' weights of its row of
      // the stack, loaded ahead of the reduce and the norm, whose time they
      // overlap
      const float* wrow = weights;
      if constexpr (kMulti) wrow += static_cast<long long>(lanes[row]) * nfeat;
      const float w0 = lane < nfeat ? wrow[lane] : 0.0f;
      const float w1 = lane + 32 < nfeat ? wrow[lane + 32] : 0.0f;
      const float denom = reduce_and_norm(channels, s, lane);
      float m = 0.0f;
      if constexpr (quantized(P)) {
        // two rounds of 32 elements at a time, their chains independent;
        // lane l's terms l, l + 32, ... in order
        for (int base = 0; base < nfeat; base += 64) {
          const int i0 = base + lane;
          const int i1 = i0 + 32;
          const float q0 = quantize_lane<P>(i0 < nfeat ? s.feat[i0] / denom : 0.0f, lane);
          const float q1 = quantize_lane<P>(i1 < nfeat ? s.feat[i1] / denom : 0.0f, lane);
          if (i0 < nfeat) m = fmaf(q0, base == 0 ? w0 : wrow[i0], m);
          if (i1 < nfeat) m = fmaf(q1, base == 0 ? w1 : wrow[i1], m);
        }
      } else {
        // the normalized row first, then the dot: fewer values live across
        // the divisions' slow-path calls
        for (int i = lane; i < nfeat; i += 32) s.feat[i] = s.feat[i] / denom;
        if (lane < nfeat) m = fmaf(s.feat[lane], w0, m);
        if (lane + 32 < nfeat) m = fmaf(s.feat[lane + 32], w1, m);
        for (int i = lane + 64; i < nfeat; i += 32) m = fmaf(s.feat[i], wrow[i], m);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m += __shfl_xor_sync(0xffffffffu, m, off);
      if (lane == 0) out[row] = m;
    }
  }

  // The generic engine's (any window and coefficient count): the calling
  // warp dots the finished row in the ring epilogue's order, lane l's
  // terms l, l + 32, ... by FMAs, then a butterfly.
  __device__ __forceinline__ void finish(int row, const float* y, int nfeat, int lane) const {
    float m = 0.0f;
    if constexpr (Wt == Weights::kF32) {
      const float* wrow = weights;
      if constexpr (kMulti) wrow += static_cast<long long>(lanes[row]) * nfeat;
      for (int i = lane; i < nfeat; i += 32) m = fmaf(y[i], wrow[i], m);
    } else {
      const int t = lanes[row];
      const uint8_t* prow = reinterpret_cast<const uint8_t*>(weights) +
                            static_cast<long long>(t) * packed_row_bytes(Wt, nfeat);
      const float scale = scales[t];
      for (int i = lane; i < nfeat; i += 32) m = fmaf(y[i], packed_term<Wt>(prow, scale, i), m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m += __shfl_xor_sync(0xffffffffu, m, off);
    if (lane == 0) out[row] = m;
  }
};

// kMulti: `weights` is the tenant-major (128, channels*16) stack and row i
// dots with its row lanes[i] (K6); otherwise `weights` is one vector and
// `lanes` is not read (K5). kWide: run_windows' wide instantiation. Wt:
// the stack's precision (K6-w8/w4 read packed rows and `scales`).
template <class Sample, Precision P, bool kMulti, bool kWide, Weights Wt>
__global__ void __launch_bounds__(kThreads, min_blocks_per_sm(kWide))
    serve_mega_kernel(const Sample* __restrict__ stream,
                      const float* __restrict__ res,
                      const float* __restrict__ w,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int capacity, int channels,
                      int stride, int pre, int skip,
                      const int* __restrict__ lanes, Ring ring, int n_samples,
                      const float* __restrict__ scales) {
  static_assert(!kMulti || P == Precision::kF32, "the tenant stack serves f32 rows");
  extern __shared__ __align__(16) float smem[];
  // n_samples = capacity * stride, a launch argument rather than a product
  // the loop would hold in a register
  const StreamView<Sample> v{stream, channels, n_samples};
  run_windows<Sample, P, kWide>(
      smem, v, res, w, capacity, pre, skip, ring,
      MegaMargins<P, kMulti, Wt>{stride, weights, lanes, out, channels, scales});
}

// Every size but the main path's 512 / 16: the generic engine, tiled as
// `plan` says in the design kDesign (window_features_any.cuh:
// run_tiles_ring, or the phase-by-phase run_tiles_any).
template <class Sample, Precision P, bool kMulti, Weights Wt, int kDesign>
__global__ void __launch_bounds__(design_threads<kDesign>(), design_min_blocks<kDesign>())
    serve_mega_any_kernel(const Sample* __restrict__ stream,
                          const float* __restrict__ res,
                          const float* __restrict__ w,
                          const float* __restrict__ weights,
                          float* __restrict__ out, int capacity, int channels,
                          int stride, int pre, int skip,
                          const int* __restrict__ lanes, int n_samples,
                          const float* __restrict__ scales, int epoch, int features,
                          DesignPlan<kDesign> plan) {
  static_assert(!kMulti || P == Precision::kF32, "the tenant stack serves f32 rows");
  extern __shared__ __align__(16) float smem[];
  const StreamView<Sample> v{stream, channels, n_samples};
  const MegaMargins<P, kMulti, Wt> margins{stride, weights, lanes, out, channels, scales};
  run_design<kDesign, Sample, P>(smem, v, res, w, capacity, pre, skip, epoch, features, plan,
                                 margins);
}

// The tenant stack's rows (serve/multiplex.py MAX_TENANTS).
constexpr int kMaxTenants = 128;

// The tile design's epilogue (window_tiles.cuh run_tiles_f32s): MegaMargins
// on copies in shared memory of the weights (K5), or of the tenant stack
// and, packed, its scales (K6), staged once a block, so no window's
// epilogue waits on device memory behind the stages' copies. K6 reads each
// window's lane a tile ahead (prefetch) and hands it to the epilogue
// through a shared slot of the warp, which `lanes` is rebased on: the
// epilogue's lanes[row] reads that slot. The arithmetic is
// MegaMargins::epilogue's own, so the margins are run_windows'.
template <Precision P, bool kMulti, Weights Wt>
struct TileMargins {
  MegaMargins<P, kMulti, Wt> global;

  // Bytes of the weights (K5: one row) or of the stack (K6), its scales
  // (K6-w8/w4), and one lane slot an epilogue warp, 16-byte aligned each.
  __host__ __device__ static int weights_bytes(int channels) {
    const int nfeat = channels * kFeatures;
    if constexpr (!kMulti) return nfeat * static_cast<int>(sizeof(float));
    if constexpr (Wt == Weights::kF32) return kMaxTenants * nfeat * static_cast<int>(sizeof(float));
    return kMaxTenants * packed_row_bytes(Wt, nfeat);
  }
  __host__ __device__ static int scales_bytes() {
    return Wt == Weights::kF32 ? 0 : kMaxTenants * static_cast<int>(sizeof(float));
  }
  __host__ __device__ static int align16(int bytes) { return (bytes + 15) & ~15; }
  __host__ __device__ static int resident_bytes(int channels) {
    return align16(weights_bytes(channels)) + align16(scales_bytes()) +
           tiles::kEpilogueWarps * static_cast<int>(sizeof(int));
  }

  // Thread t of `threads` copies its share (4-byte words: every size above
  // is a multiple of 4); the margins on the copies.
  __device__ __forceinline__ MegaMargins<P, kMulti, Wt> stage(char* dst, int t,
                                                              int threads) const {
    MegaMargins<P, kMulti, Wt> m = global;
    const int wb = weights_bytes(global.channels);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(global.weights);
    uint32_t* words = reinterpret_cast<uint32_t*>(dst);
    for (int i = t; i < wb / 4; i += threads) words[i] = src[i];
    m.weights = reinterpret_cast<const float*>(dst);
    if constexpr (Wt != Weights::kF32) {
      float* sc = reinterpret_cast<float*>(dst + align16(wb));
      for (int i = t; i < kMaxTenants; i += threads) sc[i] = global.scales[i];
      m.scales = sc;
    }
    return m;
  }

  __device__ __forceinline__ int prefetch(int row) const {
    if constexpr (kMulti) return global.lanes[row];
    return 0;
  }

  // Warp `slot`'s epilogue of `row`, its lane read ahead as `lane_of_row`.
  __device__ __forceinline__ void epilogue(const MegaMargins<P, kMulti, Wt>& staged, int row,
                                           const RingSmem& s, int lane, int slot,
                                           int lane_of_row) const {
    MegaMargins<P, kMulti, Wt> m = staged;
    if constexpr (kMulti) {
      int* slots = reinterpret_cast<int*>(const_cast<float*>(m.weights)) +
                   (align16(weights_bytes(global.channels)) + align16(scales_bytes())) / 4;
      if (lane == 0) slots[slot] = lane_of_row;
      __syncwarp();
      // lanes[row] is slots[slot]: the address arithmetic of a pointer
      // `row` ints below the slot, in integers
      m.lanes = reinterpret_cast<const int*>(reinterpret_cast<uintptr_t>(slots + slot) -
                                             static_cast<uintptr_t>(row) * sizeof(int));
    }
    m.epilogue(row, s, lane);
  }
};

// The float32-sample megakernel at 512 / 16 in the tile design
// (window_tiles.cuh run_tiles_f32s): the launch's stream through two tensor
// maps (the analysis samples' group boxes, the baseline's box).
template <Precision P, bool kMulti, Weights Wt>
__global__ void __launch_bounds__(tiles::kTileThreads, 1)
    serve_mega_kernel_tiles(const __grid_constant__ CUtensorMap seg_map,
                            const __grid_constant__ CUtensorMap base_map,
                            const float* __restrict__ res, const float* __restrict__ w,
                            const float* __restrict__ weights, float* __restrict__ out,
                            int capacity, int channels, int stride, int pre, int skip,
                            int stages, const int* __restrict__ lanes,
                            const float* __restrict__ scales) {
  static_assert(!kMulti || P == Precision::kF32, "the tenant stack serves f32 rows");
  extern __shared__ __align__(16) float smem[];
  const TileMargins<P, kMulti, Wt> win{
      MegaMargins<P, kMulti, Wt>{stride, weights, lanes, out, channels, scales}};
  tiles::run_tiles_f32s<P>(smem, &seg_map, &base_map, res, w, capacity, channels, pre, skip,
                           stages, win);
}

// The designs of the float32-sample megakernel at 512 / 16, the launchers'
// `design` argument (ops/serve_mega_cuda.py MEGA_DESIGNS): run_windows, or
// the tile design. Every other launch takes kRingMega.
constexpr int kRingMega = 0;
constexpr int kTileMega = 1;

// One launch's arguments.
struct Launch {
  const void* stream;
  const void* res;
  const void* w;
  const void* weights;
  const void* scales;
  const void* lanes;
  void* out;
  int capacity;
  int channels;
  int stride;
  int pre;
  int skip;
  int epoch;
  int features;
  const int* any_plan;  // the generic engine's tile plan (not read at 512 / 16)
  int design;           // kRingMega or kTileMega (float32 samples at 512 / 16 only)
  void* cuda_stream;
};

template <class Sample, Precision P, bool kMulti, bool kWide, Weights Wt>
int launch_ring(const Ring& ring, size_t smem, const Launch& a) {
  int grid = 0;
  const cudaError_t err =
      plan_grid(serve_mega_kernel<Sample, P, kMulti, kWide, Wt>, smem, a.capacity, &grid);
  if (err != cudaSuccess) return err;
  serve_mega_kernel<Sample, P, kMulti, kWide, Wt>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(a.cuda_stream)>>>(
          static_cast<const Sample*>(a.stream), static_cast<const float*>(a.res),
          static_cast<const float*>(a.w), static_cast<const float*>(a.weights),
          static_cast<float*>(a.out), a.capacity, a.channels, a.stride, a.pre, a.skip,
          static_cast<const int*>(a.lanes), ring, a.capacity * a.stride,
          static_cast<const float*>(a.scales));
  return cudaGetLastError();
}

// The tile design: refused (cudaErrorInvalidValue) outside its reach
// (tiles::plan_tiles) or where a tensor map does not encode.
template <Precision P, bool kMulti, Weights Wt>
int launch_tiles(const Launch& a) {
  int stages = 0;
  size_t smem = 0;
  cudaError_t err =
      tiles::plan_tiles(a.channels, a.pre, a.stride, a.stream,
                        TileMargins<P, kMulti, Wt>::resident_bytes(a.channels), &stages, &smem);
  if (err != cudaSuccess) return err;
  CUtensorMap seg_map, base_map;
  err = tiles::encode_map(&seg_map, a.stream, a.channels, a.capacity, a.stride,
                          tiles::kLineFloats);
  if (err != cudaSuccess) return err;
  err = tiles::encode_map(&base_map, a.stream, a.channels, a.capacity, a.stride, round4(a.pre));
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = plan_grid_threads(serve_mega_kernel_tiles<P, kMulti, Wt>, tiles::kTileThreads, smem,
                          (a.capacity + tiles::kWindows - 1) / tiles::kWindows, &grid);
  if (err != cudaSuccess) return err;
  serve_mega_kernel_tiles<P, kMulti, Wt>
      <<<grid, tiles::kTileThreads, smem, static_cast<cudaStream_t>(a.cuda_stream)>>>(
          seg_map, base_map, static_cast<const float*>(a.res), static_cast<const float*>(a.w),
          static_cast<const float*>(a.weights), static_cast<float*>(a.out), a.capacity,
          a.channels, a.stride, a.pre, a.skip, stages, static_cast<const int*>(a.lanes),
          static_cast<const float*>(a.scales));
  return cudaGetLastError();
}

template <class Sample, Precision P, bool kMulti, Weights Wt, int kDesign>
int launch_design(const Launch& a, const int* fields) {
  DesignPlan<kDesign> plan{};
  size_t smem = 0;
  const int checked =
      check_plan<kDesign, Sample>(fields, a.channels, a.epoch, a.features, a.pre, &plan, &smem);
  if (checked != cudaSuccess) return checked;
  int grid = 0;
  const cudaError_t err =
      plan_grid_threads(serve_mega_any_kernel<Sample, P, kMulti, Wt, kDesign>,
                        design_threads<kDesign>(), smem, (a.capacity + plan.m - 1) / plan.m,
                        &grid);
  if (err != cudaSuccess) return err;
  serve_mega_any_kernel<Sample, P, kMulti, Wt, kDesign>
      <<<grid, design_threads<kDesign>(), smem, static_cast<cudaStream_t>(a.cuda_stream)>>>(
          static_cast<const Sample*>(a.stream), static_cast<const float*>(a.res),
          static_cast<const float*>(a.w), static_cast<const float*>(a.weights),
          static_cast<float*>(a.out), a.capacity, a.channels, a.stride, a.pre, a.skip,
          static_cast<const int*>(a.lanes), a.capacity * a.stride,
          static_cast<const float*>(a.scales), a.epoch, a.features, plan);
  return cudaGetLastError();
}

// The generic engine in the design the plan's first field names (a missing
// plan, or one of no design, is refused by the phase-by-phase design's
// check after the reach).
template <class Sample, Precision P, bool kMulti, Weights Wt>
int launch_any(const Launch& a) {
  if (const int* ring = design_fields(a.any_plan, kRingDesign)) {
    return launch_design<Sample, P, kMulti, Wt, kRingDesign>(a, ring);
  }
  return launch_design<Sample, P, kMulti, Wt, kPhaseDesign>(
      a, design_fields(a.any_plan, kPhaseDesign));
}

template <class Sample, Precision P, bool kMulti = false, Weights Wt = Weights::kF32>
int launch(const Launch& a) {
  const bool main_size = a.epoch == kEpoch && a.features == kFeatures;
  if (a.design == kTileMega && main_size) {
    if constexpr (sizeof(Sample) == sizeof(float)) return launch_tiles<P, kMulti, Wt>(a);
  }
  if (a.design != kRingMega) return cudaErrorInvalidValue;
  if (!main_size) return launch_any<Sample, P, kMulti, Wt>(a);
  Ring ring{};
  size_t smem = 0;
  const cudaError_t err = plan_ring<Sample>(a.channels, a.pre, &ring, &smem);
  if (err != cudaSuccess) return err;
  if (wide_ring(ring, a.channels)) return launch_ring<Sample, P, kMulti, true, Wt>(ring, smem, a);
  return launch_ring<Sample, P, kMulti, false, Wt>(ring, smem, a);
}

// K5 at `precision` on Sample streams.
template <class Sample>
int launch_rung(int precision, const Launch& a) {
  switch (static_cast<Precision>(precision)) {
    case Precision::kF32:
      return launch<Sample, Precision::kF32>(a);
    case Precision::kInt8:
      return launch<Sample, Precision::kInt8>(a);
    case Precision::kInt4:
      return launch<Sample, Precision::kInt4>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// K6 on the stack at `weights_precision`, on Sample streams.
template <class Sample>
int launch_stack(int weights_precision, const Launch& a) {
  switch (static_cast<Weights>(weights_precision)) {
    case Weights::kF32:
      return launch<Sample, Precision::kF32, true, Weights::kF32>(a);
    case Weights::kInt8:
      return launch<Sample, Precision::kF32, true, Weights::kInt8>(a);
    case Weights::kInt4:
      if ((a.channels * a.features) % 2) return cudaErrorInvalidValue;
      return launch<Sample, Precision::kF32, true, Weights::kInt4>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

int check(const Launch& a) {
  if (a.channels <= 0 || a.pre <= 0 || a.skip < 0 || a.epoch <= 0 || a.features <= 0 ||
      a.pre + a.skip + a.epoch > a.stride) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch on `cuda_stream`. stream: (channels, capacity*stride) int16, or
// float32 when `float_samples` is 1 (a recording in another binary format,
// staged already scaled, unit resolutions), window i at columns
// [i*stride, i*stride + pre + skip + epoch); res: (channels,) float32; w:
// (epoch, features) float32 cascade matrix; weights: (channels*features,)
// float32; out: (capacity,) float32 margins before the intercept;
// precision: 0 f32, 2 int8, 3 int4 (ops/decode_ingest.PRECISIONS; 1, bf16,
// is refused). epoch 512 and features 16 run the ring engine, or on
// float32 samples the design `design` names (kRingMega: run_windows,
// kTileMega: the tile design; ops/serve_mega_cuda.py mega_design), every
// other size the generic one with the tile plan `any_plan` (kPlanFields
// ints: the design, then its AnyPlan or RingPlan fields;
// ops/generic_plan.py) and `design` kRingMega.
// Returns the cudaError_t of the launch (an inconsistent plan, or one that
// does not fit: cudaErrorInvalidValue), or kSharedMemoryExceeded where the
// sizes lie outside the generic engine's reach.
int serve_mega_launch(const void* stream, const void* res, const void* w,
                      const void* weights, void* out, int capacity, int channels,
                      int stride, int pre, int skip, int float_samples, int precision,
                      int epoch, int features, int design, const int* any_plan,
                      void* cuda_stream) {
  const Launch a{stream, res, w, weights, nullptr, nullptr, out, capacity, channels,
                 stride, pre, skip, epoch, features, any_plan, design, cuda_stream};
  if (capacity <= 0) return cudaSuccess;
  if (check(a) != cudaSuccess) return cudaErrorInvalidValue;
  if (float_samples) return launch_rung<float>(precision, a);
  return launch_rung<int16_t>(precision, a);
}

// K6: as serve_mega_launch at f32 (int16 or, with `float_samples`, float32
// samples), with lanes: (capacity,) int32, each in [0, 128) (the wrapper
// checks them on the host), and the tenant-major stack at
// `weights_precision` (0 f32, 2 int8, 3 int4): stack (128,
// channels*features) float32 (scales unused), or (128, channels*features)
// int8 levels, or (128, channels*features / 2) uint8 nibble pairs, with
// scales (128,) float32 (row t is tenant lane t's). out[i] is window i
// dotted with stack row lanes[i] (dequantized term by term), before the
// intercept.
int serve_mega_multi_launch(const void* stream, const void* res, const void* w,
                            const void* stack, const void* scales, const void* lanes,
                            void* out, int capacity, int channels, int stride, int pre,
                            int skip, int float_samples, int weights_precision, int epoch,
                            int features, int design, const int* any_plan,
                            void* cuda_stream) {
  const Launch a{stream, res, w, stack, scales, lanes, out, capacity, channels,
                 stride, pre, skip, epoch, features, any_plan, design, cuda_stream};
  if (capacity <= 0) return cudaSuccess;
  if (check(a) != cudaSuccess) return cudaErrorInvalidValue;
  if (float_samples) return launch_stack<float>(weights_precision, a);
  return launch_stack<int16_t>(weights_precision, a);
}

// The current card's multiprocessor count and per-block shared-memory
// opt-in limit; returns a cudaError_t.
int serve_mega_device_limits(int* sms, int* smem_optin) {
  return any_device_limits(sms, smem_optin);
}

const char* serve_mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
