// The serve megakernel for Hopper (sm_90a): a micro-batch of int16 windows
// laid out at a regular stride -> one linear margin per window, with the
// features kept in shared memory and never written to device memory.
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
// GFLOP at 67 TFLOP/s (f32, no tensor cores). At one serve batch (64
// windows) the bound is under 0.1 us and one window's chain sets the time.
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
// Design: window_features.cuh's run_windows (a persistent wave of blocks,
// each keeping its next window's samples in flight as 16-byte cp.async
// chunks while it computes one; every window starts on a 16-byte boundary,
// stride 896 x 2 B, and its analysis segment 3 samples into a chunk; warp
// 0's epilogue, the norm and the dot, overlaps warps 1..7's means and
// staging of the next window, and for the int8/int4 rungs, with the
// quantize step, their centre as well). The
// one-window-per-block kernel before it staged 2 bytes a thread at a time
// and ran seven barriers a window; it reached 10% of the bound. K6's warp
// 0 loads the row's lane, then its weights, before the reduce and the norm
// (not after the norm), so both loads overlap them. What is left (PERF.md
// section 6: about a fifth of the bound at 32,768 windows; one serve
// batch is one window's chain): each block's chain of dependent steps per
// window, of which four blocks a multiprocessor run at once (see
// ingest_features.cu).

#include <cuda_runtime.h>

#include <cstdint>

#include "window_features.cuh"

namespace {

using namespace window_features;

// Margins of the megakernel: window `row` starts at row * stride and warp 0
// dots its row with `weights` (kMulti: with row lanes[row] of the
// tenant-major stack `weights`; K6).
template <Precision P, bool kMulti>
struct MegaMargins {
  int stride;
  const float* __restrict__ weights;
  const int* __restrict__ lanes;
  float* __restrict__ out;
  int channels;

  // capacity * stride fits an int (the wrapper checks the stream length)
  __device__ __forceinline__ int start(int row) const { return row * stride; }
  __device__ __forceinline__ void epilogue(int row, const RingSmem& s, int lane) const {
    // the quantize step's addresses derive from the lane: opaque to the
    // compiler, they are computed here rather than held across the window
    // loop, where they do not fit 64 registers beside W's column
    if constexpr (quantized(P)) asm volatile("" : "+r"(lane));
    const int nfeat = channels * kFeatures;
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
};

// kMulti: `weights` is the tenant-major (128, channels*16) stack and row i
// dots with its row lanes[i] (K6); otherwise `weights` is one vector and
// `lanes` is not read (K5). kWide: run_windows' wide instantiation.
template <Precision P, bool kMulti, bool kWide>
__global__ void __launch_bounds__(kThreads, min_blocks_per_sm(kWide))
    serve_mega_kernel(const int16_t* __restrict__ stream,
                      const float* __restrict__ res,
                      const float* __restrict__ w,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int capacity, int channels,
                      int stride, int pre, int skip,
                      const int* __restrict__ lanes, Ring ring, int n_samples) {
  static_assert(!kMulti || P == Precision::kF32, "the tenant stack is f32");
  extern __shared__ __align__(16) float smem[];
  // n_samples = capacity * stride, a launch argument rather than a product
  // the loop would hold in a register
  const StreamView<int16_t> v{stream, channels, n_samples};
  run_windows<int16_t, P, kWide>(smem, v, res, w, capacity, pre, skip, ring,
                                 MegaMargins<P, kMulti>{stride, weights, lanes, out, channels});
}

template <Precision P, bool kMulti, bool kWide>
int launch_ring(const Ring& ring, size_t smem, const void* stream, const void* res,
                const void* w, const void* weights, void* out, int capacity, int channels,
                int stride, int pre, int skip, void* cuda_stream, const void* lanes) {
  int grid = 0;
  const cudaError_t err = plan_grid(serve_mega_kernel<P, kMulti, kWide>, smem, capacity, &grid);
  if (err != cudaSuccess) return err;
  serve_mega_kernel<P, kMulti, kWide>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
          static_cast<const int16_t*>(stream), static_cast<const float*>(res),
          static_cast<const float*>(w), static_cast<const float*>(weights),
          static_cast<float*>(out), capacity, channels, stride, pre, skip,
          static_cast<const int*>(lanes), ring, capacity * stride);
  return cudaGetLastError();
}

template <Precision P, bool kMulti = false>
int launch(const void* stream, const void* res, const void* w, const void* weights,
           void* out, int capacity, int channels, int stride, int pre, int skip,
           void* cuda_stream, const void* lanes = nullptr) {
  Ring ring{};
  size_t smem = 0;
  const cudaError_t err = plan_ring<int16_t>(channels, pre, &ring, &smem);
  if (err != cudaSuccess) return err;
  if (wide_ring(ring, channels)) {
    return launch_ring<P, kMulti, true>(ring, smem, stream, res, w, weights, out, capacity,
                                        channels, stride, pre, skip, cuda_stream, lanes);
  }
  return launch_ring<P, kMulti, false>(ring, smem, stream, res, w, weights, out, capacity,
                                       channels, stride, pre, skip, cuda_stream, lanes);
}

}  // namespace

extern "C" {

// Launch on `cuda_stream`. stream: (channels, capacity*stride) int16, window
// i at columns [i*stride, i*stride + pre + skip + 512); res: (channels,)
// float32; w: (512, 16) float32 cascade matrix; weights: (channels*16,)
// float32; out: (capacity,) float32 margins before the intercept;
// precision: 0 f32, 2 int8, 3 int4 (ops/decode_ingest.PRECISIONS; 1, bf16,
// is refused). Returns the cudaError_t of the launch.
int serve_mega_launch(const void* stream, const void* res, const void* w,
                      const void* weights, void* out, int capacity, int channels,
                      int stride, int pre, int skip, int precision, void* cuda_stream) {
  if (capacity <= 0) return cudaSuccess;
  if (channels <= 0 || pre <= 0 || skip < 0 || pre + skip + kEpoch > stride) {
    return cudaErrorInvalidValue;
  }
  switch (static_cast<Precision>(precision)) {
    case Precision::kF32:
      return launch<Precision::kF32>(stream, res, w, weights, out, capacity, channels,
                                     stride, pre, skip, cuda_stream);
    case Precision::kInt8:
      return launch<Precision::kInt8>(stream, res, w, weights, out, capacity, channels,
                                      stride, pre, skip, cuda_stream);
    case Precision::kInt4:
      return launch<Precision::kInt4>(stream, res, w, weights, out, capacity, channels,
                                      stride, pre, skip, cuda_stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K6: as serve_mega_launch at f32, with stack: (128, channels*16) float32,
// tenant-major (row t is tenant lane t's weights), and lanes: (capacity,)
// int32, each in [0, 128) (the wrapper checks them on the host). out[i] is
// window i dotted with stack row lanes[i], before the intercept.
int serve_mega_multi_launch(const void* stream, const void* res, const void* w,
                            const void* stack, const void* lanes, void* out,
                            int capacity, int channels, int stride, int pre, int skip,
                            void* cuda_stream) {
  if (capacity <= 0) return cudaSuccess;
  if (channels <= 0 || pre <= 0 || skip < 0 || pre + skip + kEpoch > stride) {
    return cudaErrorInvalidValue;
  }
  return launch<Precision::kF32, true>(stream, res, w, stack, out, capacity, channels,
                                       stride, pre, skip, cuda_stream, lanes);
}

const char* serve_mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
