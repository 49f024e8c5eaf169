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
//            i * stride (the same instructions as the fused ingest kernel,
//            so the features equal that kernel's bit for bit)
//   f      = y / max(||y||, 1e-30)
//   f      = quantize_feature(f)     (the int8 and int4 instantiations only:
//            window_features.cuh's quantize step, the one the fused ingest
//            kernel's int8/int4 epilogue runs)
//   out[i] = sum_k f_k * weights_k   (warp 0: lane-strided FMAs, then a
//            butterfly; fixed order, no atomics), before the intercept.
// An all-zero (padded) window gives exactly 0.0. bf16 has no megakernel:
// its rung differs in the contraction's operands, not in the finished row.
//
// Bound on the H100: bytes. Per window at C = 3 the function reads C*612
// int16 samples (baseline and analysis segments) and writes one float:
// about 3.7 KB, against 2*C*512*16 + 2*48 = 49 kFLOP. At 32,768 windows
// that is 120.5 MB, 0.036 ms at 3.35 TB/s, against 0.024 ms for 1.61
// GFLOP at 67 TFLOP/s (f32, no tensor cores). At one serve batch (64
// windows) the bound is under 0.1 us and launch latency sets the time.
//
// Later work for speed: the fused ingest kernel's (TMA staging, several
// windows per block), and 16-byte int16 loads: every window starts on a
// 16-byte boundary (stride 896 x 2 B).

#include <cuda_runtime.h>

#include <cstdint>

#include "window_features.cuh"

namespace {

using namespace window_features;

template <Precision P>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    serve_mega_kernel(const int16_t* __restrict__ stream,
                      const float* __restrict__ res,
                      const float* __restrict__ w,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int capacity, int channels,
                      int stride, int pre, int skip) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, channels, pre);
  const int nfeat = channels * kFeatures;
  const int n_samples = capacity * stride;
  const int lane = threadIdx.x % 32;
  float wreg[kPerGroup];
  load_operator(w, wreg);

  for (int row = blockIdx.x; row < capacity; row += gridDim.x) {
    const float denom =
        featurize_window(stream, res, static_cast<long long>(row) * stride, channels,
                         n_samples, pre, skip, wreg, s);
    for (int i = threadIdx.x; i < nfeat; i += kThreads) s.feat[i] = s.feat[i] / denom;
    __syncthreads();
    const float* f = s.feat;
    if constexpr (quantized(P)) {
      // the quantized row goes to s.part, free until the next window's step 4
      for (int i = threadIdx.x; i < nfeat; i += kThreads) {
        s.part[i] = quantize_feature<P>(s.feat, i);
      }
      __syncthreads();
      f = s.part;
    }
    // Warp 0 reads only the row f (s.feat or s.part), which the next
    // window rewrites after featurize_window's first barrier, so no
    // barrier is needed after it.
    if (threadIdx.x < 32) {
      float m = 0.0f;
      for (int i = lane; i < nfeat; i += 32) m = fmaf(f[i], weights[i], m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m += __shfl_xor_sync(0xffffffffu, m, off);
      if (lane == 0) out[row] = m;
    }
  }
}

template <Precision P>
int launch(const void* stream, const void* res, const void* w, const void* weights,
           void* out, int capacity, int channels, int stride, int pre, int skip,
           void* cuda_stream) {
  const size_t smem = smem_bytes(channels, pre);
  int grid = 0;
  const cudaError_t err = plan_grid(serve_mega_kernel<P>, smem, capacity, &grid);
  if (err != cudaSuccess) return err;
  serve_mega_kernel<P><<<grid, kThreads, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(stream), static_cast<const float*>(res),
      static_cast<const float*>(w), static_cast<const float*>(weights),
      static_cast<float*>(out), capacity, channels, stride, pre, skip);
  return cudaGetLastError();
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

const char* serve_mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
