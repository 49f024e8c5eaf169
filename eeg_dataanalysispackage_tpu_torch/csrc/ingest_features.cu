// Fused ingest for Hopper (sm_90a): raw samples at irregular marker
// positions -> L2-normalized Daubechies features, one pass. The samples are
// int16 (INT_16 recordings, scaled by their resolutions on the card) or
// float32 (other formats, staged already scaled with unit resolutions).
//
// Replaces the TPU kernels of eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:
//   _make_kernel          (mode "exact",    ingest_pallas.py:314)
//   _make_kernel_bank     (mode "bank128",  f32, ingest_pallas.py:462)
//   _make_kernel_bank     (mode "bank128_bf16", the same call site: the
//                          precision=bf16 rung, instantiation kBf16)
//   _make_kernel_aligned  (mode "aligned8", ingest_pallas.py:350)
// All three compute one function in three TPU layouts; "bank128" and
// "aligned8" exist only because the TPU compiler could not cut a window at
// an arbitrary lane offset. On Hopper a load at any offset is ordinary, so
// one kernel is the counterpart of all three: each window is cut at its
// exact start, with no tile planner, no variant bank and no unsort.
//
// Per window: the C*16 coefficients of window_features.cuh (scale, cut,
// subtract the double-accumulated baseline mean, contract with the
// cascade matrix), concatenated and divided by max(||y||, 1e-30); an
// all-zero window gives an all-zero row, not NaN.
//
// The precision= rungs are instantiations (window_features.cuh):
// kBf16 contracts bfloat16-rounded operands (the bank128_bf16 Pallas
// mode centres on a slab mean before its cast, a different rounding; this
// kernel computes the JAX package's decode slice twin, which subtracts
// the baseline first, as the f32 form does); kInt8 and kInt4 run the
// quantize step as an epilogue on the normalized row in shared memory
// (the JAX package quantizes in XLA after its kernel). The rungs stream
// the same int16 or float32 samples, so they have the f32 form's bound.
//
// Bound on the H100: bytes. Per window at C = 3 the function needs
// C*612 samples (the baseline and analysis segments; the 175 skipped
// samples are never read) and writes C*16 floats: about 3.9 KB for int16
// samples and 7.5 KB for float32, against 2*C*512*16 = 49 kFLOP. At
// 3.35 TB/s and 67 TFLOP/s (f32, no tensor cores) the bytes take the
// longer time.
//
// Design: a grid-stride loop over windows, so each block loads W once;
// the per-window work is window_features.cuh's.
//
// Later work for speed: cp.async/TMA staging that overlaps the next
// window's loads with this window's contraction, several windows per
// block sharing the staged W, and wider int16 loads.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_features.cuh"

namespace {

using namespace window_features;

template <class Sample, Precision P>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    ingest_features_kernel(const Sample* __restrict__ raw,
                           const float* __restrict__ res,
                           const int* __restrict__ starts,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int channels,
                           int n_samples, int pre, int skip) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, channels, pre);
  const int nfeat = channels * kFeatures;
  float wreg[kPerGroup];
  load_operator<P>(w, wreg);

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const float denom = featurize_window<Sample, P>(raw, res, starts[row], channels,
                                                    n_samples, pre, skip, wreg, s);
    float* dst = out + static_cast<long long>(row) * nfeat;
    if constexpr (quantized(P)) {
      // the quantize epilogue reads whole groups of the normalized row
      for (int i = threadIdx.x; i < nfeat; i += kThreads) s.feat[i] = s.feat[i] / denom;
      __syncthreads();
      for (int i = threadIdx.x; i < nfeat; i += kThreads) {
        dst[i] = quantize_feature<P>(s.feat, i);
      }
    } else {
      for (int i = threadIdx.x; i < nfeat; i += kThreads) dst[i] = s.feat[i] / denom;
    }
    __syncthreads();
  }
}

template <class Sample, Precision P>
int launch(const void* raw, const void* res, const void* starts, const void* w, void* out,
           int n, int channels, int n_samples, int pre, int skip, void* stream) {
  const size_t smem = smem_bytes(channels, pre);
  int grid = 0;
  const cudaError_t err = plan_grid(ingest_features_kernel<Sample, P>, smem, n, &grid);
  if (err != cudaSuccess) return err;
  ingest_features_kernel<Sample, P><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Sample*>(raw), static_cast<const float*>(res),
      static_cast<const int*>(starts), static_cast<const float*>(w),
      static_cast<float*>(out), n, channels, n_samples, pre, skip);
  return cudaGetLastError();
}

template <class Sample>
int launch_rung(int precision, const void* raw, const void* res, const void* starts,
                const void* w, void* out, int n, int channels, int n_samples, int pre,
                int skip, void* stream) {
  switch (static_cast<Precision>(precision)) {
    case Precision::kF32:
      return launch<Sample, Precision::kF32>(raw, res, starts, w, out, n, channels,
                                             n_samples, pre, skip, stream);
    case Precision::kBf16:
      return launch<Sample, Precision::kBf16>(raw, res, starts, w, out, n, channels,
                                              n_samples, pre, skip, stream);
    case Precision::kInt8:
      return launch<Sample, Precision::kInt8>(raw, res, starts, w, out, n, channels,
                                              n_samples, pre, skip, stream);
    case Precision::kInt4:
      return launch<Sample, Precision::kInt4>(raw, res, starts, w, out, n, channels,
                                              n_samples, pre, skip, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`. raw: (channels, n_samples) int16, or float32 when
// `float_samples` is 1; res: (channels,) float32; starts: (n,) int32
// window starts; w: (512, 16) float32; out: (n, channels*16) float32;
// precision: 0 f32, 1 bf16, 2 int8, 3 int4 (ops/decode_ingest.PRECISIONS).
// Returns the cudaError_t of the launch.
int ingest_features_launch(const void* raw, const void* res, const void* starts,
                           const void* w, void* out, int n, int channels,
                           int n_samples, int pre, int skip, int float_samples,
                           int precision, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (channels <= 0 || pre <= 0 || skip < 0 || n_samples < 0) {
    return cudaErrorInvalidValue;
  }
  if (float_samples) {
    return launch_rung<float>(precision, raw, res, starts, w, out, n, channels, n_samples,
                              pre, skip, stream);
  }
  return launch_rung<int16_t>(precision, raw, res, starts, w, out, n, channels, n_samples,
                              pre, skip, stream);
}

const char* ingest_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
