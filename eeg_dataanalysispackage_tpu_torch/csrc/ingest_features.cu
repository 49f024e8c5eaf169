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
// longer time: 0.038 ms for 32,768 int16 windows.
//
// What held the one-window-per-block kernel at 9% of that bound was its
// serial chain: a block staged its window 2 bytes a thread at a time, ran
// six barriers, and only then issued the next window's loads. The design
// now is window_features.cuh's run_windows: one persistent wave of blocks,
// each keeping its next window's samples in flight as 16-byte cp.async
// chunks (the aligned superset of each segment at any start: a marker may
// sit at any sample, and a start may be negative or at or past the end)
// while it computes the current one; warp 0 runs the previous window's
// epilogue (the norm) beside the means and the staging, and for the
// int8/int4 rungs (the quantize step) through the centre as well, which
// warps 1..7 then take alone.
// The rows equal the one-window-per-block kernel's bit for bit (same
// arithmetic, same order), and it takes every channel count and baseline
// that kernel took (a wide montage runs in pieces of channels). What is
// left (PERF.md section 6: about a fifth of the bound at 32,768 windows):
// each block's per-window chain of dependent steps (means, centre,
// contraction and their barriers), of which four blocks a multiprocessor
// run at once, the 64 registers a thread allowing no more; a launch of
// one recording's ~320 rows is one such chain.
//
// Every other window and coefficient count (any window, any count its
// cascade has columns for) runs ingest_features_any_kernel, the generic
// engine of window_features_any.cuh, in the design its plan picks: the
// warp-specialised ring design (contracting and centring warps handing
// 32-sample chunks on through a ring of slots) or the phase-by-phase one
// (tiles of windows a block against W in shared memory); its notes give
// both designs and their bounds.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_features.cuh"
#include "window_features_any.cuh"

namespace {

using namespace window_features;

// Rows of the fused ingest: window `row` starts at starts[row]; warp 0
// writes its normalized (and, for kInt8/kInt4, quantized) row.
template <Precision P>
struct IngestRows {
  const int* __restrict__ starts;
  float* __restrict__ out;
  int channels;

  __device__ __forceinline__ int start(int row) const { return starts[row]; }
  __device__ __forceinline__ void epilogue(int row, const RingSmem& s, int lane) const {
    const int nfeat = channels * kFeatures;
    const float denom = reduce_and_norm(channels, s, lane);
    float* dst = out + static_cast<long long>(row) * nfeat;
    if constexpr (quantized(P)) {
      // two rounds of 32 elements at a time, their chains independent
      for (int base = 0; base < nfeat; base += 64) {
        const int i0 = base + lane;
        const int i1 = i0 + 32;
        const float q0 = quantize_lane<P>(i0 < nfeat ? s.feat[i0] / denom : 0.0f, lane);
        const float q1 = quantize_lane<P>(i1 < nfeat ? s.feat[i1] / denom : 0.0f, lane);
        if (i0 < nfeat) dst[i0] = q0;
        if (i1 < nfeat) dst[i1] = q1;
      }
    } else {
      for (int i = lane; i < nfeat; i += 32) dst[i] = s.feat[i] / denom;
    }
  }
  // the generic engine's: the calling warp writes the finished row
  __device__ __forceinline__ void finish(int row, const float* y, int nfeat, int lane) const {
    float* dst = out + static_cast<long long>(row) * nfeat;
    for (int i = lane; i < nfeat; i += 32) dst[i] = y[i];
  }
};

template <class Sample, Precision P, bool kWide>
__global__ void __launch_bounds__(kThreads, min_blocks_per_sm(kWide))
    ingest_features_kernel(const Sample* __restrict__ raw,
                           const float* __restrict__ res,
                           const int* __restrict__ starts,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int channels,
                           int n_samples, int pre, int skip, Ring ring) {
  extern __shared__ __align__(16) float smem[];
  const StreamView<Sample> v{raw, channels, n_samples};
  run_windows<Sample, P, kWide>(smem, v, res, w, n, pre, skip, ring,
                                IngestRows<P>{starts, out, channels});
}

// Every size but the main path's 512 / 16: the generic engine, `epoch`
// samples and `features` coefficients a channel, tiled as `plan` says in
// the design kDesign (window_features_any.cuh: run_tiles_ring, or the
// phase-by-phase run_tiles_any).
template <class Sample, Precision P, int kDesign>
__global__ void __launch_bounds__(design_threads<kDesign>(), design_min_blocks<kDesign>())
    ingest_features_any_kernel(const Sample* __restrict__ raw,
                               const float* __restrict__ res,
                               const int* __restrict__ starts,
                               const float* __restrict__ w,
                               float* __restrict__ out, int n, int channels,
                               int n_samples, int pre, int skip, int epoch, int features,
                               DesignPlan<kDesign> plan) {
  extern __shared__ __align__(16) float smem[];
  const StreamView<Sample> v{raw, channels, n_samples};
  run_design<kDesign, Sample, P>(smem, v, res, w, n, pre, skip, epoch, features, plan,
                                 IngestRows<P>{starts, out, channels});
}

template <class Sample, Precision P, bool kWide>
int launch_ring(const Ring& ring, size_t smem, const void* raw, const void* res,
                const void* starts, const void* w, void* out, int n, int channels,
                int n_samples, int pre, int skip, void* stream) {
  int grid = 0;
  const cudaError_t err = plan_grid(ingest_features_kernel<Sample, P, kWide>, smem, n, &grid);
  if (err != cudaSuccess) return err;
  ingest_features_kernel<Sample, P, kWide>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Sample*>(raw), static_cast<const float*>(res),
          static_cast<const int*>(starts), static_cast<const float*>(w),
          static_cast<float*>(out), n, channels, n_samples, pre, skip, ring);
  return cudaGetLastError();
}

template <class Sample, Precision P, int kDesign>
int launch_design(const void* raw, const void* res, const void* starts, const void* w,
                  void* out, int n, int channels, int n_samples, int pre, int skip, int epoch,
                  int features, const int* fields, void* stream) {
  DesignPlan<kDesign> plan{};
  size_t smem = 0;
  const int checked =
      check_plan<kDesign, Sample>(fields, channels, epoch, features, pre, &plan, &smem);
  if (checked != cudaSuccess) return checked;
  int grid = 0;
  const cudaError_t err =
      plan_grid_threads(ingest_features_any_kernel<Sample, P, kDesign>,
                        design_threads<kDesign>(), smem, (n + plan.m - 1) / plan.m, &grid);
  if (err != cudaSuccess) return err;
  ingest_features_any_kernel<Sample, P, kDesign>
      <<<grid, design_threads<kDesign>(), smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Sample*>(raw), static_cast<const float*>(res),
          static_cast<const int*>(starts), static_cast<const float*>(w),
          static_cast<float*>(out), n, channels, n_samples, pre, skip, epoch, features, plan);
  return cudaGetLastError();
}

// The generic engine in the design the plan's first field names (a missing
// plan, or one of no design, is refused by the phase-by-phase design's
// check after the reach).
template <class Sample, Precision P>
int launch_any(const void* raw, const void* res, const void* starts, const void* w, void* out,
               int n, int channels, int n_samples, int pre, int skip, int epoch, int features,
               const int* any_plan, void* stream) {
  if (const int* ring = design_fields(any_plan, kRingDesign)) {
    return launch_design<Sample, P, kRingDesign>(raw, res, starts, w, out, n, channels,
                                                 n_samples, pre, skip, epoch, features, ring,
                                                 stream);
  }
  return launch_design<Sample, P, kPhaseDesign>(raw, res, starts, w, out, n, channels,
                                                n_samples, pre, skip, epoch, features,
                                                design_fields(any_plan, kPhaseDesign), stream);
}

template <class Sample, Precision P>
int launch(const void* raw, const void* res, const void* starts, const void* w, void* out,
           int n, int channels, int n_samples, int pre, int skip, int epoch, int features,
           const int* any_plan, void* stream) {
  if (epoch != kEpoch || features != kFeatures) {
    return launch_any<Sample, P>(raw, res, starts, w, out, n, channels, n_samples, pre, skip,
                                 epoch, features, any_plan, stream);
  }
  Ring ring{};
  size_t smem = 0;
  const cudaError_t err = plan_ring<Sample>(channels, pre, &ring, &smem);
  if (err != cudaSuccess) return err;
  if (wide_ring(ring, channels)) {
    return launch_ring<Sample, P, true>(ring, smem, raw, res, starts, w, out, n, channels,
                                        n_samples, pre, skip, stream);
  }
  return launch_ring<Sample, P, false>(ring, smem, raw, res, starts, w, out, n, channels,
                                       n_samples, pre, skip, stream);
}

template <class Sample>
int launch_rung(int precision, const void* raw, const void* res, const void* starts,
                const void* w, void* out, int n, int channels, int n_samples, int pre,
                int skip, int epoch, int features, const int* any_plan, void* stream) {
  switch (static_cast<Precision>(precision)) {
    case Precision::kF32:
      return launch<Sample, Precision::kF32>(raw, res, starts, w, out, n, channels,
                                             n_samples, pre, skip, epoch, features, any_plan,
                                             stream);
    case Precision::kBf16:
      return launch<Sample, Precision::kBf16>(raw, res, starts, w, out, n, channels,
                                              n_samples, pre, skip, epoch, features, any_plan,
                                              stream);
    case Precision::kInt8:
      return launch<Sample, Precision::kInt8>(raw, res, starts, w, out, n, channels,
                                              n_samples, pre, skip, epoch, features, any_plan,
                                              stream);
    case Precision::kInt4:
      return launch<Sample, Precision::kInt4>(raw, res, starts, w, out, n, channels,
                                              n_samples, pre, skip, epoch, features, any_plan,
                                              stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`. raw: (channels, n_samples) int16, or float32 when
// `float_samples` is 1; res: (channels,) float32; starts: (n,) int32
// window starts; w: (epoch, features) float32; out: (n, channels*features)
// float32; precision: 0 f32, 1 bf16, 2 int8, 3 int4
// (ops/decode_ingest.PRECISIONS). epoch 512 and features 16 run the ring
// engine, every other size the generic one with the tile plan `any_plan`
// (kPlanFields ints: the design, then its AnyPlan or RingPlan fields in
// their order; ops/generic_plan.py; not read at 512 / 16). Returns the cudaError_t of the launch (an
// inconsistent plan, or one that does not fit: cudaErrorInvalidValue), or
// kSharedMemoryExceeded where the sizes lie outside the generic engine's
// reach.
int ingest_features_launch(const void* raw, const void* res, const void* starts,
                           const void* w, void* out, int n, int channels,
                           int n_samples, int pre, int skip, int float_samples,
                           int precision, int epoch, int features, const int* any_plan,
                           void* stream) {
  if (n <= 0) return cudaSuccess;
  if (channels <= 0 || pre <= 0 || skip < 0 || n_samples < 0 || epoch <= 0 || features <= 0) {
    return cudaErrorInvalidValue;
  }
  if (float_samples) {
    return launch_rung<float>(precision, raw, res, starts, w, out, n, channels, n_samples,
                              pre, skip, epoch, features, any_plan, stream);
  }
  return launch_rung<int16_t>(precision, raw, res, starts, w, out, n, channels, n_samples,
                              pre, skip, epoch, features, any_plan, stream);
}

// The current card's multiprocessor count and per-block shared-memory
// opt-in limit; returns a cudaError_t.
int ingest_features_device_limits(int* sms, int* smem_optin) {
  return any_device_limits(sms, smem_optin);
}

const char* ingest_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
