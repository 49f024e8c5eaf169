// Fused int16 ingest for Hopper (sm_90a): raw samples at irregular marker
// positions -> L2-normalized Daubechies features, one pass.
//
// Replaces the TPU kernels of eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:
//   _make_kernel          (mode "exact",    ingest_pallas.py:314)
//   _make_kernel_bank     (mode "bank128",  f32, ingest_pallas.py:462)
//   _make_kernel_aligned  (mode "aligned8", ingest_pallas.py:350)
// All three compute one function in three TPU layouts; "bank128" and
// "aligned8" exist only because the TPU compiler could not cut a window at
// an arbitrary lane offset. On Hopper a load at any offset is ordinary, so
// one kernel is the counterpart of all three: each window is cut at its
// exact start, with no tile planner, no variant bank and no unsort.
//
// Per window and channel c:
//   x     = float(raw[c, start + j]) * res[c]      (0 at or past n_samples)
//   mean  = sum(x[0 .. pre)) / pre                 (accumulated in double)
//   z     = x[pre + skip .. pre + skip + 512) - mean   (subtract first)
//   y[k]  = sum_j z[j] * W[j, k],  k < 16          (f32 FMAs, CUDA cores)
// then the C*16 coefficients are concatenated and divided by
// max(||y||, 1e-30); an all-zero window gives an all-zero row, not NaN.
// The baseline is subtracted before the contraction, never folded into W:
// on real EEG DC offsets the folded form cancels catastrophically in f32.
// The double baseline sum is exact for int16 x resolution products, so the
// mean does not depend on summation order and equals the plain version's.
//
// Bound on the H100: bytes. Per window at C = 3 the function needs
// C*612 int16 samples (the baseline and analysis segments; the 175 skipped
// samples are never read) and writes C*16 floats: about 3.9 KB, against
// 2*C*512*16 = 49 kFLOP. At 3.35 TB/s and 67 TFLOP/s (f32, no tensor
// cores) the bytes take the longer time.
//
// Design: a grid-stride loop over windows, so each block loads W once.
// Thread (g, k) of the 256 (16 sample groups x 16 features) keeps its 32
// rows of W's column k in registers; the window's samples are staged in
// shared memory (scaled, then centred), each thread contracts its group
// with float4 loads, and partial sums reduce through shared memory in a
// fixed order. No tensor cores and no TF32.
//
// Later work for speed: cp.async/TMA staging that overlaps the next
// window's loads with this window's contraction, several windows per
// block sharing the staged W, and wider int16 loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kEpoch = 512;                    // analysis-window samples
constexpr int kFeatures = 16;                  // coefficients per channel
constexpr int kGroups = 16;                    // sample groups per window
constexpr int kPerGroup = kEpoch / kGroups;    // 32 samples per group
constexpr int kThreads = kGroups * kFeatures;  // 256
constexpr int kWarps = kThreads / 32;          // 8

__global__ void __launch_bounds__(kThreads)
    ingest_features_kernel(const int16_t* __restrict__ raw,
                           const float* __restrict__ res,
                           const int* __restrict__ starts,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int channels,
                           int n_samples, int pre, int skip) {
  extern __shared__ __align__(16) float smem[];
  float* z = smem;                                  // [channels][kEpoch]
  float* base = z + channels * kEpoch;              // [channels][pre]
  float* part = base + channels * pre;              // [kWarps][channels*16]
  float* feat = part + kWarps * channels * kFeatures;  // [channels*16]
  float* mean = feat + channels * kFeatures;        // [channels]
  float* red = mean + channels;                     // [kWarps + 1]

  const int tid = threadIdx.x;
  const int g = tid / kFeatures;
  const int k = tid % kFeatures;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = pre + kEpoch;
  const int live = channels * seg;
  const int nfeat = channels * kFeatures;

  float wreg[kPerGroup];
#pragma unroll
  for (int i = 0; i < kPerGroup; ++i) {
    wreg[i] = w[(g * kPerGroup + i) * kFeatures + k];
  }

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const long long start = starts[row];

    // 1. stage: int16 -> f32 x resolution; samples outside the stream read 0
    for (int i = tid; i < live; i += kThreads) {
      const int c = i / seg;
      const int j = i - c * seg;
      const long long src = start + (j < pre ? j : skip + j);
      float v = 0.0f;
      if (src >= 0 && src < n_samples) {
        v = static_cast<float>(raw[static_cast<long long>(c) * n_samples + src]) *
            res[c];
      }
      if (j < pre) {
        base[c * pre + j] = v;
      } else {
        z[c * kEpoch + (j - pre)] = v;
      }
    }
    __syncthreads();

    // 2. baseline mean per channel, one warp per channel
    for (int c = warp; c < channels; c += kWarps) {
      double s = 0.0;
      for (int j = lane; j < pre; j += 32) s += static_cast<double>(base[c * pre + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) mean[c] = static_cast<float>(s / static_cast<double>(pre));
    }
    __syncthreads();

    // 3. subtract first
    for (int i = tid; i < channels * kEpoch; i += kThreads) z[i] -= mean[i / kEpoch];
    __syncthreads();

    // 4. contraction: thread (g, k) sums its 32 samples against W[:, k]
    for (int c = 0; c < channels; ++c) {
      const float4* zc = reinterpret_cast<const float4*>(z + c * kEpoch + g * kPerGroup);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kPerGroup / 4; ++q) {
        const float4 v = zc[q];
        acc = fmaf(v.x, wreg[4 * q + 0], acc);
        acc = fmaf(v.y, wreg[4 * q + 1], acc);
        acc = fmaf(v.z, wreg[4 * q + 2], acc);
        acc = fmaf(v.w, wreg[4 * q + 3], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);  // groups 2*warp, 2*warp+1
      if (lane < kFeatures) part[warp * nfeat + c * kFeatures + k] = acc;
    }
    __syncthreads();

    // 5. reduce the partial sums over warps, then normalize the row
    float ss = 0.0f;
    for (int i = tid; i < nfeat; i += kThreads) {
      float y = 0.0f;
      for (int p = 0; p < kWarps; ++p) y += part[p * nfeat + i];
      feat[i] = y;
      ss = fmaf(y, y, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
      for (int p = 0; p < kWarps; ++p) total += red[p];
      red[kWarps] = fmaxf(sqrtf(total), 1e-30f);
    }
    __syncthreads();
    const float denom = red[kWarps];
    float* dst = out + static_cast<long long>(row) * nfeat;
    for (int i = tid; i < nfeat; i += kThreads) dst[i] = feat[i] / denom;
    __syncthreads();
  }
}

size_t smem_bytes(int channels, int pre) {
  const size_t floats = static_cast<size_t>(channels) * kEpoch +
                        static_cast<size_t>(channels) * pre +
                        static_cast<size_t>(kWarps) * channels * kFeatures +
                        static_cast<size_t>(channels) * kFeatures + channels +
                        kWarps + 1;
  return floats * sizeof(float);
}

}  // namespace

extern "C" {

// Launch on `stream`. raw: (channels, n_samples) int16; res: (channels,)
// float32; starts: (n,) int32 window starts; w: (512, 16) float32;
// out: (n, channels*16) float32. Returns the cudaError_t of the launch.
int ingest_features_launch(const void* raw, const void* res, const void* starts,
                           const void* w, void* out, int n, int channels,
                           int n_samples, int pre, int skip, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (channels <= 0 || pre <= 0 || skip < 0 || n_samples < 0) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(channels, pre);
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_optin)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ingest_features_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ingest_features_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(n < want ? n : want);
  ingest_features_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(raw), static_cast<const float*>(res),
      static_cast<const int*>(starts), static_cast<const float*>(w),
      static_cast<float*>(out), n, channels, n_samples, pre, skip);
  return cudaGetLastError();
}

const char* ingest_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
