// One window of samples -> its C*16 Daubechies coefficients, for one
// block of kThreads threads. Shared by the fused ingest kernel
// (ingest_features.cu) and the serve megakernel (serve_mega.cu): both run
// these instructions per window, so their feature rows agree bit for bit.
// The epoch-features kernel (epoch_features.cu) stages already
// baseline-corrected epochs itself and shares steps 4-5 only.
//
// Per channel c of a window starting at `start`:
//   x     = float(raw[c, start + j]) * res[c]      (0 at or past n_samples;
//                                                   raw is int16 or float)
//   mean  = sum(x[0 .. pre)) / pre                 (accumulated in double)
//   z     = x[pre + skip .. pre + skip + 512) - mean   (subtract first)
//   y[k]  = sum_j z[j] * W[j, k],  k < 16          (f32 FMAs, CUDA cores)
// The baseline is subtracted before the contraction, never folded into W:
// on real EEG DC offsets the folded form cancels catastrophically in f32.
// For int16 samples the double baseline sum is exact (int16 x resolution
// products), so the mean does not depend on summation order and equals the
// plain version's bit for bit. For float samples the sum need not be exact,
// and the mean may differ from the plain version's by an ulp.
//
// Thread (g, k) of the 256 (16 sample groups x 16 features) keeps its 32
// rows of W's column k in registers; the window's samples are staged in
// shared memory (scaled, then centred), each thread contracts its group
// with float4 loads, and partial sums reduce through shared memory in a
// fixed order. No tensor cores and no TF32.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace window_features {

constexpr int kEpoch = 512;                    // analysis-window samples
constexpr int kFeatures = 16;                  // coefficients per channel
constexpr int kGroups = 16;                    // sample groups per window
constexpr int kPerGroup = kEpoch / kGroups;    // 32 samples per group
constexpr int kThreads = kGroups * kFeatures;  // 256
constexpr int kWarps = kThreads / 32;          // 8
// Blocks each kernel asks to keep resident per SM (__launch_bounds__):
// four blocks of 256 threads cap a thread at 64 registers. Without the
// cap the fused ingest kernel took 75 registers, three blocks per SM,
// and ran 20% slower on the H100.
constexpr int kMinBlocksPerSm = 4;

// The block's dynamic shared memory, carved per launch geometry.
struct Smem {
  float* z;     // [channels][kEpoch]   centred analysis samples
  float* base;  // [channels][pre]      scaled baseline samples
  float* part;  // [kWarps][channels*16] partial contractions
  float* feat;  // [channels*16]        coefficients of the window
  float* mean;  // [channels]
  float* red;   // [kWarps + 1]         norm partials, then the divisor
};

__device__ __forceinline__ Smem carve(float* smem, int channels, int pre) {
  Smem s;
  s.z = smem;
  s.base = s.z + channels * kEpoch;
  s.part = s.base + channels * pre;
  s.feat = s.part + kWarps * channels * kFeatures;
  s.mean = s.feat + channels * kFeatures;
  s.red = s.mean + channels;
  return s;
}

inline size_t smem_bytes(int channels, int pre) {
  const size_t floats = static_cast<size_t>(channels) * kEpoch +
                        static_cast<size_t>(channels) * pre +
                        static_cast<size_t>(kWarps) * channels * kFeatures +
                        static_cast<size_t>(channels) * kFeatures + channels +
                        kWarps + 1;
  return floats * sizeof(float);
}

// Thread (g, k)'s 32 rows of the (512, 16) operator's column k.
__device__ __forceinline__ void load_operator(const float* __restrict__ w,
                                              float (&wreg)[kPerGroup]) {
  const int g = threadIdx.x / kFeatures;
  const int k = threadIdx.x % kFeatures;
#pragma unroll
  for (int i = 0; i < kPerGroup; ++i) {
    wreg[i] = w[(g * kPerGroup + i) * kFeatures + k];
  }
}

// Steps 4-5 on the C*512 centred samples in s.z: leaves the C*16
// coefficients y in s.feat and returns max(||y||, 1e-30) to every thread.
// Expects s.z written and a barrier passed; ends on a barrier, so the caller
// may read s.feat at once.
__device__ __forceinline__ float contract_and_norm(int channels,
                                                   const float (&wreg)[kPerGroup],
                                                   const Smem& s) {
  const int tid = threadIdx.x;
  const int g = tid / kFeatures;
  const int k = tid % kFeatures;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nfeat = channels * kFeatures;

  // 4. contraction: thread (g, k) sums its 32 samples against W[:, k]
  for (int c = 0; c < channels; ++c) {
    const float4* zc = reinterpret_cast<const float4*>(s.z + c * kEpoch + g * kPerGroup);
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
    if (lane < kFeatures) s.part[warp * nfeat + c * kFeatures + k] = acc;
  }
  __syncthreads();

  // 5. reduce the partial sums over warps, then the row's norm
  float ss = 0.0f;
  for (int i = tid; i < nfeat; i += kThreads) {
    float y = 0.0f;
    for (int p = 0; p < kWarps; ++p) y += s.part[p * nfeat + i];
    s.feat[i] = y;
    ss = fmaf(y, y, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) s.red[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int p = 0; p < kWarps; ++p) total += s.red[p];
    s.red[kWarps] = fmaxf(sqrtf(total), 1e-30f);
  }
  __syncthreads();
  return s.red[kWarps];
}

// Featurize the window at `start` of the (channels, n_samples) stream of
// int16_t or float samples: leaves the C*16 coefficients y in s.feat and
// returns max(||y||, 1e-30) to every thread. Ends on a barrier; the caller
// may read s.feat at once.
template <class Sample>
__device__ __forceinline__ float featurize_window(
    const Sample* __restrict__ raw, const float* __restrict__ res,
    long long start, int channels, int n_samples, int pre, int skip,
    const float (&wreg)[kPerGroup], const Smem& s) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = pre + kEpoch;
  const int live = channels * seg;

  // 1. stage: sample -> f32 x resolution; samples outside the stream read 0
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
      s.base[c * pre + j] = v;
    } else {
      s.z[c * kEpoch + (j - pre)] = v;
    }
  }
  __syncthreads();

  // 2. baseline mean per channel, one warp per channel
  for (int c = warp; c < channels; c += kWarps) {
    double sum = 0.0;
    for (int j = lane; j < pre; j += 32) sum += static_cast<double>(s.base[c * pre + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) s.mean[c] = static_cast<float>(sum / static_cast<double>(pre));
  }
  __syncthreads();

  // 3. subtract first
  for (int i = tid; i < channels * kEpoch; i += kThreads) s.z[i] -= s.mean[i / kEpoch];
  __syncthreads();

  return contract_and_norm(channels, wreg, s);
}

// Opt in to the block's shared memory and size a grid-stride grid: one
// resident wave of blocks, or `rows` blocks where that is fewer.
template <class Kernel>
cudaError_t plan_grid(Kernel kernel, size_t smem, int rows, int* grid) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_optin)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(rows < want ? rows : want);
  return cudaSuccess;
}

}  // namespace window_features
