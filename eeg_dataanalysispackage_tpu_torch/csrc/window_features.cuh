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
//
// Precision instantiations (template argument P; ops/decode_ingest.py):
//   kF32   the function above;
//   kBf16  z and W each rounded to bfloat16 (round to nearest even)
//          before the contraction: the centred samples as step 3 writes
//          them, W as load_operator reads it. A product of two bf16
//          values is exact in f32, so the contraction accumulates in f32
//          in the same order as kF32; the norm is f32. This is the JAX
//          package's decode slice twin (subtract first in f32, cast the
//          centred operand, f32 accumulation);
//   kInt8, kInt4  the kF32 row, then quantize_feature on each element.
// The f32 form compiles to the same instructions as before the other
// forms existed: every difference is an `if constexpr`.

#pragma once

#include <cuda_bf16.h>
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

// The precision= rungs, in the order of ops/decode_ingest.PRECISIONS (the
// launchers take this code).
enum class Precision : int { kF32 = 0, kBf16 = 1, kInt8 = 2, kInt4 = 3 };

__host__ __device__ constexpr bool quantized(Precision p) {
  return p == Precision::kInt8 || p == Precision::kInt4;
}

// Symmetric quantization levels of a quantized rung: q in [-qmax, qmax].
__host__ __device__ constexpr float qmax_of(Precision p) {
  return p == Precision::kInt8 ? 127.0f : 7.0f;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

// Thread (g, k)'s 32 rows of the (512, 16) operator's column k (rounded
// to bfloat16 for the kBf16 rung).
template <Precision P = Precision::kF32>
__device__ __forceinline__ void load_operator(const float* __restrict__ w,
                                              float (&wreg)[kPerGroup]) {
  const int g = threadIdx.x / kFeatures;
  const int k = threadIdx.x % kFeatures;
#pragma unroll
  for (int i = 0; i < kPerGroup; ++i) {
    wreg[i] = w[(g * kPerGroup + i) * kFeatures + k];
    if constexpr (P == Precision::kBf16) wreg[i] = round_bf16(wreg[i]);
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
template <class Sample, Precision P = Precision::kF32>
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

  // 3. subtract first (then, for kBf16, round the centred operand)
  for (int i = tid; i < channels * kEpoch; i += kThreads) {
    s.z[i] -= s.mean[i / kEpoch];
    if constexpr (P == Precision::kBf16) s.z[i] = round_bf16(s.z[i]);
  }
  __syncthreads();

  return contract_and_norm(channels, wreg, s);
}

// The quantize step of the int8 and int4 rungs: element i of the
// L2-normalized row f (channels*16 floats in shared memory, complete
// before the call) after quantize -> dequantize with the symmetric scale
// of its (channel, subband group). The groups of a channel's 16
// coefficients are [0,1) [1,2) [2,4) [4,8) [8,16), the eegdsp layout
// [aK | dK | ... | d1]. These are the float32 operations, in order, of
// the plain version (ops/decode_ingest.quantize_dequantize) and of the
// JAX package's quantize_dequantize_int8/int4:
//   s = max|g| / qmax   (IEEE division: the build has no --use_fast_math)
//   s = max(s, 1e-30)   (an all-zero group: 0 / s stays 0)
//   q = clamp(rint(g / s), -qmax, qmax)   (rint: half to even), as an
//       integer (no negative zero)
//   out = q * s
// The group maximum is exact in any order, so the result is the plain
// version's bit for bit on the same row. It reads only row f, so a
// window's quantized row does not depend on the batch it rides in.
template <Precision P>
__device__ __forceinline__ float quantize_feature(const float* f, int i) {
  static_assert(quantized(P), "quantize_feature is for the int8 and int4 rungs");
  constexpr float qmax = qmax_of(P);
  const int k = i % kFeatures;
  const float* group = f + (i - k);
  const int lo = k == 0 ? 0 : 1 << (31 - __clz(k));
  const int hi = k == 0 ? 1 : 2 * lo;
  float m = 0.0f;
  for (int j = lo; j < hi; ++j) m = fmaxf(m, fabsf(group[j]));
  const float s = fmaxf(m / qmax, 1e-30f);
  const float q = fminf(fmaxf(rintf(f[i] / s), -qmax), qmax);
  // an integer level, as the JAX package's int8 cast makes it: -0.0 -> 0
  return static_cast<float>(static_cast<int>(q)) * s;
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
