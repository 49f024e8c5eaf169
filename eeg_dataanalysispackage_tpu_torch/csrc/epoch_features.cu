// Epoch features for Hopper (sm_90a): float32 epochs that the host already
// cut and baseline-corrected -> L2-normalized Daubechies features.
//
// Replaces the TPU kernel eeg_dataanalysispackage_tpu/ops/dwt_pallas.py:44
// (_make_kernel, wrapped by epoch_features_pallas at :65, pallas_call
// :104). Per epoch b and channel c of (B, C, T) float32 epochs:
//   y[c*16 + k] = sum_j x[b, c, skip + j] * W[j, k],  j < 512, k < 16
//   out[b]      = y / max(||y||, 1e-30)
// in f32 FMAs on CUDA cores (no tensor cores, no TF32); an all-zero epoch
// gives an all-zero row.
//
// The Pallas kernel DMAs a (128, C, T) tile into VMEM, slices each
// channel's window there and takes the product on the MXU, padding B to a
// multiple of the tile. Here a grid-stride loop walks the epochs, one per
// block at a time, so nothing is padded and B = 0 launches nothing. The
// window starts 175 floats (700 bytes) into a 750-float row, so a 16-byte
// global load would be misaligned: the block stages the C*512 window
// samples into shared memory with coalesced 4-byte cp.async copies, then
// contracts from shared memory with float4 loads through
// window_features.cuh's steps 4-5, which K1 and K5 run too. Two window
// buffers alternate: the copies of the block's next epoch are in flight
// while it contracts the current one, so a block waits on device memory
// once per launch instead of once per epoch.
//
// Bound on the H100: bytes. Per epoch at C = 3 the function reads the
// C*512 window floats (the other T - 512 columns are never read) and
// writes C*16 floats: 6,336 B, against 2*C*512*16 = 49 kFLOP. At 32,768
// epochs that is 207.6 MB, 0.062 ms at 3.35 TB/s, against 1.61 GFLOP,
// 0.024 ms at 67 TFLOP/s (f32, no tensor cores).
//
// Later work for speed: several epochs per block iteration, to spread
// the five barriers of an epoch over more work.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_features.cuh"

namespace {

using namespace window_features;

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

// Start copying the window [skip, skip + 512) of each channel of one epoch
// row into dst[channels][kEpoch]; one commit group per call.
__device__ __forceinline__ void stage_window_async(float* dst, const float* row, int channels,
                                                   int length) {
  for (int c = 0; c < channels; ++c) {
#pragma unroll
    for (int j = threadIdx.x; j < kEpoch; j += kThreads) {
      copy_async4(dst + c * kEpoch + j, row + c * length + j);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    epoch_features_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ out, int n, int channels, int length,
                          int skip) {
  extern __shared__ __align__(16) float smem[];
  // carve's baseline segment, sized channels*kEpoch here, is the second
  // window buffer: these epochs are baseline-corrected already
  const Smem s = carve(smem, channels, kEpoch);
  const int nfeat = channels * kFeatures;
  const long long row_floats = static_cast<long long>(channels) * length;
  float wreg[kPerGroup];
  load_operator(w, wreg);

  Smem cur = s;           // cur.z: the window being contracted
  float* fill = s.base;   // the window being copied
  int row = blockIdx.x;
  if (row < n) stage_window_async(cur.z, x + row * row_floats + skip, channels, length);
  for (; row < n; row += gridDim.x) {
    const int next = row + gridDim.x;
    // `fill` was last read before the previous iteration's closing barrier
    if (next < n) {
      stage_window_async(fill, x + next * row_floats + skip, channels, length);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // keep one group per iteration
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this thread's copies of `row`
    __syncthreads();                                  // and every other thread's
    const float denom = contract_and_norm(channels, wreg, cur);
    float* dst = out + static_cast<long long>(row) * nfeat;
    for (int i = threadIdx.x; i < nfeat; i += kThreads) dst[i] = s.feat[i] / denom;
    __syncthreads();
    float* const done = cur.z;
    cur.z = fill;
    fill = done;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. x: (n, channels, length) float32 epochs; w: (512, 16)
// float32 cascade matrix; out: (n, channels*16) float32. The window
// [skip, skip + 512) must lie inside each row. Returns the cudaError_t of
// the launch.
int epoch_features_launch(const void* x, const void* w, void* out, int n, int channels,
                          int length, int skip, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (channels <= 0 || skip < 0 || skip + kEpoch > length) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels, kEpoch);  // two window buffers
  int grid = 0;
  const cudaError_t err = plan_grid(epoch_features_kernel, smem, n, &grid);
  if (err != cudaSuccess) return err;
  epoch_features_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), n,
      channels, length, skip);
  return cudaGetLastError();
}

const char* epoch_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
