#!/usr/bin/env python3
"""Measure the float32 megakernel's tile design on one NVIDIA card.

    python3 chip_tiles.py

Builds a small probe program from ``csrc/serve_mega.cu`` (and so from
``csrc/window_tiles.cuh``) with ``nvcc`` into a temporary directory and
runs it on 32,768 windows of 3 float32 channels at the serve stride (896
samples, ``pre`` 100, ``skip`` 175), the stream filled with seeded samples.
It prints one JSON line a measurement, each with the card's ``nvidia-smi``
name and power limit:

1. ``staging``: the tile design's stages filled and handed back with no
   work between, through its 17 TMA boxes a tile (``route: "tma"``, lane
   0 of one warp issuing) or through the same bytes as 16-byte ``cp.async``
   chunks from four producer warps (``route: "cp_async"``, each thread's
   arrival tracking its copies on the stage's mbarrier), in the ring of
   the design's stage size and count;
2. ``roles``: K5-f32s in the tile design with the work of some roles
   removed (``run_tiles_f32s``' ``kSkipWork`` mask: 1 the centring, 2 the
   contraction, 4 the epilogue; each role still hands its stages on), 0
   being the kernel itself.

Times are device milliseconds a launch, CUDA events around 20 back-to-back
launches after 3 more. Exits non-zero without a card or when the build or a
launch fails. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "eeg_dataanalysispackage_tpu_torch", "csrc", "serve_mega.cu")

PROBE = r"""
#include "@SOURCE@"

#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {

using namespace window_features;
constexpr int kC = 3, kCap = 32768, kStride = 896, kPre = 100, kSkip = 175;
using Tile = TileMargins<Precision::kF32, false, Weights::kF32>;

// The stages of the tile design filled and handed back: kTma, lane 0 of
// warp 0 issues each tile's 17 boxes; otherwise warps 0..3 copy the same
// samples as 16-byte cp.async chunks into the same layout. Warp 4 waits
// for each stage and hands it back.
template <bool kTma>
__global__ void __launch_bounds__(160, 1)
    staging(const __grid_constant__ CUtensorMap seg_map, const __grid_constant__ CUtensorMap base_map,
            const float* __restrict__ stream, int stages) {
  extern __shared__ __align__(16) float smem_raw[];
  const unsigned raw = smem_address(smem_raw);
  char* smem = reinterpret_cast<char*>(smem_raw) + ((128 - (raw & 127)) & 127);
  const int sbytes = tiles::stage_bytes(kC, kPre);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * sbytes);
  uint64_t* empty = full + tiles::kMaxStages;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kTma ? 1 : 128);
      mbar_init(empty + s, 1);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const int tiles_n = kCap / tiles::kWindows;
  const int gbytes = tiles::group_floats(kC) * 4;
  const int x0 = (kPre + kSkip) / 4 * 4;
  if (warp < 4) {
    tiles::SlotCursor at;
    for (int t = blockIdx.x; t < tiles_n; t += gridDim.x, at.next(stages)) {
      char* st = smem + at.slot * sbytes;
      if constexpr (kTma) {
        if (threadIdx.x != 0) continue;
        tiles::wait_phase(empty + at.slot, at.phase ^ 1u);
        tiles::mbar_expect(full + at.slot, 16 * tiles::box_floats(kC) * 4 + kC * 4 * kPre * 4);
        for (int g = 0; g < kGroups; ++g) {
          tiles::tma_load(st + g * gbytes, &seg_map, x0 + g * kPerGroup, t * 4, 0, full + at.slot);
        }
        tiles::tma_load(st + kGroups * gbytes, &base_map, 0, t * 4, 0, full + at.slot);
      } else {
        tiles::wait_phase(empty + at.slot, at.phase ^ 1u);
        constexpr int kSeg = kGroups * kC * 4 * tiles::kLineChunks;
        constexpr int kAll = kSeg + kC * 4 * (kPre / 4);
        for (int q = threadIdx.x; q < kAll; q += 128) {
          const float* src;
          char* dst;
          if (q < kSeg) {
            const int g = q / (kC * 4 * tiles::kLineChunks);
            const int r = q / tiles::kLineChunks % (kC * 4);
            const int k = q % tiles::kLineChunks;
            src = stream + (static_cast<long long>(r / 4) * kCap + t * 4 + r % 4) * kStride + x0 +
                  g * kPerGroup + 4 * k;
            dst = st + g * gbytes + r * tiles::kLineFloats * 4 + 16 * k;
          } else {
            const int r = (q - kSeg) / (kPre / 4);
            const int k = (q - kSeg) % (kPre / 4);
            src = stream + (static_cast<long long>(r / 4) * kCap + t * 4 + r % 4) * kStride + 4 * k;
            dst = st + kGroups * gbytes + r * kPre * 4 + 16 * k;
          }
          stage16(dst, src);
        }
        mbar_arrive_on_copies(full + at.slot);
      }
    }
  } else if (warp == 4 && threadIdx.x % 32 == 0) {
    tiles::SlotCursor at;
    for (int t = blockIdx.x; t < tiles_n; t += gridDim.x, at.next(stages)) {
      tiles::wait_phase(full + at.slot, at.phase);
      mbar_arrive(empty + at.slot);
    }
  }
}

template <int kMask>
__global__ void __launch_bounds__(tiles::kTileThreads, 1)
    roles(const __grid_constant__ CUtensorMap seg_map, const __grid_constant__ CUtensorMap base_map,
          const float* res, const float* w, const float* weights, float* out, int stages) {
  extern __shared__ __align__(16) float smem[];
  const Tile win{MegaMargins<Precision::kF32, false, Weights::kF32>{kStride, weights, nullptr, out,
                                                                   kC, nullptr}};
  tiles::run_tiles_f32s<Precision::kF32, Tile, kMask>(smem, &seg_map, &base_map, res, w, kCap, kC,
                                                      kPre, kSkip, stages, win);
}

template <class Launch>
float device_ms(Launch launch) {
  for (int i = 0; i < 3; ++i) launch();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::fprintf(stderr, "launch failed: %s\n", cudaGetErrorString(err));
    std::exit(1);
  }
  return ms / 20;
}

template <int kMask>
void time_roles(const CUtensorMap& seg, const CUtensorMap& base, const float* res, const float* w,
                const float* weights, float* out, int sms) {
  int stages = 0;
  size_t smem = 0;
  float* probe = nullptr;
  cudaMalloc(&probe, 16);
  tiles::plan_tiles(kC, kPre, kStride, probe, Tile::resident_bytes(kC), &stages, &smem);
  cudaFree(probe);
  cudaFuncSetAttribute(roles<kMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const float ms = device_ms([&] {
    roles<kMask><<<sms, tiles::kTileThreads, smem>>>(seg, base, res, w, weights, out, stages);
  });
  std::printf("{\"phase\": \"roles\", \"skip_work\": %d, \"stages\": %d, \"device_ms\": %.6f}\n",
              kMask, stages, ms);
}

}  // namespace

int main() {
  int sms = 0, optin = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
  const size_t n = static_cast<size_t>(kC) * kCap * kStride;
  std::vector<float> host(n);
  unsigned x = 12345u;
  for (size_t i = 0; i < n; ++i) {
    x = x * 1664525u + 1013904223u;
    host[i] = static_cast<float>(static_cast<int>(x >> 16) % 6000 - 3000) * 0.1f;
  }
  std::vector<float> wh(kEpoch * kFeatures), weights_h(kC * kFeatures), ones(kC, 1.0f);
  for (size_t i = 0; i < wh.size(); ++i) wh[i] = static_cast<float>((i * 37) % 101) / 101.0f - 0.5f;
  for (size_t i = 0; i < weights_h.size(); ++i) weights_h[i] = static_cast<float>(i % 7) - 3.0f;
  float *stream, *res, *w, *weights, *out;
  cudaMalloc(&stream, n * 4);
  cudaMalloc(&res, kC * 4);
  cudaMalloc(&w, wh.size() * 4);
  cudaMalloc(&weights, weights_h.size() * 4);
  cudaMalloc(&out, kCap * 4);
  cudaMemcpy(stream, host.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(res, ones.data(), kC * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(w, wh.data(), wh.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(weights, weights_h.data(), weights_h.size() * 4, cudaMemcpyHostToDevice);
  CUtensorMap seg, base;
  if (tiles::encode_map(&seg, stream, kC, kCap, kStride, tiles::kLineFloats) != cudaSuccess ||
      tiles::encode_map(&base, stream, kC, kCap, kStride, kPre) != cudaSuccess) {
    std::fprintf(stderr, "tensor map encode failed\n");
    return 1;
  }
  const int sbytes = tiles::stage_bytes(kC, kPre);
  const int stages_fit = (optin - 128 - 2 * tiles::kMaxStages * 8) / sbytes;
  for (const int stages : {2, 5, stages_fit < tiles::kMaxStages ? stages_fit : tiles::kMaxStages}) {
    const size_t smem = 128 + static_cast<size_t>(stages) * sbytes + 2 * tiles::kMaxStages * 8;
    for (const bool tma : {true, false}) {
      auto kernel = tma ? staging<true> : staging<false>;
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      const float ms = device_ms([&] { kernel<<<sms, 160, smem>>>(seg, base, stream, stages); });
      std::printf("{\"phase\": \"staging\", \"route\": \"%s\", \"stages\": %d, \"stage_bytes\": %d, "
                  "\"device_ms\": %.6f}\n", tma ? "tma" : "cp_async", stages, sbytes, ms);
    }
  }
  time_roles<0>(seg, base, res, w, weights, out, sms);
  time_roles<1>(seg, base, res, w, weights, out, sms);
  time_roles<2>(seg, base, res, w, weights, out, sms);
  time_roles<4>(seg, base, res, w, weights, out, sms);
  time_roles<3>(seg, base, res, w, weights, out, sms);
  time_roles<5>(seg, base, res, w, weights, out, sms);
  time_roles<6>(seg, base, res, w, weights, out, sms);
  time_roles<7>(seg, base, res, w, weights, out, sms);
  return 0;
}
"""


def main() -> int:
    try:
        import torch
    except ImportError:
        torch = None
    if torch is None or not torch.cuda.is_available():
        print("chip_tiles: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.exists(SOURCE):
        print(f"chip_tiles: {SOURCE} not found: run from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from eeg_dataanalysispackage_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="chip_tiles_") as work:
        src = os.path.join(work, "probe.cu")
        exe = os.path.join(work, "probe")
        with open(src, "w") as f:
            f.write(PROBE.replace("@SOURCE@", SOURCE))
        build = subprocess.run([cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                                "-std=c++17", "-O3", "-o", exe, src],
                               capture_output=True, text=True)
        if build.returncode != 0:
            print(build.stdout + build.stderr, file=sys.stderr)
            return 1
        run = subprocess.run([exe], capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
    for line in run.stdout.splitlines():
        print(json.dumps({**json.loads(line), "windows": 32_768, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
