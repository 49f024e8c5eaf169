// The tile engine of the serve megakernel on float32 samples at the main
// path's 512 / 16 (serve_mega.cu's serve_mega_kernel_tiles: K5-f32s,
// K5-int8-f32s, K5-int4-f32s, K6-f32s, K6-w8-f32s, K6-w4-f32s), the second
// design beside run_windows (window_features.cuh), which keeps the launches
// of few windows a multiprocessor (ops/serve_mega_cuda.py mega_design picks
// one per launch; the launcher takes the pick and refuses a launch outside
// the picked design's reach, it never runs the other one).
//
// Replaces, with run_windows, the TPU kernels
// eeg_dataanalysispackage_tpu/ops/serve_mega.py:259 (_make_mega_kernel)
// and :484 (_mega_multi_program) on float32 requests.
//
// What bounds it on the H100: bytes. A window of 3 float32 channels reads
// 3 x 612 samples (7.3 KB) for 49 kFLOP: at 32,768 windows 0.0719 ms at
// 3.35 TB/s against 0.024 ms of float32 FMAs at 67 TFLOP/s. run_windows
// keeps one window a block in flight behind a chain of block-wide barriers
// (four blocks a multiprocessor), so its time is that chain's, not the
// bytes' (PERF.md section 6). Here one persistent block a multiprocessor
// (736 threads, __launch_bounds__(736, 1): at most 88 registers a thread)
// walks tiles of kWindows = 4 windows (tile = blockIdx.x, + gridDim.x, ...)
// through a ring of 2 to 6 stages in shared memory (as many as fit beside
// the epilogue's resident state: 5 at 3 channels and a 100-sample
// baseline, 4 beside K6's f32 stack), its 23 warps in four roles that hand
// work on through mbarriers, with no block-wide barrier in the loop:
//   - warp 0, lane 0, stages: a tile is 17 TMA requests on tensor maps
//     over the stream viewed as (channels, capacity, stride) (a window
//     starts at row * stride): each group g of 32 analysis samples as a box
//     of (36 samples, 4 windows, channels) from the 16-byte boundary at or
//     before the group's first sample (a TMA box must start on one: the
//     analysis segment starts (pre + skip) % 4 samples past it, 3 on the
//     main path), each box on a 128-byte boundary of the stage, and the
//     baseline's round4(pre) samples as one box. Samples past a window's
//     stride or the launch's rows arrive as zeros (the map's bounds). It
//     waits for the stage's `empty` barrier before a refill.
//   - warps 1..6 centre, a stage ahead of the contraction: a warp takes two
//     (window, channel) rows of a tile; each row's mean as window_means
//     sums it (lane l the samples l, l + 32, ... in double, a butterfly,
//     the division by pre; the two rows' chains interleaved), then z =
//     __fsub_rn(__fmul_rn(x, res), mean) in place in the stage, four
//     samples a lane as a float4 (a box row's samples outside its group
//     become values no one reads).
//   - warps 7..14 contract: warp p owns the pair of groups 2p, 2p + 1, and
//     lane (h, m, kb) group 2p + h of window m and the coefficients 4kb ..
//     4kb + 3 of all (up to 3) channels: a register tile of 3 rows x 4
//     coefficients, fed by 3 + 4 float4 loads for 48 FMAs. The four
//     samples of a step are taken from two float4 chunks at the segment's
//     offset (a template argument, so the pick is registers alone). W (512
//     x 16, 32 KB) stays resident in shared memory, a 64-byte pad after
//     each group's rows so that the two groups read at once fall in
//     different banks; at 3 channels the lanes h = 1 take the channels in
//     the order 1, 2, 0 for the same reason. Each group is one fmaf chain
//     from 0.0f in ascending j with the held W values; the pair's partial
//     c_{2p} + c_{2p+1} is run_windows' shfl_xor 16 sum, written to the
//     window's RingSmem::part row p: run_windows' partials, bit for bit.
//   - warps 15..22 finish, one warp a window, two warps a window on
//     alternate tiles (each tile's partials in one of two buffers):
//     MegaMargins::epilogue through serve_mega.cu's TileMargins, which
//     runs reduce_and_norm on those partials (y = ((0 + s_0) + s_1) + ... +
//     s_7, the squares and butterflies of run_windows' warp 0, max(sqrt,
//     1e-30)), then the division, the quantize step and the dot in
//     run_windows' order, on the weights or tenant stack held in shared
//     memory (K6's lane read a tile ahead). So every margin and every
//     feature behind it equals run_windows' and K1-f32's rows bit for bit,
//     whatever the design, the tile or the grid.
//
// Reach: channels 1..3, round4(pre) <= 256 (a box dimension), a stride of
// a multiple of 4 samples and a 16-byte aligned stream (the tensor map's
// strides and base), and two stages beside the epilogue's state in the
// block's shared memory (tiles_smem_bytes); every other launch stays on
// run_windows.
//
// What holds it (PERF.md section 6, PR 28, chip_tiles.py; H100 80GB HBM3
// at 700 W): the staging alone streams 32,768 windows in 0.094-0.096 ms
// (2.5 TB/s; TMA and cp.async from producer warps alike), the kernel takes
// 0.119 ms there (0.122-0.132 in chip_compare.py); without the centring's
// work 0.103, without the contraction's 0.107: a stage stays held from its
// copies through those two roles, which share the multiprocessor with the
// copies' landing.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "window_features.cuh"
#include "window_features_any.cuh"

namespace window_features {
namespace tiles {

constexpr int kWindows = 4;                 // windows a tile
constexpr int kMaxChannels = 3;             // the contraction's register tile's rows
// A group box's row: the 32 samples of a group from the 16-byte boundary at
// or before its first one, plus the up to 3 samples before it: 36 floats,
// 144 bytes, so a box's rows start in different bank groups.
constexpr int kLineFloats = kPerGroup + 4;
constexpr int kLineChunks = kLineFloats / 4;  // 9 float4s
constexpr int kAlign = 128;                 // a TMA destination's alignment
constexpr int kPartBuffers = 2;  // the partials of two tiles: one written, one finished
constexpr int kCentreWarps = 6;  // 2 rows each of a tile's 12 at 3 channels
constexpr int kContractWarps = kGroups / 2;  // a pair of groups a warp
// a window's epilogue on one warp, two warps a window: the tiles of even
// and of odd index (each its own partials buffer)
constexpr int kEpilogueWarps = kPartBuffers * kWindows;
constexpr int kCentreWarp0 = 1;
constexpr int kContractWarp0 = kCentreWarp0 + kCentreWarps;
constexpr int kEpilogueWarp0 = kContractWarp0 + kContractWarps;
constexpr int kTileThreads = 32 * (kEpilogueWarp0 + kEpilogueWarps);  // 736
// W resident in shared memory a group of 32 rows at a time, each group
// followed by 16 floats of padding, so the two groups a warp reads at once
// (2p and 2p + 1) sit 64 bytes apart in the banks.
constexpr int kWGroupFloats = kPerGroup * kFeatures + kFeatures;
constexpr int kMinStages = 2;
constexpr int kMaxStages = 6;
// full, zready, empty a stage; pfull, pfree a partials buffer
constexpr int kBarriers = 3 * kMaxStages + 2 * kPartBuffers;
static_assert(kContractWarps == kWarps, "a window's partials: one row a pair of groups");
static_assert(kWindows == 4, "a lane's window is lane / 4 % 4");

// Floats of one group box (channels x kWindows window rows of kLineFloats),
// and its stride in a stage: TMA writes to 128-byte aligned destinations.
__host__ __device__ inline int box_floats(int channels) {
  return channels * kWindows * kLineFloats;
}
__host__ __device__ inline int group_floats(int channels) {
  return (box_floats(channels) + kAlign / 4 - 1) / (kAlign / 4) * (kAlign / 4);
}

// Bytes of one stage: the 16 group boxes, then the baseline box, rounded
// up to kAlign.
__host__ __device__ inline int stage_bytes(int channels, int pre) {
  const int seg = kGroups * group_floats(channels) * static_cast<int>(sizeof(float));
  const int base = channels * kWindows * round4(pre) * static_cast<int>(sizeof(float));
  return (seg + base + kAlign - 1) / kAlign * kAlign;
}

// Floats of one window's partials and row (RingSmem::part, then feat).
__host__ __device__ inline int window_floats(int channels) {
  return (kWarps + 1) * channels * kFeatures;
}

// Offsets, from the kAlign-aligned base: the stages, W, the partials, res,
// the barriers; the block asks for kAlign more to align its base.
__host__ __device__ inline int w_offset(int channels, int pre, int stages) {
  return stages * stage_bytes(channels, pre);
}
__host__ __device__ inline int parts_offset(int channels, int pre, int stages) {
  return w_offset(channels, pre, stages) + kGroups * kWGroupFloats * static_cast<int>(sizeof(float));
}
__host__ __device__ inline int res_offset(int channels, int pre, int stages) {
  return parts_offset(channels, pre, stages) +
         kPartBuffers * kWindows * window_floats(channels) * static_cast<int>(sizeof(float));
}
// The epilogue's resident region (the weights or the tenant stack, which
// the Windows of the launch stages there: `resident` bytes), then the
// barriers.
__host__ __device__ inline int resident_offset(int channels, int pre, int stages) {
  return (res_offset(channels, pre, stages) + channels * static_cast<int>(sizeof(float)) + 15) &
         ~15;
}
__host__ __device__ inline int bars_offset(int channels, int pre, int stages, int resident) {
  return (resident_offset(channels, pre, stages) + resident + 7) & ~7;
}

// The shared memory a block asks for at `stages` stages
// (ops/serve_mega_cuda.py tiles_smem_bytes mirrors it).
inline size_t tiles_smem_bytes(int channels, int pre, int stages, int resident) {
  return static_cast<size_t>(kAlign) + bars_offset(channels, pre, stages, resident) +
         kBarriers * sizeof(uint64_t);
}

// Check a launch against the design's reach and pick its stages: the most
// up to kMaxStages that fit the block's opt-in limit. cudaErrorInvalidValue
// outside the reach.
inline cudaError_t plan_tiles(int channels, int pre, int stride, const void* stream,
                              int resident, int* stages, size_t* smem) {
  if (channels < 1 || channels > kMaxChannels || round4(pre) > 256 || stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(stream) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int s = kMaxStages; s >= kMinStages; --s) {
    if (tiles_smem_bytes(channels, pre, s, resident) <= static_cast<size_t>(optin)) {
      *stages = s;
      *smem = tiles_smem_bytes(channels, pre, s, resident);
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (nothing
// more to link); null where the driver has none.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over the (channels, capacity, stride) float32 stream whose
// box is (box_j samples, kWindows windows, every channel). Samples past a window's
// stride or the last window read as zeros. A box's first sample must lie on
// a 16-byte boundary (the H100 raises an illegal instruction otherwise).
inline cudaError_t encode_map(CUtensorMap* map, const void* stream, int channels, int capacity,
                              int stride, int box_j) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(stride),
                              static_cast<cuuint64_t>(capacity),
                              static_cast<cuuint64_t>(channels)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride) * sizeof(float),
                                 static_cast<cuuint64_t>(capacity) * stride * sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_j), kWindows,
                             static_cast<cuuint32_t>(channels)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(stream),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An arrival on `bar` announcing `bytes` that TMA requests will deliver.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// The box of `map` at (x, y, z) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_address(bar))
      : "memory");
}

// Wait for the phase of `bar` of parity `parity` to complete: try_wait in
// a loop, with no suspend-time hint (the waits here are short and
// frequent).
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      "  .reg .pred done;\n"
      "WAIT_%=:\n"
      "  mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "  @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

// A warp's arrival: its lanes' shared-memory accesses so far ordered
// before lane 0's arrival on `bar`.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A stage's counters: its slot and the parity of its round, advanced tile
// by tile.
struct SlotCursor {
  int slot = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// The baseline means of rows r[0..1] of a stage (a row r = channel *
// kWindows + window; r[1] < 0: none, row r[0] read again and dropped), by
// one warp, in window_means' order: lane l sums the samples l, l + 32, ...
// < pre in double, then a butterfly, then the division by pre. The two
// rows' chains run interleaved.
__device__ __forceinline__ void row_means(const float* base, int bp, int pre, const float* res,
                                          const int (&r)[2], float (&mean)[2], int lane) {
  const int r1 = r[1] < 0 ? r[0] : r[1];
  const float* b0 = base + r[0] * bp;
  const float* b1 = base + r1 * bp;
  const float rc0 = res[r[0] / kWindows];
  const float rc1 = res[r1 / kWindows];
  double sum[2] = {0.0, 0.0};
  for (int j = lane; j < pre; j += 32) {
    sum[0] += static_cast<double>(__fmul_rn(b0[j], rc0));
    sum[1] += static_cast<double>(__fmul_rn(b1[j], rc1));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], off);
    sum[1] += __shfl_xor_sync(0xffffffffu, sum[1], off);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) mean[u] = static_cast<float>(sum[u] / static_cast<double>(pre));
}

// A row's float4 chunks a centring lane takes: lane l the chunks l, l +
// 32, ... < 144 of the 16 group boxes' rows (chunk u: box u / 9, chunk u %
// 9 of the row), as float offsets from the row's place in box 0 (-1: none).
constexpr int kCentreChunks = kGroups * kLineChunks;
constexpr int kCentreSteps = (kCentreChunks + 31) / 32;

__device__ __forceinline__ void centre_offsets(int channels, int lane,
                                               int (&offsets)[kCentreSteps]) {
#pragma unroll
  for (int v = 0; v < kCentreSteps; ++v) {
    const int u = lane + 32 * v;
    offsets[v] = u < kCentreChunks
                     ? (u / kLineChunks) * group_floats(channels) + (u % kLineChunks) * 4
                     : -1;
  }
}

// Centre row r of a stage in place: z = __fsub_rn(__fmul_rn(x, res),
// mean) for the 16 group boxes' rows of window r % kWindows, channel r /
// kWindows. The samples of a row past its group's 32 become values no one
// reads.
__device__ __forceinline__ void centre_row(float* seg, const int (&offsets)[kCentreSteps], int r,
                                           float rc, float mean) {
  float* row = seg + r * kLineFloats;
#pragma unroll
  for (int v = 0; v < kCentreSteps; ++v) {
    if (offsets[v] < 0) break;
    float4* p = reinterpret_cast<float4*>(row + offsets[v]);
    float4 x = *p;
    x.x = __fsub_rn(__fmul_rn(x.x, rc), mean);
    x.y = __fsub_rn(__fmul_rn(x.y, rc), mean);
    x.z = __fsub_rn(__fmul_rn(x.z, rc), mean);
    x.w = __fsub_rn(__fmul_rn(x.w, rc), mean);
    *p = x;
  }
}

// Sample e (0..3) of the four at offset kO into the pair of float4 chunks
// (a, b).
template <int kO>
__device__ __forceinline__ float shifted(const float4& a, const float4& b, int e) {
  return e + kO < 4 ? lane_of(a, e + kO) : lane_of(b, e + kO - 4);
}

// One group's chains for lane (m, kb): acc[u][kk] = the fmaf chain from
// 0.0f over the group's 32 samples, ascending j, of channel u's centred
// row of window m with W[:, 4kb + kk] (channels past the launch's read
// the last one again; the caller stores nothing of them). Sample i of the
// group sits at float kO + i of its box row (kO: the analysis segment's
// offset from its 16-byte boundary), read as the row's 9 float4 chunks.
template <int kO>
__device__ __forceinline__ void group_chains(const float* seg, const float* W, int channels,
                                             int g, int m, int kb, int rot,
                                             float (&acc)[kMaxChannels][4]) {
  const float* box = seg + g * group_floats(channels);
  const float4* z[kMaxChannels];
#pragma unroll
  for (int u = 0; u < kMaxChannels; ++u) {
    const int c = u < channels ? (u + rot) % channels : channels - 1;
    z[u] = reinterpret_cast<const float4*>(box + (c * kWindows + m) * kLineFloats);
  }
  const float4* wrow = reinterpret_cast<const float4*>(W + g * kWGroupFloats) + kb;
#pragma unroll
  for (int u = 0; u < kMaxChannels; ++u) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc[u][kk] = 0.0f;
  }
  float4 cur[kMaxChannels];
#pragma unroll
  for (int u = 0; u < kMaxChannels; ++u) cur[u] = z[u][0];
#pragma unroll
  for (int q = 0; q < kPerGroup / 4; ++q) {
    float4 next[kMaxChannels];
#pragma unroll
    for (int u = 0; u < kMaxChannels; ++u) {
      if constexpr (kO == 0) {
        next[u] = cur[u];
      } else {
        next[u] = z[u][q + 1];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 wv = wrow[(4 * q + e) * (kFeatures / 4)];
#pragma unroll
      for (int u = 0; u < kMaxChannels; ++u) {
        const float x = kO == 0 ? lane_of(cur[u], e) : shifted<kO>(cur[u], next[u], e);
        acc[u][0] = fmaf(x, wv.x, acc[u][0]);
        acc[u][1] = fmaf(x, wv.y, acc[u][1]);
        acc[u][2] = fmaf(x, wv.z, acc[u][2]);
        acc[u][3] = fmaf(x, wv.w, acc[u][3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxChannels; ++u) {
      if constexpr (kO == 0) {
        if (q + 1 < kPerGroup / 4) cur[u] = z[u][q + 1];
      } else {
        cur[u] = next[u];
      }
    }
  }
}

// The contraction warps' walk (warp `pair` of them), for the segment
// offset kO (-1: the hand-offs alone, no chains; run_tiles_f32s'
// kSkipWork): lane (h, m, kb) = (lane / 16, lane / 4 % 4, lane % 4) takes
// group 2 * pair + h of window m, coefficients 4kb .. 4kb + 3; the pair's
// partial c_{2p} + c_{2p+1} is run_windows' shfl_xor 16 sum, stored by
// lanes h = 0 into the tile's partials buffer (tile parity). At 3
// channels the lanes h = 1 take the channels in the order 1, 2, 0, so the
// two groups' rows read at once lie 64 bytes apart in the banks (their
// boxes start on 128-byte boundaries, 144-byte rows): register tile row u
// of lane h holds channel (u + h) % 3.
template <int kO>
__device__ __forceinline__ void contract_tiles(char* smem, int sbytes, const float* W,
                                               float* parts, uint64_t* zready, uint64_t* empty,
                                               uint64_t* pfull, uint64_t* pfree, int tiles,
                                               int stages, int channels, int pair, int lane) {
  const int h = lane / 16;
  const int m = lane / 4 % kWindows;
  const int kb = lane % 4;
  const int nfeat = channels * kFeatures;
  const bool rotate = channels == kMaxChannels;
  SlotCursor at;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, at.next(stages), ++it) {
    wait_phase(zready + at.slot, at.phase);
    const float* seg = reinterpret_cast<const float*>(smem + at.slot * sbytes);
    float s[kMaxChannels][4] = {};
    if constexpr (kO >= 0) {
      group_chains<kO>(seg, W, channels, 2 * pair + h, m, kb, rotate ? h : 0, s);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float t[kMaxChannels];
#pragma unroll
      for (int u = 0; u < kMaxChannels; ++u) t[u] = __shfl_xor_sync(0xffffffffu, s[u][kk], 16);
      // channel u of lane h = 0 meets the partner's row u, or its row
      // (u + 2) % 3 where the partner rotated
#pragma unroll
      for (int u = 0; u < kMaxChannels; ++u) {
        s[u][kk] += rotate ? t[(u + kMaxChannels - 1) % kMaxChannels] : t[u];
      }
    }
    warp_arrive(empty + at.slot, lane);  // the slot's samples read
    const int buf = it % kPartBuffers;
    const unsigned round = static_cast<unsigned>(it / kPartBuffers) & 1u;
    wait_phase(pfree + buf, round ^ 1u);  // that buffer's tile finished
    float* pm = parts + (buf * kWindows + m) * window_floats(channels) + pair * nfeat + 4 * kb;
#pragma unroll
    for (int u = 0; u < kMaxChannels; ++u) {
      if (h == 0 && u < channels) {
        *reinterpret_cast<float4*>(pm + u * kFeatures) =
            make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
      }
    }
    warp_arrive(pfull + buf, lane);
  }
}

// Walk this block's tiles by roles (see the notes above). rows: the
// launch's windows, each starting on a 16-byte boundary. The block's grid
// is at most its tiles, so every block has one. `Windows` (serve_mega.cu
// TileMargins) supplies resident_bytes(channels) (host and device), the
// bytes it keeps in shared memory; stage(dst, t, threads), thread t of
// threads' share of copying them there, returning the epilogue's state;
// prefetch(row), a window's global read issued a tile ahead (its lane);
// and epilogue(state, row, s, lane, slot, prefetched), which warp slot of
// the epilogue warps runs for each finished window. kSkipWork, for
// chip_tiles.py's measurements alone (0 in every kernel): a mask of roles
// that hand their stages on without doing their work (1 the centring, 2
// the contraction, 4 the epilogue).
template <Precision P, class Windows, int kSkipWork = 0>
__device__ __forceinline__ void run_tiles_f32s(void* smem_raw, const CUtensorMap* seg_map,
                                               const CUtensorMap* base_map,
                                               const float* __restrict__ res,
                                               const float* __restrict__ w, int rows,
                                               int channels, int pre, int skip, int stages,
                                               const Windows& win) {
  const unsigned raw = smem_address(smem_raw);
  char* smem = static_cast<char*>(smem_raw) + ((kAlign - (raw & (kAlign - 1))) & (kAlign - 1));
  const int sbytes = stage_bytes(channels, pre);
  float* W = reinterpret_cast<float*>(smem + w_offset(channels, pre, stages));
  float* parts = reinterpret_cast<float*>(smem + parts_offset(channels, pre, stages));
  float* rs = reinterpret_cast<float*>(smem + res_offset(channels, pre, stages));
  char* resident = smem + resident_offset(channels, pre, stages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + bars_offset(channels, pre, stages, Windows::resident_bytes(channels)));
  uint64_t* full = bars;
  uint64_t* zready = bars + kMaxStages;
  uint64_t* empty = bars + 2 * kMaxStages;
  uint64_t* pfull = bars + 3 * kMaxStages;
  uint64_t* pfree = pfull + kPartBuffers;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bp = round4(pre);
  // the analysis segment's offset from the 16-byte boundary its boxes start at
  const int offset = (pre + skip) % 4;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(zready + s, kCentreWarps);
      mbar_init(empty + s, kContractWarps);
    }
    for (int b = 0; b < kPartBuffers; ++b) {
      mbar_init(pfull + b, kContractWarps);
      mbar_init(pfree + b, kEpilogueWarps / kPartBuffers);
    }
  }
  for (int i = tid; i < kEpoch * kFeatures; i += kTileThreads) {
    W[i / (kPerGroup * kFeatures) * kWGroupFloats + i % (kPerGroup * kFeatures)] = w[i];
  }
  for (int c = tid; c < channels; c += kTileThreads) rs[c] = res[c];
  const auto state = win.stage(resident, tid, kTileThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();  // the barriers initialized, W, res and the epilogue's copies in place
  const int tiles = (rows + kWindows - 1) / kWindows;
  const int gbytes = group_floats(channels) * static_cast<int>(sizeof(float));

  if (warp == 0) {
    if (lane == 0) {
      const unsigned bytes =
          static_cast<unsigned>(kGroups * box_floats(channels)) * static_cast<unsigned>(sizeof(float)) +
          static_cast<unsigned>(channels * kWindows * bp) * static_cast<unsigned>(sizeof(float));
      SlotCursor at;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, at.next(stages)) {
        wait_phase(empty + at.slot, at.phase ^ 1u);
        // the centring's stores into the slot before the copies' writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(full + at.slot, bytes);
        char* st = smem + at.slot * sbytes;
        for (int g = 0; g < kGroups; ++g) {
          tma_load(st + g * gbytes, seg_map, pre + skip - offset + g * kPerGroup, t * kWindows, 0,
                   full + at.slot);
        }
        tma_load(st + kGroups * gbytes, base_map, 0, t * kWindows, 0, full + at.slot);
      }
    }
  } else if (warp < kContractWarp0) {
    const int cw = warp - kCentreWarp0;
    const int nrows = channels * kWindows;
    int offsets[kCentreSteps];
    centre_offsets(channels, lane, offsets);
    SlotCursor at;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, at.next(stages)) {
      wait_phase(full + at.slot, at.phase);
      float* seg = reinterpret_cast<float*>(smem + at.slot * sbytes);
      const float* base = seg + kGroups * group_floats(channels);
      for (int r0 = cw; !(kSkipWork & 1) && r0 < nrows; r0 += 2 * kCentreWarps) {
        const int r[2] = {r0, r0 + kCentreWarps < nrows ? r0 + kCentreWarps : -1};
        float mean[2];
        row_means(base, bp, pre, rs, r, mean, lane);
        centre_row(seg, offsets, r[0], rs[r[0] / kWindows], mean[0]);
        if (r[1] >= 0) centre_row(seg, offsets, r[1], rs[r[1] / kWindows], mean[1]);
      }
      warp_arrive(zready + at.slot, lane);
    }
  } else if (warp < kEpilogueWarp0) {
    const int pair = warp - kContractWarp0;
    if constexpr (kSkipWork & 2) {
      contract_tiles<-1>(smem, sbytes, W, parts, zready, empty, pfull, pfree, tiles, stages,
                         channels, pair, lane);
    } else {
      switch (offset) {
        case 0:
          contract_tiles<0>(smem, sbytes, W, parts, zready, empty, pfull, pfree, tiles, stages,
                            channels, pair, lane);
          break;
        case 1:
          contract_tiles<1>(smem, sbytes, W, parts, zready, empty, pfull, pfree, tiles, stages,
                            channels, pair, lane);
          break;
        case 2:
          contract_tiles<2>(smem, sbytes, W, parts, zready, empty, pfull, pfree, tiles, stages,
                            channels, pair, lane);
          break;
        default:
          contract_tiles<3>(smem, sbytes, W, parts, zready, empty, pfull, pfree, tiles, stages,
                            channels, pair, lane);
          break;
      }
    }
  } else {
    // epilogue warp e finishes window e % kWindows of the tiles of parity
    // e / kWindows (partials buffer e / kWindows)
    const int e = warp - kEpilogueWarp0;
    const int m = e % kWindows;
    const int half = e / kWindows;
    const int step = kPartBuffers * gridDim.x;
    int t = blockIdx.x + half * gridDim.x;
    int ahead = t < tiles && t * kWindows + m < rows ? win.prefetch(t * kWindows + m) : 0;
    for (int it = half; t < tiles; t += step, it += kPartBuffers) {
      const int row = t * kWindows + m;
      const int mine = ahead;
      const int next = t + step;
      if (next < tiles && next * kWindows + m < rows) ahead = win.prefetch(next * kWindows + m);
      wait_phase(pfull + half, static_cast<unsigned>(it / kPartBuffers) & 1u);
      if (!(kSkipWork & 4) && row < rows) {
        RingSmem v{};
        v.part = parts + (half * kWindows + m) * window_floats(channels);
        v.feat = v.part + kWarps * channels * kFeatures;
        win.epilogue(state, row, v, lane, e, mine);
      }
      warp_arrive(pfree + half, lane);
    }
  }
}

}  // namespace tiles
}  // namespace window_features
