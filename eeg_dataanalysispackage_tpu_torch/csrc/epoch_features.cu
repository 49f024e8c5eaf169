// Epoch features for Hopper (sm_90a): float32 epochs that the host already
// cut and baseline-corrected -> L2-normalized Daubechies features.
//
// Replaces the TPU kernel eeg_dataanalysispackage_tpu/ops/dwt_pallas.py:44
// (_make_kernel, wrapped by epoch_features_pallas at :65, pallas_call
// :104). Per epoch b of (B, C, T) float32 epochs, with W the (n, K) cascade
// matrix of the analysis window [skip, skip + n):
//   y[c*K + k] = sum_j x[b, c, skip + j] * W[j, k],  j < n, k < K
//   out[b]     = y / max(||y||, 1e-30)
// in f32 FMAs on CUDA cores (no tensor cores, no TF32); an all-zero epoch
// gives an all-zero row. The Pallas kernel DMAs a (128, C, T) tile into
// VMEM and takes each channel's product on the MXU, padding B to the tile;
// here nothing is padded and B = 0 launches nothing.
//
// Bound on the H100: bytes. On the main path (n = 512, K = 16, C = 3,
// T = 750) an epoch reads its C*n window floats once and writes its C*K
// features: 6,336 B against 2*C*n*K = 49 kFLOP. At 32,768 epochs that is
// 207.6 MB, 0.062 ms at 3.35 TB/s, against 1.61 GFLOP, 0.024 ms at
// 67 TFLOP/s (f32, no tensor cores).
//
// The contraction is a tall-skinny GEMM, (B*C, n) x (n, K); two kernels
// compute it, each with its summation order fixed by its lane mapping.
//
// The ring kernel (epoch_features_kernel; every size, and the main path
// from 2,049 epochs or four channels): blocks of 16 warps, one resident
// block a multiprocessor, each warp walking its own pairs of epochs. Lanes
// 0-15 take one epoch of the pair and 16-31 the other; lane s contracts
// the samples j = s, s + 16, ... of three channels (a channel group)
// against 16 coefficients, 48 sums in registers, each in sample order.
// The epoch's 16 lanes then add them by recursive halving (shfl_xor 8, 4,
// 2, 1), so lane s holds three of the 48 sums, and the norm's squares add
// by a butterfly over the same lanes: no partial sum and no norm crosses
// warps. A wider montage, or K > 16, takes passes of three channels by 16
// coefficients; their values are written as they come, and once the norm
// is known the epoch's lanes rescale the row in place (each pass's squares
// in float32, the passes' sums in double: at 64 channels by 745
// coefficients one float32 chain of 47,680 squares left rows 4.4e-6 from
// the plain version, past the 2e-6 of tests/test_torch_cuda.py).
//
// Staging: a warp's ring holds two stages of 128 window samples of its six
// rows, one contracted while the next is in flight. Each row's stage is
// the 16-byte chunks that cover its samples at any offset (33 at most,
// 528 bytes; runs of 64 samples, in a deeper ring, were slower on the
// H100), fetched by one 1-D bulk copy of the TMA
// unit (cp.async.bulk, any 16-byte-aligned run, no tensor map) that
// completes on the slot's mbarrier; the reads apply the row's offset
// within its first chunk. A tensor map does not serve: its global strides
// must be multiples of 16 bytes, and a 750-float row is 3,000 bytes. The
// copies are cut to the tensor's 16-byte-aligned inside, and a row's floats
// in the chunks at either end of the tensor are copied one by one. On the
// main path W (32 KB, laid out [quad][j] by the wrapper) arrives by one
// bulk copy per block, so the block meets at one barrier (the barriers'
// initialization), and a warp waits only on its own slots. Other sizes
// take W's rows of the stage, in 16-coefficient tiles, into each slot with
// 16-byte cp.async copies, and meet at one block barrier a stage. Shared
// memory grows with none of n, K and C: no launch is refused for its size.
//
// The two epochs of a warp are four epochs (16*C*T bytes) apart, so their
// rows share their offset within a chunk, and epoch 1's rows sit 16 banks
// after epoch 0's: a warp's sample loads take one shared-memory wavefront.
//
// The small kernel (epoch_features_kernel_small; the main path's launches
// of up to 2,048 epochs of at most three channels, which the ring kernel's
// fixed start-up, mbarrier setup and W's 32 KB before the first stage,
// made slower than the one-epoch-per-block kernel it replaces): see its
// note below.
//
// What sets the pace on the H100: at 32,768 epochs the stream of bulk
// copies, which like any read of these windows (a third of each row
// skipped, rows 3,000 bytes apart) runs below the card's peak rate
// (chip_smoke.py's window_read_ms), then the shared-memory traffic of W's
// float4 loads, which the 16 warps a multiprocessor (128 registers each:
// the 48 sums) only partly hide. On small launches, the chain of one
// launch: the loads' round trip, the lanes' halving, the warps' sum and
// the norm.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "window_features.cuh"

namespace {

using window_features::commit_async;
using window_features::copy_async16;
using window_features::kChunkBytes;
using window_features::wait_async;

constexpr int kLanes = 16;                           // lanes that split an epoch's samples
constexpr int kRows = 3;                             // channels a lane contracts together
constexpr int kTile = 16;                            // coefficients a pass computes
constexpr int kValues = kRows * kTile;               // 48 sums a lane accumulates
constexpr int kHeld = kValues / kLanes;              // 3 of them each lane keeps after the reduce
constexpr int kQuads = kTile / 4;                    // float4s of a W row's tile
constexpr int kStageSamples = 128;                   // window samples a ring stage holds
constexpr int kRowChunks = kStageSamples / 4 + 1;    // 33 chunks cover them at any offset
constexpr int kRowFloats = kRowChunks * 4;           // 132
constexpr int kPairRows = 2 * kRows;                 // rows of a warp's two epochs
constexpr int kWarpFloats = kPairRows * kRowFloats + 4;  // 796; epoch 1 starts 16 banks on
constexpr int kWTileFloats = kStageSamples * kTile;  // a stage's W tile (sizes off the main path)
constexpr int kStages = 2;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMainEpoch = 512;     // the main path's n
constexpr int kMainFeatures = 16;   // and K
constexpr int kBarFloats = (kWarps * kStages + 2) * 2;  // ring barriers and W's (8 B each)
constexpr int kSmallPart = 64;                           // the small kernel's warps' window parts
constexpr int kSmallWarps = kMainEpoch / kSmallPart;     // and its warps: a part each
constexpr int kSmallPairs = 1024;   // the most pairs of epochs the small kernel takes
constexpr int kSingleEpochs = 384;  // the most epochs it takes one a block

struct Geometry {
  int epochs;
  int channels;
  int length;
  int skip;
  int n;
  int features;
  int w_columns;  // of w: K rounded up to kTile (zero columns)
  int pairs;      // 4 * ceil(epochs / 8)
  int rounds;     // pairs a warp takes in turn, at most
};

// Floats from the start of a warp's region to the slot of its epoch e's
// channel c of the group.
__device__ __forceinline__ int row_slot(int e, int c) {
  return (e * kRows + c) * kRowFloats + e * 4;
}

// Epoch e (0 or 1) of pair p: pairs 4g .. 4g + 3 take epochs 8g .. 8g + 7,
// each its epochs four apart.
__device__ __forceinline__ long long pair_epoch(int p, int e) {
  return static_cast<long long>(p >> 2) * 8 + (p & 3) + 4 * e;
}

// The start of epoch b's channel's window, or nullptr where the row lies
// past the batch or the montage.
__device__ __forceinline__ const float* window_start(const float* x, const Geometry& g, int p,
                                                     long long b, int chan) {
  if (p >= g.pairs || b >= g.epochs || chan >= g.channels) return nullptr;
  return x + (b * g.channels + chan) * g.length + g.skip;
}

__device__ __forceinline__ int chunk_offset(const float* a) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(a) & (kChunkBytes - 1)) / 4;
}

// A warp's walk: round r (its pair), channel group cg, coefficient tile kt,
// stage t of the window.
struct Cursor {
  int r = 0;
  int cg = 0;
  int kt = 0;
  int t = 0;
  __device__ __forceinline__ void advance(int stages, int tiles, int groups) {
    if (++t < stages) return;
    t = 0;
    if (++kt < tiles) return;
    kt = 0;
    if (++cg < groups) return;
    cg = 0;
    ++r;
  }
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)),
               "r"(arrivals)
               : "memory");
}

// Arrive on `bar`, announcing `bytes` that bulk copies will deliver to it.
__device__ __forceinline__ void barrier_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      "  .reg .pred done;\n"
      "WAIT_%=:\n"
      "  mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "  @!done bra WAIT_%=;\n"
      "}\n" ::"r"(shared_address(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// Stage js (len = its window samples) of one row, by the row's lane: the
// 16-byte chunks that cover the samples, from `chunk0` (the chunk holding
// the window's first sample, o floats into it), as one bulk copy into
// `dst`, then the lane's arrival on the slot's barrier with the bytes to
// come. Chunk bytes outside [xbeg, xend) are not copied: the copy is cut to
// the tensor's 16-byte-aligned inside, and a row's floats in the chunks at
// either end of the tensor are copied one by one (they never arrive late:
// the arrival releases them).
__device__ __forceinline__ void stage_row(const char* chunk0, int o, int js, int len,
                                          float* dst, uint64_t* bar, const char* xbeg,
                                          const char* xend) {
  unsigned bytes = 0;
  if (chunk0 != nullptr) {
    const char* lo = chunk0 + static_cast<ptrdiff_t>(js) * kStageSamples * 4;
    const char* hi = lo + (o + len + 3) / 4 * kChunkBytes;
    const char* in_lo = xbeg + (kChunkBytes - reinterpret_cast<uintptr_t>(xbeg) % kChunkBytes) %
                                   kChunkBytes;
    const char* in_hi = xend - reinterpret_cast<uintptr_t>(xend) % kChunkBytes;
    const char* a = lo > in_lo ? lo : in_lo;
    const char* b = hi < in_hi ? hi : in_hi;
    if (a != lo || b != hi) {
      for (const char* f = lo; f < hi; f += 4) {
        if ((f < a || f >= b) && f >= xbeg && f < xend) {
          dst[(f - lo) / 4] = *reinterpret_cast<const float*>(f);
        }
      }
    }
    if (b > a) {
      bytes = static_cast<unsigned>(b - a);
      barrier_arrive_expect(bar, bytes);
      bulk_copy(reinterpret_cast<char*>(dst) + (a - lo), a, bytes, bar);
      return;
    }
  }
  barrier_arrive_expect(bar, bytes);
}

// The contraction of one stage: samples j = s, s + 16, ... < len of the
// lane's three rows (offsets off[c] into the warp's region xs) against the
// stage's W rows, which sit at wq[quad * quad_stride + j] as float4s.
template <bool kMain>
__device__ __forceinline__ void contract(const float* xs, const float4* wq, int quad_stride,
                                         const int (&off)[kRows], int s, int len,
                                         float (&acc)[kValues]) {
  auto step = [&](int j) {
    float xv[kRows];
#pragma unroll
    for (int c = 0; c < kRows; ++c) xv[c] = xs[off[c] + j];
#pragma unroll
    for (int qd = 0; qd < kQuads; ++qd) {
      const float4 wv = wq[qd * quad_stride + j];
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        const int i = c * kTile + 4 * qd;
        acc[i + 0] = fmaf(xv[c], wv.x, acc[i + 0]);
        acc[i + 1] = fmaf(xv[c], wv.y, acc[i + 1]);
        acc[i + 2] = fmaf(xv[c], wv.z, acc[i + 2]);
        acc[i + 3] = fmaf(xv[c], wv.w, acc[i + 3]);
      }
    }
  };
  if constexpr (kMain) {
#pragma unroll
    for (int i = 0; i < kStageSamples / kLanes; ++i) step(kLanes * i + s);
  } else {
    for (int j = s; j < len; j += kLanes) step(j);
  }
}

// The epoch's 16 lanes add their 48 sums by recursive halving (shfl_xor 8,
// 4, 2, 1; at each step a lane keeps the half its mask bit names and adds
// its partner's copy of it), leaving lane s the three sums of values
// [held_base(s), + 3), each added in one fixed order.
__device__ __forceinline__ int held_base(int s) {
  return 24 * ((s >> 3) & 1) + 12 * ((s >> 2) & 1) + 6 * ((s >> 1) & 1) + 3 * (s & 1);
}

template <int kHalf, int kMask>
__device__ __forceinline__ void halve(float (&acc)[kValues], int s) {
  const bool upper = (s & kMask) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float lo = acc[i];
    const float hi = acc[i + kHalf];
    acc[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, kMask);
  }
}

__device__ __forceinline__ void reduce_scatter(float (&acc)[kValues], int s) {
  halve<kValues / 2, kLanes / 2>(acc, s);
  halve<kValues / 4, kLanes / 4>(acc, s);
  halve<kValues / 8, kLanes / 8>(acc, s);
  halve<kValues / 16, kLanes / 16>(acc, s);
}

// max(||y||, 1e-30) of an epoch whose `lanes` lanes hold the sums of
// squares of their values: a butterfly (shfl_xor 1, 2, 4, ...), so every
// lane gets it.
__device__ __forceinline__ float epoch_norm(float ss, int lanes) {
  for (int mask = 1; mask < lanes; mask <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, mask);
  return fmaxf(sqrtf(ss), 1e-30f);
}

template <bool kMain>
__global__ void __launch_bounds__(kThreads, 1)
    epoch_features_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int e = lane / kLanes;
  const int s = lane % kLanes;
  const int n = kMain ? kMainEpoch : g.n;
  const int K = kMain ? kMainFeatures : g.features;
  const int C = g.channels;
  const int stages = (n + kStageSamples - 1) / kStageSamples;
  const int tiles = (K + kTile - 1) / kTile;
  const int groups = (C + kRows - 1) / kRows;
  const bool single = tiles * groups == 1;
  // the ring barriers and W's; the main path's W, [quad][j] float4s; then
  // the ring, each slot the warps' regions and (off the main path) the
  // stage's W tile
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem) + warp * kStages;
  uint64_t* const w_bar = reinterpret_cast<uint64_t*>(smem) + kWarps * kStages;
  float* const wres = smem + kBarFloats;
  float* const ring = wres + (kMain ? kMainEpoch * kTile : 0);
  const int slot_floats = kWarps * kWarpFloats + (kMain ? 0 : kWTileFloats);
  auto pair_of = [&](int r) { return (blockIdx.x + r * gridDim.x) * kWarps + warp; };
  // On the main path a warp walks its own pairs (no block barrier after the
  // first); other sizes meet at each stage's barrier, so every warp walks
  // g.rounds, a pair past the end staging and writing nothing.
  int rounds = g.rounds;
  if (kMain) {
    const int first = pair_of(0);
    const int step = gridDim.x * kWarps;
    rounds = first < g.pairs ? (g.pairs - 1 - first) / step + 1 : 0;
  }
  const long long items = static_cast<long long>(rounds) * groups * tiles * stages;
  const char* const xbeg = reinterpret_cast<const char*>(x);
  const char* const xend =
      xbeg + static_cast<long long>(g.epochs) * C * g.length * static_cast<long long>(sizeof(float));

  // Lanes 0-5 copy the rows of the warp's pair (epoch lane / 3, channel
  // lane % 3 of the group); each slot's barrier counts their six arrivals.
  if (lane < kStages) barrier_init(bars + lane, kPairRows);
  if (kMain && threadIdx.x == 0) barrier_init(w_bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  if (kMain && threadIdx.x == 0) {
    // W, laid out [quad][j] float4s by the wrapper, one bulk copy
    barrier_arrive_expect(w_bar, kMainEpoch * kTile * sizeof(float));
    bulk_copy(wres, w, kMainEpoch * kTile * sizeof(float), w_bar);
  }
  __syncthreads();  // the barriers initialized for every thread: the one barrier on the main path

  Cursor pc;  // the stage being copied
  const char* row_chunk0 = nullptr;  // lanes 0-5: their row's first chunk this pass
  int row_o = 0;                     // and the window's offset in it, in floats
  auto issue = [&](int slot) {
    const int js = pc.t;
    const int len = min(kStageSamples, n - js * kStageSamples);
    float* base = ring + slot * slot_floats;
    if (lane < kPairRows) {
      const int re = lane / kRows;
      const int rc = lane - re * kRows;
      if (js == 0) {
        const int p = pair_of(pc.r);
        const float* start = window_start(x, g, p, pair_epoch(p, re), pc.cg * kRows + rc);
        row_o = start != nullptr ? chunk_offset(start) : 0;
        row_chunk0 = start != nullptr ? reinterpret_cast<const char*>(start - row_o) : nullptr;
      }
      stage_row(row_chunk0, row_o, js, len, base + warp * kWarpFloats + row_slot(re, rc),
                bars + slot, xbeg, xend);
    }
    if constexpr (!kMain) {
      // W's tile kt, laid out [tile][quad][j] float4s by the wrapper: the
      // stage's rows of each quad are one run
      float* wt = base + kWarps * kWarpFloats;
      for (int i = threadIdx.x; i < len * kQuads; i += kThreads) {
        const int qd = i / len;
        const int j = i - qd * len;
        copy_async16(wt + (qd * kStageSamples + j) * 4,
                     w + ((static_cast<long long>(pc.kt) * kQuads + qd) * n +
                          js * kStageSamples + j) * 4);
      }
      commit_async();  // one group a stage, empty past the end
    }
  };

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < items) {
      issue(k);
    } else if constexpr (!kMain) {
      commit_async();
    }
    pc.advance(stages, tiles, groups);
  }
  if constexpr (kMain) barrier_wait(w_bar, 0);  // W landed

  Cursor cc;  // the stage being contracted
  float acc[kValues];
  int off[kRows];
  double ss = 0.0;  // this lane's sums of squares over the passes
  for (long long u = 0; u < items; ++u) {
    const int slot = static_cast<int>(u % kStages);
    if constexpr (!kMain) wait_async<kStages - 2>();  // this thread's copies of W's tile
    barrier_wait(bars + slot, static_cast<unsigned>(u / kStages) & 1u);  // the rows
    if constexpr (kMain) {
      __syncwarp();  // its lanes done with stage u - 1
    } else {
      __syncthreads();  // every thread's tile copies visible; done with stage u - 1
    }
    // the stage kStages - 1 ahead goes to the slot stage u - 1 left
    if (u + kStages - 1 < items) {
      issue(static_cast<int>((u + kStages - 1) % kStages));
    } else if constexpr (!kMain) {
      commit_async();
    }
    pc.advance(stages, tiles, groups);

    const int p = pair_of(cc.r);
    const long long b = pair_epoch(p, e);
    const bool live = p < g.pairs && b < g.epochs;
    if (cc.t == 0) {
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        const float* start = window_start(x, g, p, b, cc.cg * kRows + c);
        off[c] = row_slot(e, c) + (start != nullptr ? chunk_offset(start) : 0);
      }
#pragma unroll
      for (int i = 0; i < kValues; ++i) acc[i] = 0.0f;
      if (cc.cg == 0 && cc.kt == 0) ss = 0.0;
    }
    const int js = cc.t;
    const float* base = ring + slot * slot_floats;
    const int len = min(kStageSamples, n - js * kStageSamples);
    if constexpr (kMain) {
      contract<true>(base + warp * kWarpFloats,
                     reinterpret_cast<const float4*>(wres) + js * kStageSamples, kMainEpoch,
                     off, s, len, acc);
    } else {
      contract<false>(base + warp * kWarpFloats,
                      reinterpret_cast<const float4*>(base + kWarps * kWarpFloats),
                      kStageSamples, off, s, len, acc);
    }

    if (cc.t == stages - 1) {
      reduce_scatter(acc, s);
      const int hb = held_base(s);
      const int c0 = cc.cg * kRows;
      const int k0 = cc.kt * kTile;
      float pass_ss = 0.0f;
#pragma unroll
      for (int t = 0; t < kHeld; ++t) {
        const int c = (hb + t) / kTile;
        const int k = (hb + t) % kTile;
        if (c0 + c < C && k0 + k < K) pass_ss = fmaf(acc[t], acc[t], pass_ss);
      }
      ss += pass_ss;
      const bool last = cc.cg == groups - 1 && cc.kt == tiles - 1;
      float norm = 1.0f;
      if (last && single) {
        norm = epoch_norm(pass_ss, kLanes);
      } else if (last) {
        double total = ss;
#pragma unroll
        for (int mask = 1; mask < kLanes; mask <<= 1) {
          total += __shfl_xor_sync(0xffffffffu, total, mask);
        }
        norm = fmaxf(sqrtf(static_cast<float>(total)), 1e-30f);
      }
      const float d = single ? norm : 1.0f;  // several passes: rescaled below
      const long long row_floats = static_cast<long long>(C) * K;
      float* const row = out + b * row_floats;
#pragma unroll
      for (int t = 0; t < kHeld; ++t) {
        const int c = (hb + t) / kTile;
        const int k = (hb + t) % kTile;
        if (live && c0 + c < C && k0 + k < K) {
          row[static_cast<long long>(c0 + c) * K + k0 + k] = acc[t] / d;
        }
      }
      if (!single && last) {
        __syncwarp();  // the row's values, written by the epoch's lanes, visible to them
        if (live) {
          for (long long i = s; i < row_floats; i += kLanes) row[i] = row[i] / norm;
        }
      }
    }
    cc.advance(stages, tiles, groups);
  }
}

// The small launches of the main path (three channels or fewer, up to 2,048
// epochs; the -pallas run's 641 and 1,494): a block of 8 warps takes one
// epoch at a time (kL = 32 lanes an epoch, up to 384 epochs) or two (kL =
// 16), warp w the window's stage w, its samples read straight into
// registers. With 32 lanes an epoch a lane needs W's 2 rows of the stage,
// which it holds in registers; with 16 it needs 4, which the warp copies to
// shared memory once. Each warp's sums add across its lanes (recursive
// halving; at kL = 32 the two lanes left with the same values then add
// theirs), then across the 8 warps in warp order through shared memory;
// warp 0 writes the rows. No ring, barrier initialization or bulk copy
// stands between the launch and the first loads.
template <int kL>
__global__ void __launch_bounds__(kSmallWarps * 32, 2)
    epoch_features_kernel_small(const float* __restrict__ x, const float* __restrict__ w,
                                float* __restrict__ out, Geometry g) {
  constexpr int kPer = 32 / kL;                  // epochs a block takes at a time
  constexpr int kSteps = kSmallPart / kL;     // samples of a lane's stage
  constexpr bool kHeldW = kL == 32;              // W's rows in registers
  __shared__ __align__(16) float4 wsm[kHeldW ? 1 : kQuads * kMainEpoch];  // [quad][j]
  __shared__ float part[2][kSmallWarps][kPer][kValues];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int e = lane / kL;
  const int s = lane % kL;
  const int C = g.channels;
  const int j0 = warp * kSmallPart;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4 wreg[kHeldW ? kSteps * kQuads : 1];
  if constexpr (kHeldW) {
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int qd = 0; qd < kQuads; ++qd) wreg[i * kQuads + qd] = w4[qd * kMainEpoch + j0 + kL * i + s];
    }
  } else {
    for (int i = lane; i < kQuads * kSmallPart; i += 32) {
      const int qd = i / kSmallPart;
      const int j = j0 + i - qd * kSmallPart;
      wsm[qd * kMainEpoch + j] = w4[qd * kMainEpoch + j];
    }
  }
  const int units = (g.epochs + kPer - 1) / kPer;
  auto load = [&](int unit, float (&xv)[kRows][kSteps]) {
    const long long b = static_cast<long long>(unit) * kPer + e;
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      const bool in = b < g.epochs && c < C;
      const float* start = x + (b * C + c) * g.length + g.skip + j0 + s;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) xv[c][i] = in ? start[kL * i] : 0.0f;
    }
  };
  float xv[kRows][kSteps];
  int unit = blockIdx.x;
  if (unit < units) load(unit, xv);
  __syncwarp();  // the warp's rows of W
  for (int r = 0; unit < units; ++r, unit += gridDim.x) {
    float acc[kValues];
#pragma unroll
    for (int i = 0; i < kValues; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int qd = 0; qd < kQuads; ++qd) {
        float4 wv;
        if constexpr (kHeldW) {
          wv = wreg[i * kQuads + qd];
        } else {
          wv = wsm[qd * kMainEpoch + j0 + kL * i + s];
        }
#pragma unroll
        for (int c = 0; c < kRows; ++c) {
          const int a = c * kTile + 4 * qd;
          acc[a + 0] = fmaf(xv[c][i], wv.x, acc[a + 0]);
          acc[a + 1] = fmaf(xv[c][i], wv.y, acc[a + 1]);
          acc[a + 2] = fmaf(xv[c][i], wv.z, acc[a + 2]);
          acc[a + 3] = fmaf(xv[c][i], wv.w, acc[a + 3]);
        }
      }
    }
    const long long b = static_cast<long long>(unit) * kPer + e;
    if (unit + static_cast<int>(gridDim.x) < units) load(unit + gridDim.x, xv);  // the next
    int hb;
    if constexpr (kL == 32) {
      // halve on lanes 16, 8, 4, 2; lanes l and l ^ 1 then hold the same
      // three values, and add them
      halve<kValues / 2, 16>(acc, lane);
      halve<kValues / 4, 8>(acc, lane);
      halve<kValues / 8, 4>(acc, lane);
      halve<kValues / 16, 2>(acc, lane);
#pragma unroll
      for (int t = 0; t < kHeld; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 1);
      hb = held_base(lane >> 1);
    } else {
      reduce_scatter(acc, s);
      hb = held_base(s);
    }
    float* pb = &part[r % 2][0][0][0];
    if (kL == 16 || (lane & 1) == 0) {
#pragma unroll
      for (int t = 0; t < kHeld; ++t) pb[(warp * kPer + e) * kValues + hb + t] = acc[t];
    }
    __syncthreads();
    if (warp == 0) {
      float pass_ss = 0.0f;
#pragma unroll
      for (int t = 0; t < kHeld; ++t) {
        for (int v = 1; v < kSmallWarps; ++v) acc[t] += pb[(v * kPer + e) * kValues + hb + t];
        if ((hb + t) / kTile < C) pass_ss = fmaf(acc[t], acc[t], pass_ss);
      }
      float norm;
      if constexpr (kL == 32) {
        // lanes l and l ^ 1 hold the same values: count them once
        norm = epoch_norm((lane & 1) == 0 ? pass_ss : 0.0f, 32);
      } else {
        norm = epoch_norm(pass_ss, kLanes);
      }
      float* const row = out + b * C * kTile;
#pragma unroll
      for (int t = 0; t < kHeld; ++t) {
        if (b < g.epochs && (kL == 16 || (lane & 1) == 0) && (hb + t) / kTile < C) {
          row[hb + t] = acc[t] / norm;
        }
      }
    }
  }
}

// Shared memory of the ring kernel.
template <bool kMain>
size_t shared_bytes() {
  const size_t floats = kBarFloats + (kMain ? static_cast<size_t>(kMainEpoch) * kTile : 0) +
                        static_cast<size_t>(kStages) *
                            (static_cast<size_t>(kWarps) * kWarpFloats + (kMain ? 0 : kWTileFloats));
  return floats * sizeof(float);
}

// One resident wave of blocks of the kernel, or as many as `units` (its
// blocks' work) need; sets g.rounds to the units a block takes in turn.
template <class Kernel>
cudaError_t plan_launch(Kernel kernel, int threads, size_t smem, long long units, Geometry& g,
                        int* grid) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wave = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(units < wave ? units : wave);
  g.rounds = static_cast<int>((units + *grid - 1) / *grid);
  return cudaSuccess;
}

template <bool kMain>
cudaError_t launch(const float* x, const float* w, float* out, Geometry g, cudaStream_t stream) {
  int grid = 0;
  const size_t smem = shared_bytes<kMain>();
  const cudaError_t err = plan_launch(epoch_features_kernel<kMain>, kThreads, smem,
                                      (g.pairs + kWarps - 1) / kWarps, g, &grid);
  if (err != cudaSuccess) return err;
  epoch_features_kernel<kMain><<<grid, kThreads, smem, stream>>>(x, w, out, g);
  return cudaGetLastError();
}

template <int kL>
cudaError_t launch_small(const float* x, const float* w, float* out, Geometry g,
                         cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err = plan_launch(epoch_features_kernel_small<kL>, kSmallWarps * 32, 0,
                                      (g.epochs + 32 / kL - 1) / (32 / kL), g, &grid);
  if (err != cudaSuccess) return err;
  epoch_features_kernel_small<kL><<<grid, kSmallWarps * 32, 0, stream>>>(x, w, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`. x: (epochs, channels, length) float32 epochs; w: the
// (epoch_size, w_columns) float32 cascade matrix, its first `features`
// columns used (w_columns a multiple of 16, the rest zero), laid out as
// (w_columns / 16, 4, epoch_size, 4): tile, float4 of the tile, row, and
// element, 16-byte aligned; out: (epochs, channels * features) float32.
// The window [skip, skip + epoch_size) must lie inside each row. Returns
// the cudaError_t of the launch.
int epoch_features_launch(const void* x, const void* w, void* out, int epochs, int channels,
                          int length, int skip, int epoch_size, int features, int w_columns,
                          void* stream) {
  if (epochs <= 0) return cudaSuccess;
  if (channels <= 0 || skip < 0 || epoch_size <= 0 || skip > length - epoch_size ||
      features <= 0 || w_columns < features) {
    return cudaErrorInvalidValue;
  }
  Geometry g{epochs,   channels, length, skip, epoch_size, features, w_columns,
             static_cast<int>(4 * ((static_cast<long long>(epochs) + 7) / 8)), 0};
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_columns % kTile != 0) return cudaErrorInvalidValue;
  if (epoch_size == kMainEpoch && features == kMainFeatures && w_columns == kMainFeatures) {
    if (channels <= kRows && epochs <= kSingleEpochs) return launch_small<32>(xf, wf, of, g, st);
    if (channels <= kRows && g.pairs <= kSmallPairs) return launch_small<16>(xf, wf, of, g, st);
    return launch<true>(xf, wf, of, g, st);
  }
  return launch<false>(xf, wf, of, g, st);
}

const char* epoch_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
