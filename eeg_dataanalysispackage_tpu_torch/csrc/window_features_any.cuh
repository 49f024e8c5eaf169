// The generic engine of the fused kernels: any analysis window (`epoch`
// samples) and coefficient count (`features`) but the main path's 512 / 16,
// which runs the ring engine of window_features.cuh. Both kernels walk
// their windows through it, so the rows of the fused ingest kernel and the
// features behind the serve megakernel's margins agree bit for bit.
//
// Replaces, at non-default sizes, the TPU kernels
// eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:314 (_make_kernel) and
// :462 (_make_kernel_bank), and ops/serve_mega.py:259 (_make_mega_kernel)
// and :484 (_mega_multi_program).
//
// Per window and channel c (the function of window_features.cuh at any
// size):
//   x     = float(raw[c, start + j]) * res[c]      (0 outside [0, n_samples))
//   mean  = sum(x[0 .. pre)) / pre                 (accumulated in double)
//   z     = x[pre + skip .. pre + skip + epoch) - mean   (__fmul_rn,
//           __fsub_rn; rounded to bf16 for kBf16)
//   y[k]  = sum_j z[j] * W[j, k]                   (f32 FMAs, CUDA cores)
// then, per window, the row's sum of squares in double, the row divided by
// max(norm, 1e-30), for kInt8 / kInt4 quantize_feature over the subband
// groups, and the caller's finish.
//
// Bound on the H100: bytes where the contraction is short, operations
// where it is long. At 4,096 windows of 3 channels: (256, 16) moves 9.6 MB
// of int16 samples for 0.10 GFLOP (bytes: 0.0029 ms at 3.35 TB/s);
// (512, 64) moves 15 MB for 0.81 GFLOP (operations: 0.012 ms at 67 TFLOP/s,
// f32 on CUDA cores). Float32 samples move twice the bytes: 0.0052 ms at
// (256, 16) and 0.012 ms at (700, 32) and (512, 64) are bytes.
//
// Two designs share the contract below, each instantiated for int16 and
// float32 samples; the plan (ops/generic_plan.py) picks one per launch by
// its first field (kPhaseDesign, kRingDesign), the kernels take it as a
// template argument, and the launchers check the plan again.
//
// The ring design, run_tiles_ring (it replaced the phase-by-phase design
// for float32 samples, then for int16 ones, where tiles have many
// outputs): one block of 384 threads a multiprocessor (168 registers a
// thread), in two roles that hand work on through a ring of up to four
// chunk slots, each slot 32 samples of j of every row of a piece and W's
// 32 rows of a k-tile:
//   - warps 0-7 contract: thread (row thread, column thread) owns
//     RingPlan::rr x qq outputs, 8 x 4 or 4 x 4 (12 or 8 16-byte shared
//     loads feed 128 or 64 FMAs), or 1 x 1 for a tile of few outputs such
//     as a serve batch's single window. Each output is one chain of FMAs
//     from 0 in ascending j over the chunks, in registers. The warps a
//     piece leaves idle copy the chunks `slots` ahead into the slots the
//     contraction frees (cp.async of whole 16-byte chunks, each thread's
//     arrival on the slot's mbarrier tracking its copies; all eight warps
//     where fewer than two are idle): a row's chunk of 32 samples is the
//     16-byte chunks that cover it from any offset, 9 of float32 samples
//     and 5 of int16, so int16 rows cost the copying warps about half.
//   - warps 8-11 centre: per piece each row's mean (lane_baseline_sum's
//     order, on 4 lanes a row), then per chunk z = x - mean in place in
//     the slot, once its mbarrier says the copies have landed (a row's
//     region holds its raw chunks, then its 32 centred floats; int16 rows
//     converted by integer operations, four samples a lane from three
//     32-bit loads and stored as one 16-byte store); and a tile's epilogue
//     while the next tile is contracted.
//   - Hand-offs are named barriers between the roles (bar.sync on one
//     side, bar.arrive on the other) and the slots' mbarriers; none is
//     block-wide but the block's first piece's means and its last tile's
//     epilogue, which nothing else overlaps and the whole block runs.
//   Why cp.async from many warps and not 1D bulk copies: a chunk is a few
//   hundred copies of 80 or 144 bytes, one a row; issued as bulk copies
//   they queued on the copy engine, and issued by one warp as cp.async
//   they queued on that warp (PERF.md section 6).
//   What bounds it: each chunk's hand-off through the ring (the copies'
//   latency over the slots, the centring, the contraction of a
//   sub-partition's busiest warps, which share its issue slots with a
//   centring warp), and per block a fixed cost that nothing overlaps (the
//   first piece's copies and means, the last tile's epilogue).
//
// The phase-by-phase design, run_tiles_any, kept where the plan finds it
// faster: tiles of few outputs, such as a serve batch's single window,
// whose fixed cost the ring design's pipeline cannot hide:
//   - A tile of M windows a block (AnyPlan::m: 1 at a serve batch of 64,
//     up to 16 at thousands of windows); persistent blocks walk the tiles
//     grid-stride. A tile's (window, channel) rows run as pieces of up to
//     AnyPlan::rz rows (one piece where they fit).
//   - A piece's samples are staged by 16-byte cp.async chunks (the ring's
//     superset chunks and masking: any start, negative or past the end;
//     rows aligned or not), started as soon as the previous piece is
//     centred (by the warps the contraction leaves idle, where there are
//     any), so they fly while it is contracted and its epilogue runs.
//     Where a row's baseline does not fit, the means read it from device
//     memory; where nothing fits, so do the centres.
//   - Means and centre: 8 lanes a row, a warp on four rows at once, the
//     baseline summed in double in a fixed lane order (exact for int16
//     samples, which convert by integer operations, not the quarter-rate
//     I2F), the centred row written to z in shared memory.
//   - W in shared memory: resident for the whole launch where it fits
//     beside the tile, else streamed in chunks of rows through two slots.
//   - The contraction is register-blocked: thread (row group, column
//     group) owns rr rows x qq coefficients (rr up to max_rows: 3 for
//     int16 samples, 2 for float32; qq = 4, or 1 for a tile of few
//     outputs), reading 4 samples of a row of z as a float4.
//   - The epilogue: each window's norm in double on a warp; for the int8
//     and int4 rungs each subband group's maximum on a thread and the
//     quantize on every thread of the block; the caller's finish on a
//     warp a window.
//   A block's phases run in turn behind block-wide barriers, two blocks a
//   multiprocessor at 128 registers a thread: what bounds it at many
//   outputs a tile, where the ring design overlaps those phases.
//
// Every output is one fmaf chain from 0.0f in ascending j, the mean
// summed in double in lane_baseline_sum's lane order, the centre
// __fmul_rn then __fsub_rn of sample_value's bits, normalize_row's and
// quantize_feature's order, in both designs: rows, margins and quantized
// rows are the same bit for bit whatever the design or the plan.
//
// Reach: a launch is refused (kSharedMemoryExceeded) exactly where the
// one-window-a-block engine's shared memory (any_smem_bytes) exceeded the
// block's opt-in limit, for either sample type and design. Every other
// launch has a plan in each design that fits: one row a piece, nothing
// staged and the smallest W chunk (phase-by-phase), or one row, 4
// coefficients and one slot (ring: 172 floats beside the tile's row), take
// less shared memory than that engine did.

#pragma once

#include <type_traits>

#include "window_features.cuh"

namespace window_features {

// Returned by a launcher (not a cudaError_t) where the generic engine's
// reach excludes the launch's sizes.
constexpr int kSharedMemoryExceeded = -1;

// Blocks a multiprocessor each generic kernel asks for
// (__launch_bounds__): 128 registers a thread.
constexpr int kAnyMinBlocksPerSm = 2;
// W floats each thread copies for one streamed chunk (jc * KT <= 256 * 8).
constexpr int kAnyFetch = 8;
// The most (window, channel) rows one thread of the phase-by-phase
// design's contraction owns: its RR x qq accumulators and two steps'
// samples fit 128 registers beside the rest of the kernel without a spill
// (2 for float32 samples, whose instantiations spill at 3).
template <class Sample>
__host__ __device__ constexpr int max_rows() {
  return sizeof(Sample) == 2 ? 3 : 2;
}

// Subband groups of one channel's `features` coefficients: [0, 1), then
// [2^(g-1), min(2^g, features)) for g >= 1 (ops/decode_ingest.py
// subband_group_bounds; the eegdsp layout [aK | dK | ... | d1]).
__host__ __device__ inline int subband_groups(int features) {
  int groups = 1;
  for (int lo = 1; lo < features; lo *= 2) ++groups;
  return groups;
}

// The shared memory of the one-window-a-block engine (the row, one
// channel's window, 256 partials, the group maxima and 8 doubles): the
// generic engine's reach.
inline size_t any_smem_bytes(int channels, int epoch, int features) {
  const size_t c = static_cast<size_t>(channels);
  return static_cast<size_t>(kWarps) * sizeof(double) +
         (c * features + epoch + kThreads + c * subband_groups(features)) * sizeof(float);
}

// A launch's tile plan (ops/generic_plan.py generic_tile_plan).
struct AnyPlan {
  int m;            // windows a tile
  int rz;           // (window, channel) rows a piece: the rows of z
  int rr;           // rows each thread contracts: 1 to max_rows<Sample>()
  int tq_log2;      // log2 of the contraction's column threads; a k-tile is qq << tq_log2
  int jc;           // W rows a streamed chunk (a multiple of 4), 0: W resident
  int ep;           // z's row stride in floats (4 mod 32, at least epoch rounded up to 4)
  int base_chunks;  // staged chunks of a row's baseline, 0: the means read device memory
  int seg_chunks;   // staged chunks of a row's analysis segment, 0: nothing staged
  int qq;           // coefficients each thread contracts: 4, or 1 for a tile of few outputs
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int kt_log2(const AnyPlan& p) {
  return p.tq_log2 + (p.qq == 4 ? 2 : 0);
}
__host__ __device__ inline int k_tile(const AnyPlan& p) { return 1 << kt_log2(p); }
__host__ __device__ inline int k_tiles(const AnyPlan& p, int features) {
  return (features + k_tile(p) - 1) / k_tile(p);
}

// Shared memory of a plan, in carve order: W (resident, or two chunk
// slots), z, the staging slot, the tile's rows y and their subband groups'
// maxima.
inline size_t any_plan_smem_bytes(const AnyPlan& p, int channels, int epoch, int features) {
  const size_t kt = static_cast<size_t>(k_tile(p));
  const size_t w = p.jc == 0 ? static_cast<size_t>(k_tiles(p, features)) * round4(epoch) * kt
                             : 2 * static_cast<size_t>(p.jc) * kt;
  const size_t z = static_cast<size_t>(p.rz) * p.ep;
  const size_t y = static_cast<size_t>(p.m) * channels * (features + subband_groups(features));
  const size_t raw = static_cast<size_t>(p.rz) * (p.base_chunks + p.seg_chunks) * kChunkBytes;
  return (w + z + y) * sizeof(float) + raw;
}

// Check a plan against the launch's sizes and the card: kSharedMemoryExceeded
// outside the engine's reach, cudaErrorInvalidValue for a plan that is
// inconsistent or does not fit; else its shared memory in *smem.
template <class Sample>
int check_any_plan(const int* fields, int channels, int epoch, int features, int pre,
                   AnyPlan* plan, size_t* smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(max_optin);
  if (any_smem_bytes(channels, epoch, features) > limit) return kSharedMemoryExceeded;
  if (fields == nullptr) return cudaErrorInvalidValue;
  const AnyPlan p{fields[0], fields[1], fields[2], fields[3], fields[4],
                  fields[5], fields[6], fields[7], fields[8]};
  if ((p.qq != 1 && p.qq != 4) || p.tq_log2 < 0 || kt_log2(p) > 7) return cudaErrorInvalidValue;
  const bool ok =
      p.m >= 1 && p.m <= 1024 && p.rr >= 1 && p.rr <= max_rows<Sample>() && p.rz >= 1 &&
      p.rz <= (kThreads >> p.tq_log2) * p.rr &&
      static_cast<long long>(p.rz) <= static_cast<long long>(p.m) * channels &&
      (p.jc == 0 || (p.jc >= 4 && p.jc % 4 == 0 && p.jc * k_tile(p) <= kThreads * kAnyFetch)) &&
      p.ep >= round4(epoch) && p.ep % 32 == 4 &&
      (p.seg_chunks == 0 ? p.base_chunks == 0
                         : p.seg_chunks == segment_chunks<Sample>(epoch) &&
                               (p.base_chunks == 0 ||
                                p.base_chunks == segment_chunks<Sample>(pre)));
  if (!ok) return cudaErrorInvalidValue;
  *smem = any_plan_smem_bytes(p, channels, epoch, features);
  if (*smem > limit) return cudaErrorInvalidValue;
  *plan = p;
  return cudaSuccess;
}

// The card's multiprocessors and per-block shared-memory opt-in limit,
// the inputs of ops/generic_plan.py's plan.
inline int any_device_limits(int* sms, int* optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// What run_tiles_any reads of a launch, with the pieces of the carve.
template <class Sample>
struct AnyLaunch {
  StreamView<Sample> v;
  const float* __restrict__ res;
  const float* __restrict__ w;
  int rows;
  int pre;
  int skip;
  int epoch;
  int features;
  AnyPlan p;
  float* wsm;   // resident W [k-tiles][round4(epoch)][KT], or two chunk slots [jc][KT]
  float* z;     // [rz][ep]  the piece's centred rows
  char* slot;   // [rz][base_chunks + seg_chunks] x 16 B  the piece's staged samples
  float* y;     // [m][channels * features]  the tile's rows
  float* gmax;  // [m][channels][subband groups]  the quantize step's group maxima
};

// Stage rows [r0, r0 + nr) of tile `tile` into the slot (the caller
// commits), warp w0 + v of nw warps taking rows v + nw i, its lanes over a
// row's chunks: the chunks that cover the baseline (where staged) and
// analysis segments, as stage_window does for the ring: a chunk holding no
// sample of the row is skipped (the reads mask it), one that runs past
// either end of the tensor is copied sample by sample, every other one is
// one 16-byte cp.async. Lane l first loads the window start and channel of
// the warp's row l of each 32 (independent loads, all in flight at once),
// and row i takes them from lane i by a shuffle.
template <class Sample, class Windows>
__device__ __forceinline__ void stage_piece(const AnyLaunch<Sample>& a, int tile, int r0,
                                            int nr, int w0, int nw, const Windows& win) {
  constexpr int kv = chunk_samples<Sample>();
  const int cpr = a.p.base_chunks + a.p.seg_chunks;
  const int C = a.v.channels;
  const long long total = static_cast<long long>(C) * a.v.n;
  const int warp = threadIdx.x / 32 - w0;
  const int lane = threadIdx.x % 32;
  if (warp < 0) return;
  for (int g = warp; g < nr; g += nw * 32) {
    const int mine = g + nw * lane;
    int my_c = 0;
    int my_start = 0;
    bool my_valid = false;
    if (mine < nr) {
      const int tr = r0 + mine;
      const int wi = tr / C;
      my_c = tr - wi * C;
      const int row = tile * a.p.m + wi;
      my_valid = row < a.rows;
      if (my_valid) my_start = win.start(row);
    }
    const int count = min(32, (nr - g + nw - 1) / nw);
    for (int i = 0; i < count; ++i) {
      const int c = __shfl_sync(0xffffffffu, my_c, i);
      const int start = __shfl_sync(0xffffffffu, my_start, i);
      if (!__shfl_sync(0xffffffffu, my_valid, i)) continue;
      char* slot = a.slot + static_cast<size_t>(g + nw * i) * cpr * kChunkBytes;
      for (int q = lane; q < cpr; q += 32) {
        const bool analysis = q >= a.p.base_chunks;
        const int k = analysis ? q - a.p.base_chunks : q;
        const int len = analysis ? a.epoch : a.pre;
        const long long first = static_cast<long long>(start) + (analysis ? a.pre + a.skip : 0);
        const int off = a.v.offset(c, first);
        if (k * kv >= off + len) continue;  // past the segment's last chunk
        const long long s0 = first - off + static_cast<long long>(k) * kv;
        if (s0 + kv <= 0 || s0 >= a.v.n) continue;
        const long long e = static_cast<long long>(c) * a.v.n + s0;
        Sample* dst = reinterpret_cast<Sample*>(slot + static_cast<size_t>(q) * kChunkBytes);
        if (e >= 0 && e + kv <= total) {
          copy_async16(dst, a.v.raw + e);
        } else {
          for (int j = 0; j < kv; ++j) {
            if (s0 + j >= 0 && s0 + j < a.v.n) dst[j] = a.v.raw[e + j];
          }
        }
      }
    }
  }
}

// Lanes that centre one row together: a warp takes four rows at once.
constexpr int kRowLanes = 8;

// float(sample): an int16 sample by integer operations and one exact
// subtraction (0x4B000000 | (x + 2^15) is the float 2^23 + 2^15 + x), not
// I2F, which runs at a quarter of the FP32 rate; a float sample as it is.
template <class Sample>
__device__ __forceinline__ float sample_value(Sample x) {
  if constexpr (sizeof(Sample) == 2) {
    return __fsub_rn(__int_as_float(0x4B000000 | (static_cast<int>(x) + 0x8000)), 8421376.0f);
  } else {
    return x;
  }
}

// x = float(sample j) * res, 0 outside the row (scaled() of
// window_features.cuh, by sample_value).
template <class Sample>
__device__ __forceinline__ float scaled_sample(const Sample* seg, int j, const InRow& in,
                                               float rc) {
  return (j >= in.lo && j < in.hi) ? __fmul_rn(sample_value(seg[j]), rc) : 0.0f;
}

// The baseline mean of one row on its kRowLanes lanes: lane l sums samples
// l + 8 i (x = float(sample) * res, 0 outside the row) in four chains
// (i mod 4) in double, the chains add in a fixed order, then a butterfly
// over the 8 lanes (every lane of the warp takes part in it; `sum`, the
// lane's own total, is 0 on a lane with no row). `base` is the staged
// baseline or the row in device memory (each call site has one memory
// space, so its loads are shared or global, not generic); the four
// samples of a step are loaded before any is added.
template <class Sample>
__device__ __forceinline__ double lane_baseline_sum(const Sample* base, const InRow& in, int pre,
                                                    float rc, int l8) {
  double part[4] = {0.0, 0.0, 0.0, 0.0};
  for (int j0 = l8; j0 < pre; j0 += 4 * kRowLanes) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + kRowLanes * u;
      x[u] = j < pre ? scaled_sample(base, j, in, rc) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) part[u] += static_cast<double>(x[u]);
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// z = x - mean for one row's analysis segment `seg` (staged, or in device
// memory) on its kRowLanes lanes, as centred() computes it (rounded to
// bf16 for kBf16), zeros from `epoch` to the next multiple of 4; four
// samples loaded a step before any z is stored.
template <class Sample, Precision P>
__device__ __forceinline__ void centre_row(float* zr, const Sample* seg, const InRow& in,
                                           int epoch, float rc, float mean, int l8) {
  const int e4 = round4(epoch);
  for (int j0 = l8; j0 < e4; j0 += 4 * kRowLanes) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + kRowLanes * u;
      x[u] = j < epoch ? scaled_sample(seg, j, in, rc) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + kRowLanes * u;
      if (j < e4) {
        float z = 0.0f;
        if (j < epoch) {
          z = __fsub_rn(x[u], mean);
          if constexpr (P == Precision::kBf16) z = round_bf16(z);
        }
        zr[j] = z;
      }
    }
  }
}

// The mean and the centred row of rows [r0, r0 + nr) of tile `tile` into z
// (a row past the launch's end: zeros): 32 groups of kRowLanes lanes, group
// g taking rows g, g + 32, ..., so a warp works on four rows at once. The
// loop's trip count is the block's, so every lane reaches each butterfly.
template <class Sample, Precision P, class Windows>
__device__ __forceinline__ void centre_piece(const AnyLaunch<Sample>& a, int tile, int r0,
                                             int nr, const Windows& win) {
  constexpr int kGroups = kThreads / kRowLanes;
  const int group = threadIdx.x / kRowLanes;
  const int l8 = threadIdx.x % kRowLanes;
  const int C = a.v.channels;
  const int cpr = a.p.base_chunks + a.p.seg_chunks;
  // row r's channel, start and resolution, loaded a round ahead
  auto row_of = [&](int r, int& c, int& start, float& rc) {
    c = 0;
    start = 0;
    rc = 0.0f;
    if (r >= nr) return false;
    const int tr = r0 + r;
    const int wi = tr / C;
    c = tr - wi * C;
    const int row = tile * a.p.m + wi;
    if (row >= a.rows) return false;
    start = win.start(row);
    rc = a.res[c];
    return true;
  };
  int next_c, next_start;
  float next_rc;
  bool next_valid = row_of(group, next_c, next_start, next_rc);
  for (int rb = 0; rb < nr; rb += kGroups) {
    const int r = rb + group;
    const bool valid = next_valid;
    const int c = next_c;
    const long long start = next_start;
    const float rc = next_rc;
    next_valid = row_of(r + kGroups, next_c, next_start, next_rc);
    const char* staged = a.slot + static_cast<size_t>(r) * cpr * kChunkBytes;
    const Sample* row_raw = a.v.raw + static_cast<long long>(c) * a.v.n;
    const InRow in(start, a.pre, a.v.n);
    double sum = 0.0;
    if (valid) {
      sum = a.p.base_chunks
                ? lane_baseline_sum(reinterpret_cast<const Sample*>(staged) + a.v.offset(c, start),
                                    in, a.pre, rc, l8)
                : lane_baseline_sum(row_raw + start, in, a.pre, rc, l8);
    }
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (r >= nr) continue;
    float* zr = a.z + static_cast<size_t>(r) * a.p.ep;
    if (!valid) {
      for (int j = l8; j < round4(a.epoch); j += kRowLanes) zr[j] = 0.0f;
      continue;
    }
    const float mean = static_cast<float>(sum / static_cast<double>(a.pre));
    const long long first = start + a.pre + a.skip;
    const InRow ina(first, a.epoch, a.v.n);
    if (a.p.seg_chunks) {
      const char* seg = staged + static_cast<size_t>(a.p.base_chunks) * kChunkBytes;
      centre_row<Sample, P>(zr, reinterpret_cast<const Sample*>(seg) + a.v.offset(c, first), ina,
                            a.epoch, rc, mean, l8);
    } else {
      centre_row<Sample, P>(zr, row_raw + first, ina, a.epoch, rc, mean, l8);
    }
  }
}

__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

// W resident, laid out [k-tile][round4(epoch)][KT], zeros past epoch and
// features: one 4-byte cp.async an element, all in flight at once, in the
// copy group of the first piece's samples (committed here).
template <Precision P, class Sample>
__device__ __forceinline__ void load_resident_w(const AnyLaunch<Sample>& a) {
  const int kt_log2 = window_features::kt_log2(a.p);
  const int kt = 1 << kt_log2;
  const int per_tile = round4(a.epoch) << kt_log2;
  const int nk = k_tiles(a.p, a.features);
  for (int k = 0; k < nk; ++k) {
    float* dst = a.wsm + static_cast<size_t>(k) * per_tile;
    for (int q = threadIdx.x; q < per_tile; q += kThreads) {
      const int j = q >> kt_log2;
      const int col = (k << kt_log2) + (q & (kt - 1));
      if (j < a.epoch && col < a.features) {
        copy_async4(dst + q, a.w + static_cast<long long>(j) * a.features + col);
      } else {
        dst[q] = 0.0f;
      }
    }
  }
  commit_async();
}

// Round n floats of W in shared memory (n a multiple of 4, 16-byte
// aligned) to bf16 in place, by the whole block: float4s, four a thread
// loaded before any is stored.
__device__ __forceinline__ void round_w_bf16(float* w, int n) {
  float4* w4 = reinterpret_cast<float4*>(w);
  const int n4 = n / 4;
  for (int q0 = threadIdx.x; q0 < n4; q0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u * kThreads < n4) v[u] = w4[q0 + u * kThreads];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u * kThreads < n4) {
        v[u].x = round_bf16(v[u].x);
        v[u].y = round_bf16(v[u].y);
        v[u].z = round_bf16(v[u].z);
        v[u].w = round_bf16(v[u].w);
        w4[q0 + u * kThreads] = v[u];
      }
    }
  }
}

// Start copying streamed chunk (k-tile k, W's rows j0 .. j0 + jc) into
// dst, laid out [jc][KT] (zeros past epoch and features; a 4-byte cp.async
// an element, this thread's elements q = t, t + 256, ...), and commit.
template <class Sample>
__device__ __forceinline__ void start_chunk(const AnyLaunch<Sample>& a, int k, int j0,
                                            float* dst) {
  const int kt_log2 = window_features::kt_log2(a.p);
  const int kt = 1 << kt_log2;
  const int n = a.p.jc << kt_log2;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int j = j0 + (q >> kt_log2);
    const int col = (k << kt_log2) + (q & (kt - 1));
    if (j < a.epoch && col < a.features) {
      copy_async4(dst + q, a.w + static_cast<long long>(j) * a.features + col);
    } else {
      dst[q] = 0.0f;
    }
  }
  commit_async();
}

// The bf16 rung rounds this thread's elements of a landed chunk in place.
template <Precision P, class Sample>
__device__ __forceinline__ void round_chunk(const AnyLaunch<Sample>& a, float* dst) {
  if constexpr (P == Precision::kBf16) {
    const int n = a.p.jc << kt_log2(a.p);
    for (int q = threadIdx.x; q < n; q += kThreads) dst[q] = round_bf16(dst[q]);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// One step: acc[i][q] += z[row_i][j + u] * w[u][QQ tq + q] for u = 0..3
// in order, wrow at W's row j and this thread's QQ coefficients (a float4,
// or one float).
template <int RR, int QQ>
__device__ __forceinline__ void fma_step(float (&acc)[RR][QQ], const float4 (&zv)[RR],
                                         const float* wrow, int kt) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if constexpr (QQ == 4) {
      const float4 wv = *reinterpret_cast<const float4*>(wrow + u * kt);
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const float zu = lane_of(zv[i], u);
        acc[i][0] = fmaf(zu, wv.x, acc[i][0]);
        acc[i][1] = fmaf(zu, wv.y, acc[i][1]);
        acc[i][2] = fmaf(zu, wv.z, acc[i][2]);
        acc[i][3] = fmaf(zu, wv.w, acc[i][3]);
      }
    } else {
      const float wv = wrow[u * kt];
#pragma unroll
      for (int i = 0; i < RR; ++i) acc[i][0] = fmaf(lane_of(zv[i], u), wv, acc[i][0]);
    }
  }
}

// acc[i][q] += sum over j < jlen of z[row_i][jz + j] * wt[j][QQ tq + q], in
// ascending j: 4 samples of each row and 4 rows of W a step, two steps an
// iteration (their loads in flight together; a second step past jlen reloads
// the first and is skipped).
template <int RR, int QQ>
__device__ __forceinline__ void fma_span(float (&acc)[RR][QQ], const float* z, int ep,
                                         const int (&rows)[RR], int jz, const float* wt, int kt,
                                         int tq, int jlen) {
  const float* wp = wt + QQ * tq;
  int zoff[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) zoff[i] = rows[i] * ep + jz;
#pragma unroll 1
  for (int j = 0; j < jlen; j += 8) {
    const bool two = j + 4 < jlen;
    const int jb = two ? j + 4 : j;
    float4 za[RR], zb[RR];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      za[i] = *reinterpret_cast<const float4*>(z + zoff[i] + j);
      zb[i] = *reinterpret_cast<const float4*>(z + zoff[i] + jb);
    }
    fma_step<RR, QQ>(acc, za, wp + j * kt, kt);
    if (two) fma_step<RR, QQ>(acc, zb, wp + jb * kt, kt);
  }
}

// The piece's rows [r0, r0 + nr) of the tile times W, into y: thread
// (row group tr, column group tq) owns rows tr, tr + TR, ... (RR of them;
// a row past the piece repeats its last row and is not written) and
// coefficients QQ tq .. QQ tq + QQ - 1 of each k-tile (QQ = 1 spreads a
// tile of few outputs, a serve batch's, over more threads, each with a
// shorter chain of FMAs to wait on). A streamed W's chunks run
// through two slots, chunk 0 started by the caller into slot 0: at each
// chunk every thread waits for its copies, meets the others at a barrier,
// starts the next chunk into the other slot (after the last one, the next
// piece's samples: stage_next, whose copies would otherwise hold up each
// chunk's wait), then contracts the chunk.
template <int RR, int QQ, Precision P, class Sample, class Next>
__device__ __forceinline__ void contract_piece(const AnyLaunch<Sample>& a, int r0, int nr,
                                               const Next& stage_next) {
  const int kt_log2 = window_features::kt_log2(a.p);
  const int kt = 1 << kt_log2;
  const int tq = threadIdx.x & ((1 << a.p.tq_log2) - 1);
  const int tr = threadIdx.x >> a.p.tq_log2;
  const int TR = kThreads >> a.p.tq_log2;
  const int e4 = round4(a.epoch);
  const int nk = k_tiles(a.p, a.features);
  const int F = a.features;
  int rows[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) rows[i] = min(tr + i * TR, nr - 1);
  // the warp's first row: a warp with no row of the piece skips the FMAs
  const bool active = (static_cast<int>(threadIdx.x & ~31u) >> a.p.tq_log2) < nr;
  const bool resident = a.p.jc == 0;
  const int per_slot = a.p.jc << kt_log2;
  int chunk = 0;
  for (int k = 0; k < nk; ++k) {
    float acc[RR][QQ];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
#pragma unroll
      for (int q = 0; q < QQ; ++q) acc[i][q] = 0.0f;
    }
    if (resident) {
      if (active) {
        fma_span<RR, QQ>(acc, a.z, a.p.ep, rows, 0, a.wsm + static_cast<size_t>(k) * e4 * kt,
                         kt, tq, e4);
      }
    } else {
#pragma unroll 1
      for (int j0 = 0; j0 < e4; j0 += a.p.jc) {
        float* wslot = a.wsm + (chunk & 1) * per_slot;
        wait_async<0>();
        round_chunk<P>(a, wslot);
        __syncthreads();  // the chunk visible; the other slot's chunk done
        const bool next_k = j0 + a.p.jc >= e4;
        if (!next_k || k + 1 < nk) {
          start_chunk(a, next_k ? k + 1 : k, next_k ? 0 : j0 + a.p.jc,
                      a.wsm + ((chunk + 1) & 1) * per_slot);
        } else {
          stage_next(0);
        }
        if (active) {
          fma_span<RR, QQ>(acc, a.z, a.p.ep, rows, j0, wslot, kt, tq, min(a.p.jc, e4 - j0));
        }
        ++chunk;
      }
    }
    const int col = (k << kt_log2) + QQ * tq;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int r = tr + i * TR;
      if (r < nr) {
        float* yr = a.y + static_cast<size_t>(r0 + r) * F;
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (col + q < F) yr[col + q] = acc[i][q];
        }
      }
    }
  }
}

// contract_piece at the plan's rows a thread (RR = 3 only where
// max_rows allows it, so the float32-sample kernels hold no such code).
template <int QQ, Precision P, class Sample, class Next>
__device__ __forceinline__ void contract_rows(const AnyLaunch<Sample>& a, int r0, int nr,
                                              const Next& stage_next) {
  if (a.p.rr == 1) {
    contract_piece<1, QQ, P>(a, r0, nr, stage_next);
  } else if constexpr (max_rows<Sample>() == 2) {
    contract_piece<2, QQ, P>(a, r0, nr, stage_next);
  } else if (a.p.rr == 2) {
    contract_piece<2, QQ, P>(a, r0, nr, stage_next);
  } else {
    contract_piece<3, QQ, P>(a, r0, nr, stage_next);
  }
}

// A window's row yr (nfeat floats) in shared memory divided by
// max(norm, 1e-30), on the calling warp: the sum of squares in double,
// lanes strided, then a butterfly (every lane holds the same sum).
__device__ __forceinline__ void normalize_row(float* yr, int nfeat, int lane) {
  double ss = 0.0;
  for (int i = lane; i < nfeat; i += 32) {
    const double v = yr[i];
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float denom = fmaxf(static_cast<float>(sqrt(ss)), 1e-30f);
  for (int i = lane; i < nfeat; i += 32) yr[i] = yr[i] / denom;
}

// The group of coefficient k: 0 for k = 0, else 1 + floor(log2 k).
__device__ __forceinline__ int subband_group(int k) { return k == 0 ? 0 : 32 - __clz(k); }

// The quantize step of the int8 and int4 rungs on the tile's first nw
// normalized rows, in two halves between barriers. The first: each
// subband group's largest magnitude by one thread (exact in any order)
// into gmax, thread t of `threads` taking groups t, t + threads, ...
__device__ __forceinline__ void group_maxima(const float* y, float* gmax, int nw, int channels,
                                             int features, int t, int threads) {
  const int ng = subband_groups(features);
  const int pairs = nw * channels * ng;
  for (int q = t; q < pairs; q += threads) {
    const int g = q % ng;
    const int lo = g == 0 ? 0 : 1 << (g - 1);
    const int hi = g == 0 ? 1 : ((1 << g) < features ? (1 << g) : features);
    const float* yc = y + static_cast<size_t>(q / ng) * features;
    float m = 0.0f;
    for (int k = lo; k < hi; ++k) m = fmaxf(m, fabsf(yc[k]));
    gmax[q] = m;
  }
}

// The second, once the maxima are visible: quantize_feature on every
// element, thread t of `threads` taking elements t, t + threads, ...
template <Precision P>
__device__ __forceinline__ void quantize_elements(float* y, const float* gmax, int nw,
                                                  int channels, int features, int t,
                                                  int threads) {
  const int ng = subband_groups(features);
  const int n = nw * channels * features;
  for (int i = t; i < n; i += threads) {
    const int cw = i / features;  // the (window, channel) row
    y[i] = quantize_feature<P>(y[i], gmax[cw * ng + subband_group(i - cw * features)]);
  }
}

// Both halves by the whole block (the phase-by-phase design).
template <Precision P>
__device__ __forceinline__ void quantize_rows(float* y, float* gmax, int nw, int channels,
                                              int features) {
  group_maxima(y, gmax, nw, channels, features, threadIdx.x, kThreads);
  __syncthreads();  // the maxima visible
  quantize_elements<P>(y, gmax, nw, channels, features, threadIdx.x, kThreads);
  __syncthreads();  // the quantized rows visible
}

// Walk this block's tiles (tile = blockIdx.x, + gridDim.x, ...), each as
// its pieces. `Windows` supplies start(row) and finish(row, y, nfeat,
// lane), which the warp finishing window `row` calls with its row in
// shared memory. Per piece: barrier 1 (its staged samples landed, z free),
// means and centre, barrier 2 (z visible, the slot free), the next piece's
// staging started, the contraction; at a tile's last piece barrier 3 (y
// visible) and the epilogue.
template <class Sample, Precision P, class Windows>
__device__ __forceinline__ void run_tiles_any(void* smem, const StreamView<Sample>& v,
                                              const float* __restrict__ res,
                                              const float* __restrict__ w, int rows, int pre,
                                              int skip, int epoch, int features,
                                              const AnyPlan& plan, const Windows& win) {
  AnyLaunch<Sample> a{v, res, w, rows, pre, skip, epoch, features, plan,
                      nullptr, nullptr, nullptr, nullptr, nullptr};
  const int e4 = round4(epoch);
  const int kt = k_tile(plan);
  const size_t w_floats = plan.jc == 0
                              ? static_cast<size_t>(k_tiles(plan, features)) * e4 * kt
                              : 2 * static_cast<size_t>(plan.jc) * kt;
  a.wsm = static_cast<float*>(smem);
  a.z = a.wsm + w_floats;
  a.slot = reinterpret_cast<char*>(a.z + static_cast<size_t>(plan.rz) * plan.ep);
  a.y = reinterpret_cast<float*>(
      a.slot + static_cast<size_t>(plan.rz) * (plan.base_chunks + plan.seg_chunks) * kChunkBytes);
  a.gmax = a.y + static_cast<size_t>(plan.m) * v.channels * features;

  const int C = v.channels;
  const int tile_rows = plan.m * C;
  const int pieces = (tile_rows + plan.rz - 1) / plan.rz;
  const int tiles = (rows + plan.m - 1) / plan.m;
  const bool staged = plan.seg_chunks != 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  auto piece_rows = [&](int p) { return min(plan.rz, tile_rows - p * plan.rz); };

  int tile = blockIdx.x;
  if (tile >= tiles) return;
  if (staged) stage_piece(a, tile, 0, piece_rows(0), 0, kWarps, win);
  if (plan.jc == 0) {
    load_resident_w<P>(a);
    if constexpr (P == Precision::kBf16) {
      // W's copies (and the first piece's samples) landed, then rounded
      wait_async<0>();
      __syncthreads();
      round_w_bf16(a.wsm, k_tiles(plan, features) * (e4 << kt_log2(plan)));
    }
  } else {
    commit_async();
  }
  for (; tile < tiles; tile += gridDim.x) {
    for (int p = 0; p < pieces; ++p) {
      const int r0 = p * plan.rz;
      const int nr = piece_rows(p);
      wait_async<0>();
      __syncthreads();  // barrier 1: the piece's samples landed, z and W's slots free
      if (plan.jc != 0) start_chunk(a, 0, 0, a.wsm);
      centre_piece<Sample, P>(a, tile, r0, nr, win);
      __syncthreads();  // barrier 2: z visible, the slot free
      // the next piece's samples: after barrier 2 where W is resident, else
      // after the last chunk's copies are started
      auto stage_next = [&](int w0) {
        if (!staged) return;
        if (p + 1 < pieces) {
          stage_piece(a, tile, r0 + plan.rz, piece_rows(p + 1), w0, kWarps - w0, win);
        } else if (tile + static_cast<int>(gridDim.x) < tiles) {
          stage_piece(a, tile + gridDim.x, 0, piece_rows(0), w0, kWarps - w0, win);
        }
        commit_async();
      };
      // with W resident, the warps the contraction leaves idle (those past
      // the piece's rows) stage, where there are any
      if (plan.jc == 0) {
        const int busy =
            min(kWarps, ((min(nr, kThreads >> plan.tq_log2) << plan.tq_log2) + 31) / 32);
        stage_next(busy < kWarps ? busy : 0);
      }
      if (plan.qq == 1) {
        contract_rows<1, P>(a, r0, nr, stage_next);
      } else {
        contract_rows<4, P>(a, r0, nr, stage_next);
      }
    }
    __syncthreads();  // barrier 3: the tile's rows visible
    // the epilogue: each window's norm on a warp; for the int8 and int4
    // rungs the quantize step by the whole block; the caller's finish on
    // a warp a window
    const int nw = min(plan.m, rows - tile * plan.m);
    const int nfeat = C * features;
    for (int wi = warp; wi < nw; wi += kWarps) {
      normalize_row(a.y + static_cast<size_t>(wi) * nfeat, nfeat, lane);
    }
    if constexpr (quantized(P)) {
      __syncthreads();  // the normalized rows visible
      quantize_rows<P>(a.y, a.gmax, nw, C, features);
    } else {
      __syncwarp();
    }
    for (int wi = warp; wi < nw; wi += kWarps) {
      win.finish(tile * plan.m + wi, a.y + static_cast<size_t>(wi) * nfeat, nfeat, lane);
    }
  }
}


// ---------------------------------------------------------------------------
// The ring design, run_tiles_ring: a block of kRingThreads threads in two
// roles, handing work on through a ring of `slots` chunk slots in shared
// memory. One engine for both sample types: only the copies of a chunk's
// rows (row_chunks) and the centring of a row in place differ.

constexpr int kRingThreads = 384;
constexpr int kConsumerThreads = 256;  // warps 0-7: the contraction and the copies
constexpr int kCentreWarp0 = 8;        // warps 8-11: means, centre, epilogue
constexpr int kCentreWarps = 4;
constexpr int kCentreThreads = kCentreWarps * 32;
// A chunk: 32 samples of every row of a piece, and W's 32 rows of a
// k-tile. A row's region of a slot holds the 16-byte chunks of the address
// space that cover its 32 samples from any offset (row_chunks: 9 of float32
// samples, 5 of int16), and its 32 centred samples in place of them once
// centred: a stride of 36 floats, 4 mod 32, so a warp's float4 reads of 8
// consecutive rows hit distinct banks.
constexpr int kChunkJ = 32;
constexpr int kRowFloats = 36;
constexpr int kMaxSlots = 4;
// Shared memory before the ring: the slots' mbarriers and the baseline's.
constexpr int kBarrierBytes = 64;

// The raw 16-byte chunks of a row a slot holds, and how many of them one
// chunk of j advances.
template <class Sample>
__host__ __device__ constexpr int row_chunks() {
  return segment_chunks<Sample>(kChunkJ);
}
template <class Sample>
__host__ __device__ constexpr int chunk_step() {
  return kChunkJ / chunk_samples<Sample>();
}
static_assert(row_chunks<float>() * 4 <= kRowFloats && row_chunks<int16_t>() * 4 <= kRowFloats,
              "a row's raw chunks fit its region");

// Named barriers (0 is __syncthreads). Those between the two roles are
// met by whole warps, one side arriving (bar.arrive: it goes on), the
// other waiting.
constexpr int kZReady = 1;      // + slot: the slot centred; centring arrive, consumers wait
constexpr int kSlotRead = 5;    // + slot: the slot contracted; the consumers that copy the
                                // next chunk into it wait, the others arrive
constexpr int kBaseFree = 9;    // a piece's means taken; centring arrive, consumers wait
constexpr int kYFull = 10;      // a tile's rows written; consumers arrive, centring waits
constexpr int kYFree = 11;      // a tile's epilogue done; centring arrive, consumers wait
constexpr int kCentreBar = 12;  // the centring warps among themselves
constexpr int kPieceStart = 13; // the consumers among themselves: a piece's rows known
constexpr int kRoles = kConsumerThreads + kCentreThreads;

// A ring-design launch's tile plan (ops/generic_plan.py ring_tile_plan).
struct RingPlan {
  int m;            // windows a tile
  int rz;           // (window, channel) rows a piece
  int rr;           // rows a consumer thread contracts: 1, 4 or 8
  int qq;           // coefficients a consumer thread contracts: 1 (rr 1) or 4
  int tq;           // consumer threads across a k-tile: kt = qq * tq coefficients
  int slots;        // ring slots, 1 to kMaxSlots
  int base_floats;  // a row's staged baseline (4 floats a 16-byte chunk), 0: the means
                    // read device memory
};

// The two designs of the generic engine, chosen per launch by the plan's
// first field (ops/generic_plan.py generic_tile_plan) and instantiated as
// a template argument of each kernel: the phase-by-phase design
// (run_tiles_any, AnyPlan; 256 threads, two blocks a multiprocessor) and
// the ring design (run_tiles_ring, RingPlan; 384 threads, one block).
constexpr int kPhaseDesign = 0;
constexpr int kRingDesign = 1;
// A plan's ints, in the order the launchers take them: the design, then
// its AnyPlan (9) or RingPlan (7) fields.
constexpr int kPlanFields = 10;

template <int kDesign>
using DesignPlan = std::conditional_t<kDesign == kRingDesign, RingPlan, AnyPlan>;

// Threads a block and blocks a multiprocessor of each design's kernels
// (__launch_bounds__): 384 and one for the ring design (168 registers a
// thread), 256 and two (128 registers) for the phase-by-phase one.
template <int kDesign>
__host__ __device__ constexpr int design_threads() {
  return kDesign == kRingDesign ? kRingThreads : kThreads;
}
template <int kDesign>
__host__ __device__ constexpr int design_min_blocks() {
  return kDesign == kRingDesign ? 1 : kAnyMinBlocksPerSm;
}

// The fields of `design`'s plan in a launch's plan ints (after its design
// field), or null where the plan is missing or of another design.
inline const int* design_fields(const int* plan, int design) {
  return plan != nullptr && plan[0] == design ? plan + 1 : nullptr;
}

__host__ __device__ inline int ring_kt(const RingPlan& p) { return p.qq * p.tq; }
__host__ __device__ inline int ring_slot_floats(const RingPlan& p) {
  return p.rz * kRowFloats + kChunkJ * ring_kt(p);
}

// Words a row of a piece keeps beside the ring: two window starts (one a
// piece, alternately), its mean, resolution, analysis segment and offset,
// and the first chunks of its analysis segment and baseline.
constexpr int kRowWords = 8;

// Shared memory of a plan: the mbarriers, the ring's slots (each the
// piece's rows, then W's chunk), the staged baselines, the tile's rows y
// and their subband groups' maxima, and kRowWords a row of the piece.
inline size_t ring_plan_smem_bytes(const RingPlan& p, int channels, int features) {
  const size_t rows = static_cast<size_t>(p.m) * channels;
  const size_t floats = static_cast<size_t>(p.slots) * ring_slot_floats(p) +
                        static_cast<size_t>(p.rz) * p.base_floats +
                        rows * (features + subband_groups(features)) +
                        kRowWords * static_cast<size_t>(p.rz);
  return kBarrierBytes + floats * sizeof(float);
}

// check_any_plan for the ring design: the same refusal
// (kSharedMemoryExceeded where any_smem_bytes exceeds the limit), then the
// plan's consistency and fit.
template <class Sample>
int check_ring_plan(const int* fields, int channels, int epoch, int features, int pre,
                    RingPlan* plan, size_t* smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(max_optin);
  if (any_smem_bytes(channels, epoch, features) > limit) return kSharedMemoryExceeded;
  if (fields == nullptr) return cudaErrorInvalidValue;
  const RingPlan p{fields[0], fields[1], fields[2], fields[3], fields[4], fields[5], fields[6]};
  const bool tile = (p.rr == 1 && p.qq == 1 && p.tq >= 4 && p.tq <= 64 && p.tq % 4 == 0) ||
                    ((p.rr == 4 || p.rr == 8) && p.qq == 4 && p.tq >= 1 && p.tq <= 16);
  const bool ok = tile && p.m >= 1 && p.m <= 1024 && p.rz >= 1 &&
                  p.rz <= p.rr * (kConsumerThreads / p.tq) &&
                  static_cast<long long>(p.rz) <= static_cast<long long>(p.m) * channels &&
                  p.slots >= 1 && p.slots <= kMaxSlots &&
                  (p.base_floats == 0 || p.base_floats == 4 * segment_chunks<Sample>(pre));
  if (!ok) return cudaErrorInvalidValue;
  *smem = ring_plan_smem_bytes(p, channels, features);
  if (*smem > limit) return cudaErrorInvalidValue;
  *plan = p;
  return cudaSuccess;
}

// A design's plan check: the refusal first, then a missing plan or one of
// another design (fields null) is cudaErrorInvalidValue.
template <int kDesign, class Sample>
int check_plan(const int* fields, int channels, int epoch, int features, int pre,
               DesignPlan<kDesign>* plan, size_t* smem) {
  if constexpr (kDesign == kRingDesign) {
    return check_ring_plan<Sample>(fields, channels, epoch, features, pre, plan, smem);
  } else {
    return check_any_plan<Sample>(fields, channels, epoch, features, pre, plan, smem);
  }
}

// plan_grid for a generic kernel of `threads` threads a block.
template <class Kernel>
cudaError_t plan_grid_threads(Kernel kernel, int threads, size_t smem, int tiles, int* grid) {
  if (threads == kThreads) return plan_grid(kernel, smem, tiles, grid);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(tiles < want ? tiles : want);
  return cudaSuccess;
}

// A named barrier met by whole warps: the warp reconverged first (a role's
// loops may leave its lanes apart), then bar.sync (wait) or bar.arrive
// (arrive and go on), which order this thread's shared-memory accesses
// before those of the threads that wait.
__device__ __forceinline__ void role_sync(int id, int threads) {
  __syncwarp();
  named_sync(id, threads);
}

__device__ __forceinline__ void role_arrive(int id, int threads) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_address(bar)),
               "r"(arrivals)
               : "memory");
}

// An arrival on `bar`, releasing this thread's earlier stores.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_address(bar)) : "memory");
}

// An arrival on `bar` once this thread's cp.async copies so far have
// landed (counted in the barrier's arrivals: .noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_address(bar))
               : "memory");
}

// A waiting thread may sleep in the barrier up to this long (ns) before it
// checks again, rather than spin through the shared-memory pipe the
// consumers' loads use.
constexpr unsigned kSuspendNs = 0x989680;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      "  .reg .pred done;\n"
      "WAIT_%=:\n"
      "  mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1, %2;\n"
      "  @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(parity), "r"(kSuspendNs)
      : "memory");
}

// cp.async of 16 and of 4 bytes for the copying warps. Unlike copy_async16
// and copy_async4 they do not order the thread's other memory accesses
// (no "memory" clobber), so its loads of the next chunk's addresses are
// not held back behind each copy; the copies stay in order among
// themselves and before the arrival that tracks them (volatile asm).
__device__ __forceinline__ void stage16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_address(dst)), "l"(src));
}

__device__ __forceinline__ void stage4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_address(dst)), "l"(src));
}

// What the roles read of a launch, with the pieces of the carve.
template <class Sample>
struct RingLaunch {
  StreamView<Sample> v;
  const float* __restrict__ res;
  const float* __restrict__ w;
  int rows;
  int pre;
  int skip;
  int epoch;
  int features;
  RingPlan p;
  uint64_t* bars;  // [kMaxSlots] the slots' copies, then [1] the baselines'
  float* ring;     // [slots][rz x kRowFloats + kChunkJ x kt]
  float* base;     // [rz][base_floats]  the piece's staged baselines (raw 16-byte chunks)
  float* y;        // [m][channels * features]  the tile's rows
  float* gmax;     // [m][channels][subband groups]
  int* starts;     // [2][rz]  the window starts of a piece's rows (by piece parity)
  float2* rcm;     // [rz]  a row's resolution and mean (0 and 0 past the launch's end)
  int2* seg;       // [rz]  its analysis segment's in-row samples (lo | hi << 16; none: 0)
                   //       and offset in its first chunk (in samples)
  int* chunk0;     // [rz]  the 16-byte chunk holding its analysis segment's first sample
  int* base0;      // [rz]  and its baseline's (kNoRow: a row past the launch's end)
  uintptr_t xb;    // the 16-byte chunk holding the sample tensor's first byte
  int xoff;        // the tensor's first byte within that chunk
  uintptr_t xlo;   // the tensor's bytes, widened to whole 4-byte words: the first
  uintptr_t xhi;   // and one past the last

  __device__ __forceinline__ int tile_rows() const { return p.m * v.channels; }
  __device__ __forceinline__ int pieces() const { return (tile_rows() + p.rz - 1) / p.rz; }
  __device__ __forceinline__ int k_tiles() const {
    return (features + ring_kt(p) - 1) / ring_kt(p);
  }
  __device__ __forceinline__ int chunks() const { return (epoch + kChunkJ - 1) / kChunkJ; }
  __device__ __forceinline__ int tiles() const { return (rows + p.m - 1) / p.m; }
  __device__ __forceinline__ bool last_tile(int tile) const {
    return tile + static_cast<int>(gridDim.x) >= tiles();
  }
  __device__ __forceinline__ float* slot(int s) const {
    return ring + static_cast<size_t>(s) * ring_slot_floats(p);
  }
  // The consumer warps a piece of nr rows keeps busy, and the first warp
  // of those that copy the chunks ahead while it is contracted: the warps
  // it leaves idle, or all of them where it leaves fewer than two.
  __device__ __forceinline__ int busy_warps(int nr) const {
    const int tre = (nr + p.rr - 1) / p.rr;
    return (tre * p.tq + 31) / 32;
  }
  __device__ __forceinline__ int copy_warp0(int nr) const {
    const int busy = busy_warps(nr);
    return kConsumerThreads / 32 - busy >= 2 ? busy : 0;
  }
  // The threads that meet at a chunk's ready barrier: the centring warps
  // and the consumer warps that read the chunk (all but those that copy,
  // where those are apart).
  __device__ __forceinline__ int ready_threads(int nr) const {
    const int w0 = copy_warp0(nr);
    return (w0 > 0 ? w0 * 32 : kConsumerThreads) + kCentreThreads;
  }
  // the launch row (window) of row tr of `tile`, and its channel
  __device__ __forceinline__ int window_of(int tile, int tr, int* c) const {
    const int wi = tr / v.channels;
    *c = tr - wi * v.channels;
    return tile * p.m + wi;
  }
  // the index, from xb, of the 16-byte chunk holding sample j of channel c
  // (j may lie outside the row, the chunk outside the tensor)
  __device__ __forceinline__ int chunk_of(int c, long long j) const {
    const long long byte = static_cast<long long>(xoff) +
                           (static_cast<long long>(c) * v.n + j) *
                               static_cast<long long>(sizeof(Sample));
    return static_cast<int>(byte >> 4);
  }
  // Start copying chunk i into dst: a chunk inside the tensor is one
  // 16-byte cp.async; of one across either end of it, its 4-byte words
  // that hold a byte of the tensor one 4-byte cp.async each (an int16
  // tensor may start or end inside a word: its other half, in the same
  // word of the same allocation, holds no sample of any row and is masked
  // where it is read); one outside it, nothing (its samples lie outside
  // every row, masked where they are read).
  __device__ __forceinline__ void copy_chunk(int i, float* dst) const {
    const uintptr_t at = xb + static_cast<uintptr_t>(static_cast<long long>(i) * 16);
    if (at >= xlo && at + 16 <= xhi) {
      stage16(dst, reinterpret_cast<const void*>(at));
    } else if (at + 16 > xlo && at < xhi) {
      for (int u = 0; u < 4; ++u) {
        const uintptr_t f = at + 4 * u;
        if (f >= xlo && f < xhi) stage4(dst + u, reinterpret_cast<const void*>(f));
      }
    }
  }
};

constexpr int kNoRow = -2147483647 - 1;

// Where the block's chunk q lies: its tile, piece (pc: among the block's
// pieces), k-tile and chunk of j. (Computed afresh for each chunk copied:
// the consumers keep only q across their loop, which leaves the registers
// to the contraction.)
struct StageCursor {
  int q;
  int tile;
  int piece;
  int pc;
  int k;
  int cc;
};

template <class Sample>
__device__ __forceinline__ StageCursor chunk_at(const RingLaunch<Sample>& a, int q) {
  const int nc = a.chunks();
  const int per_piece = a.k_tiles() * nc;
  const int pc = q / per_piece;
  const int kc = q - pc * per_piece;
  const int t = pc / a.pieces();
  return StageCursor{q, static_cast<int>(blockIdx.x) + t * static_cast<int>(gridDim.x),
                     pc - t * a.pieces(), pc, kc / nc, kc % nc};
}

// The consumers' copies of the cursor's chunk into slot q % slots: the
// row_chunks 16-byte chunks of the address space from the one holding the
// chunk's first sample, for each row of its piece (consecutive threads on
// consecutive chunks of a row, so a warp's copies coalesce), copied whole,
// and W's 32 rows of its k-tile, by the consumer warps from warp w0 (those
// the piece being contracted leaves idle, or all); each of them arrives on
// the slot's mbarrier when its copies land, every other consumer at once.
// At a piece's first chunk every consumer first waits until the centring
// warps have taken the previous piece's means, writes the piece's window
// starts and the chunks of its rows to shared memory, and copies its rows'
// baselines (the baselines' mbarrier: each thread's arrival for its stores
// and one for its copies). The copies are spread over many warps because
// one warp issuing them all, or the copy engine fed one bulk copy a row,
// left the chunks waiting on their copies. Rows past the launch's end
// stage nothing.
template <class Sample, class Windows>
__device__ __forceinline__ void stage_chunk(const RingLaunch<Sample>& a, const StageCursor& at,
                                            int w0, const Windows& win) {
  constexpr int kRowChunks = row_chunks<Sample>();
  const int t = threadIdx.x;
  const int r0 = at.piece * a.p.rz;
  const int nr = min(a.p.rz, a.tile_rows() - r0);
  if (at.k == 0 && at.cc == 0) {
    uint64_t* base_bar = a.bars + kMaxSlots;
    // (every consumer meets here, so none still reads the last piece's
    // chunks when they are overwritten)
    if (at.pc > 0) role_sync(kBaseFree, kRoles);
    int* st = a.starts + (at.pc & 1) * a.p.rz;
    for (int r = t; r < nr; r += kConsumerThreads) {
      int c;
      const int row = a.window_of(at.tile, r0 + r, &c);
      const int start = row < a.rows ? win.start(row) : 0;
      st[r] = start;
      a.chunk0[r] = row < a.rows ? a.chunk_of(c, static_cast<long long>(start) + a.pre + a.skip)
                                 : kNoRow;
      a.base0[r] = row < a.rows ? a.chunk_of(c, start) : kNoRow;
    }
    role_sync(kPieceStart, kConsumerThreads);  // the piece's chunks known to every consumer
    // a row's baseline chunks on 8 consecutive threads
    const int base_chunks = a.p.base_floats / 4;
    for (int r = t / 8; r < nr; r += kConsumerThreads / 8) {
      const int b0 = a.base0[r];
      if (b0 == kNoRow) continue;
      for (int k = t % 8; k < base_chunks; k += 8) {
        a.copy_chunk(b0 + k, a.base + static_cast<size_t>(r) * a.p.base_floats + 4 * k);
      }
    }
    mbar_arrive(base_bar);  // the starts written
    mbar_arrive_on_copies(base_bar);
  }
  const int s = at.q % a.p.slots;
  uint64_t* bar = a.bars + s;
  if (t < w0 * 32) {
    mbar_arrive(bar);
    return;
  }
  const int u0 = t - w0 * 32;
  const int n = kConsumerThreads - w0 * 32;
  float* zs = a.slot(s);
  float* ws = zs + a.p.rz * kRowFloats;
  const int kt = ring_kt(a.p);
  const int j0 = at.cc * kChunkJ;
  for (int i = u0; i < nr * kRowChunks; i += n) {
    const int r = i / kRowChunks;
    const int u = i - r * kRowChunks;
    const int c0 = a.chunk0[r];
    if (c0 != kNoRow) {
      a.copy_chunk(c0 + at.cc * chunk_step<Sample>() + u, zs + r * kRowFloats + 4 * u);
    }
  }
  const int rows_w = min(kChunkJ, a.epoch - j0);
  if (kt == a.features && kt % 4 == 0 &&
      reinterpret_cast<uintptr_t>(a.w) % kChunkBytes == 0) {
    // W's chunk is one contiguous run where a k-tile spans every coefficient
    const float* src = a.w + static_cast<long long>(j0) * kt;
    for (int i = u0; i < rows_w * kt / 4; i += n) stage16(ws + 4 * i, src + 4 * i);
  } else {
    const int col0 = at.k * kt;
    const int ncols = min(kt, a.features - col0);
    for (int i = u0; i < rows_w * ncols; i += n) {
      const int jr = i / ncols;
      const int col = i - jr * ncols;
      stage4(ws + jr * kt + col, a.w + static_cast<long long>(j0 + jr) * a.features + col0 + col);
    }
  }
  mbar_arrive_on_copies(bar);
}

// The epilogue of a tile's first nw windows by `warps` warps from warp
// w0 (t: the thread's index among them; sync: their barrier): each
// window's norm on a warp (normalize_row), for the int8 and int4 rungs the
// quantize step by all of them, the caller's finish on a warp a window.
template <Precision P, class Sample, class Windows, class Sync>
__device__ __forceinline__ void ring_finish(const RingLaunch<Sample>& a, int tile, int w0,
                                            int warps, const Sync& sync, const Windows& win) {
  const int t = threadIdx.x - w0 * 32;
  const int warp = t / 32;
  const int lane = t % 32;
  const int C = a.v.channels;
  const int nw = min(a.p.m, a.rows - tile * a.p.m);
  const int nfeat = C * a.features;
  for (int wi = warp; wi < nw; wi += warps) {
    normalize_row(a.y + static_cast<size_t>(wi) * nfeat, nfeat, lane);
  }
  if constexpr (quantized(P)) {
    sync();  // the normalized rows visible
    group_maxima(a.y, a.gmax, nw, C, a.features, t, warps * 32);
    sync();  // the maxima visible
    quantize_elements<P>(a.y, a.gmax, nw, C, a.features, t, warps * 32);
    sync();  // the quantized rows visible
  } else {
    __syncwarp();
  }
  for (int wi = warp; wi < nw; wi += warps) {
    win.finish(tile * a.p.m + wi, a.y + static_cast<size_t>(wi) * nfeat, nfeat, lane);
  }
}

// A piece's rows' resolutions, then their means and where their analysis
// segments lie, by `threads` threads (t: this one's index among them;
// sync: their barrier), once the piece's baselines have landed. The means:
// group g of 4 lanes on rows g, g + threads / 4, ..., lane l4 summing
// lane_baseline_sum's lanes l4 and l4 + 4 and adding them, the first step
// of that function's butterfly over 8 lanes, then the other two steps over
// the 4 (double addition commutes, so every mean is the 8-lane one bit for
// bit); the loop's trip count is the warps', so every lane reaches each
// butterfly.
template <class Sample, class Sync>
__device__ __forceinline__ void piece_means(const RingLaunch<Sample>& a, int tile, int r0, int nr,
                                            const int* st, int t, int threads,
                                            const Sync& sync) {
  for (int r = t; r < nr; r += threads) {
    int c;
    const int row = a.window_of(tile, r0 + r, &c);
    a.rcm[r].x = row < a.rows ? a.res[c] : 0.0f;
  }
  sync();  // the resolutions visible
  constexpr int kMeanLanes = kRowLanes / 2;
  const int l4 = t % kMeanLanes;
  for (int rb = 0; rb < nr; rb += threads / kMeanLanes) {
    const int r = rb + t / kMeanLanes;
    int c = 0;
    const int row = r < nr ? a.window_of(tile, r0 + r, &c) : a.rows;
    const bool valid = row < a.rows;
    double sum = 0.0;
    if (valid) {
      const int start = st[r];
      const float rcv = a.rcm[r].x;
      const InRow in(start, a.pre, a.v.n);
      // (each call site reads one memory space: shared or global loads)
      if (a.p.base_floats) {
        const Sample* b =
            reinterpret_cast<const Sample*>(a.base + static_cast<size_t>(r) * a.p.base_floats) +
            a.v.offset(c, start);
        sum = lane_baseline_sum(b, in, a.pre, rcv, l4) +
              lane_baseline_sum(b, in, a.pre, rcv, l4 + kMeanLanes);
      } else {
        const Sample* b = a.v.raw + static_cast<long long>(c) * a.v.n + start;
        sum = lane_baseline_sum(b, in, a.pre, rcv, l4) +
              lane_baseline_sum(b, in, a.pre, rcv, l4 + kMeanLanes);
      }
    }
#pragma unroll
    for (int off = kMeanLanes / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (r < nr && l4 == 0) {
      int2 seg = make_int2(0, 0);
      if (valid) {
        const long long first = static_cast<long long>(st[r]) + a.pre + a.skip;
        const InRow in(first, a.epoch, a.v.n);
        seg.x = static_cast<int>(static_cast<unsigned>(in.lo) |
                                 (static_cast<unsigned>(in.hi) << 16));
        seg.y = a.v.offset(c, first);
      }
      a.rcm[r].y = valid ? static_cast<float>(sum / static_cast<double>(a.pre)) : 0.0f;
      a.seg[r] = seg;
    }
  }
  sync();  // the means visible
}

// Four staged int16 samples, s0 .. s0 + 3 of a row's region (its raw
// 16-byte chunks from `x32`, 32-bit words; s0 from 0), as floats by
// integer operations: two words' pairs aligned by a byte permute (s0 odd)
// or taken as they are, then each sample's offset binary placed under
// 2^23's exponent (0x4B000000 | (x + 2^15), x + 2^15 = x ^ 0x8000 in 16
// bits) and 2^23 + 2^15 subtracted, exactly: sample_value's bits.
__device__ __forceinline__ void int16_quad(const unsigned* x32, int s0, float (&x)[4]) {
  const unsigned* xw = x32 + (s0 >> 1);
  const unsigned w0 = xw[0];
  const unsigned w1 = xw[1];
  const unsigned w2 = xw[2];
  const unsigned sel = (s0 & 1) ? 0x5432u : 0x3210u;
  const unsigned pair[2] = {__byte_perm(w0, w1, sel) ^ 0x80008000u,
                            __byte_perm(w1, w2, sel) ^ 0x80008000u};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned bits = __byte_perm(pair[u >> 1], 0x4B000000u, (u & 1) ? 0x7632u : 0x7610u);
    x[u] = __fsub_rn(__uint_as_float(bits), 8421376.0f);
  }
}

// The centring warps. Per piece (but the block's first, whose means the
// whole block takes), once its baselines have landed: piece_means. Then
// per chunk, once its copies have landed, z = x - mean over the row's
// staged samples in place, a row on 8 lanes (a warp's four rows two apart,
// so its float reads hit distinct banks), two rounds of 16 rows at a
// time, all loaded before any is stored; for kBf16 rounded, and W's chunk
// rounded too. Float32 samples: lane l8 on samples l8, l8 + 8, ...; int16
// samples: lane l8 on samples 4 l8 .. 4 l8 + 3 (three 32-bit loads, the
// conversion by integer operations, one 16-byte store). A tile's epilogue
// (but the block's last, which the whole block runs) runs once the chunk
// `slots` chunks into the next tile is centred: so it overlaps the next
// tile's contraction, and the consumers' copies, which run that far ahead,
// never wait on it.
template <Precision P, class Sample, class Windows>
__device__ __forceinline__ void ring_centring(const RingLaunch<Sample>& a, const Windows& win) {
  constexpr bool kInt16 = sizeof(Sample) == 2;
  const int ct = threadIdx.x - kCentreWarp0 * 32;
  const int cw = ct / 32;
  const int lane = ct % 32;
  const int l8 = lane % kRowLanes;
  const int S = a.p.slots;
  const int nk = a.k_tiles();
  const int nc = a.chunks();
  const int pieces = a.pieces();
  constexpr int kRound = kCentreThreads / kRowLanes;  // rows at once: 16
  // this lane's row of each 16: warp cw on rows (cw & 1) + 2 g + 8 (cw >> 1)
  const int rl = (cw & 1) + 2 * (lane / kRowLanes) + 8 * (cw >> 1);
  const int tile_chunks = pieces * nk * nc;
  const int tiles_here = (a.tiles() - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  uint64_t* base_bar = a.bars + kMaxSlots;
  auto centre_sync = [] { role_sync(kCentreBar, kCentreThreads); };
  int epilogues = 0;  // the block's tiles finished so far (but the last)
  auto epilogue = [&] {
    role_sync(kYFull, kRoles);
    ring_finish<P>(a, blockIdx.x + epilogues * gridDim.x, kCentreWarp0, kCentreWarps,
                   centre_sync, win);
    role_arrive(kYFree, kRoles);
    ++epilogues;
  };
  int q = 0;
  int pc = 0;
  for (int tile = blockIdx.x; tile < a.tiles(); tile += gridDim.x) {
    for (int p = 0; p < pieces; ++p, ++pc) {
      const int r0 = p * a.p.rz;
      const int nr = min(a.p.rz, a.tile_rows() - r0);
      if (pc > 0) {
        mbar_wait(base_bar, pc & 1);
        centre_sync();  // the last piece's chunks centred: its rows' words free
        piece_means(a, tile, r0, nr, a.starts + (pc & 1) * a.p.rz, ct, kCentreThreads,
                    centre_sync);
      }
      role_arrive(kBaseFree, kRoles);
      const int ready = a.ready_threads(nr);
      for (int k = 0; k < nk; ++k) {
        for (int cc = 0; cc < nc; ++cc, ++q) {
          const int s = q % S;
          mbar_wait(a.bars + s, (q / S) & 1);
          float* zs = a.slot(s);
          const int j0 = cc * kChunkJ;
          const int len = min(kChunkJ, a.epoch - j0);
          for (int rb = 0; rb < nr; rb += 2 * kRound) {
            float z[2][4];
            int at[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rb + h * kRound + rl;
              const int rs = r < nr ? r : 0;
              at[h] = r < nr ? r * kRowFloats : -1;
              const int2 seg = a.seg[rs];
              const float2 rcm = a.rcm[rs];
              const int lo = static_cast<int>(static_cast<unsigned>(seg.x) & 0xffffu) - j0;
              const int hi = static_cast<int>(static_cast<unsigned>(seg.x) >> 16) - j0;
              // this lane's samples: 4 l8 + u (int16), l8 + 8 u (float32)
              float x[4];
              if constexpr (kInt16) {
                int16_quad(reinterpret_cast<const unsigned*>(zs + rs * kRowFloats),
                           seg.y + 4 * l8, x);
              } else {
                const float* x0 = zs + rs * kRowFloats + seg.y;
#pragma unroll
                for (int u = 0; u < 4; ++u) x[u] = x0[l8 + kRowLanes * u];
              }
              if (lo <= 0 && hi >= kChunkJ && len == kChunkJ) {
                // the whole chunk in the row: the common case
#pragma unroll
                for (int u = 0; u < 4; ++u) z[h][u] = __fsub_rn(__fmul_rn(x[u], rcm.x), rcm.y);
              } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int j = kInt16 ? 4 * l8 + u : l8 + kRowLanes * u;
                  const float xs = (j >= lo && j < hi) ? __fmul_rn(x[u], rcm.x) : 0.0f;
                  z[h][u] = j < len ? __fsub_rn(xs, rcm.y) : 0.0f;
                }
              }
              if constexpr (P == Precision::kBf16) {
#pragma unroll
                for (int u = 0; u < 4; ++u) z[h][u] = round_bf16(z[h][u]);
              }
            }
            __syncwarp();  // the rows' samples read before any is overwritten
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (at[h] >= 0) {
                if constexpr (kInt16) {
                  *reinterpret_cast<float4*>(zs + at[h] + 4 * l8) =
                      make_float4(z[h][0], z[h][1], z[h][2], z[h][3]);
                } else {
#pragma unroll
                  for (int u = 0; u < 4; ++u) zs[at[h] + l8 + kRowLanes * u] = z[h][u];
                }
              }
            }
          }
          if constexpr (P == Precision::kBf16) {
            float* ws = zs + a.p.rz * kRowFloats;
            for (int i = ct; i < kChunkJ * ring_kt(a.p); i += kCentreThreads) {
              ws[i] = round_bf16(ws[i]);
            }
          }
          role_arrive(kZReady + s, ready);
          while (epilogues < tiles_here - 1 && (epilogues + 1) * tile_chunks + S - 1 <= q) {
            epilogue();
          }
        }
      }
    }
  }
  while (epilogues < tiles_here - 1) epilogue();
}

// acc[i][q] += sum over j < jlen (a multiple of 4) of z[row_i][j] *
// w[j][QQ tq + q] in ascending j, w already at this thread's coefficients:
// 4 samples of each of the RR rows (float4s) and 4 rows of W a step.
template <int RR, int QQ>
__device__ __forceinline__ void fma_chunk(float (&acc)[RR][QQ], const float* z,
                                          const int (&off)[RR], const float* w, int kt,
                                          int jlen) {
  auto step = [&](int j) {
    float4 zv[RR];
#pragma unroll
    for (int i = 0; i < RR; ++i) zv[i] = *reinterpret_cast<const float4*>(z + off[i] + j);
    fma_step<RR, QQ>(acc, zv, w + j * kt, kt);
  };
  if (RR < 8 && jlen == kChunkJ) {
    // a whole chunk, unrolled so the next steps' loads fly during this
    // one's FMAs (the 8 x 4 tile is not: those loads would hold registers
    // it needs, and its kernels spilled)
#pragma unroll 4
    for (int j = 0; j < kChunkJ; j += 4) step(j);
  } else {
#pragma unroll 1
    for (int j = 0; j < jlen; j += 4) step(j);
  }
}

// The consumers: thread (row thread tr, column thread tq) of a piece owns
// rows tr, tr + TR, ... (RR of them, TR = ceil(rows / RR); a row past the
// piece repeats its last row and is not written; warps with no row skip the
// FMAs) and coefficients QQ tq .. QQ tq + QQ - 1 of each k-tile, and sums
// each output in registers over the chunks of the k-tile, one chain of
// FMAs from 0 in ascending j. Once all have read a slot, they start the
// copies of the chunk `slots` ahead into it (stage_chunk; `next` is the
// first chunk the block's start has not copied, `total` the block's
// chunks). At a k-tile's end each writes its outputs to y (the first write
// of a tile waits for the previous tile's epilogue); at a tile's end they
// hand y to the epilogue (the block's last tile: to the block).
template <int RR, int QQ, class Sample, class Windows>
__device__ __forceinline__ void ring_consumers(const RingLaunch<Sample>& a, int next, int total,
                                               const Windows& win) {
  const int t = threadIdx.x;
  const int TQ = a.p.tq;
  const int kt = QQ * TQ;
  const int tq = t % TQ;
  const int tr = t / TQ;
  const int first_tr = (t & ~31) / TQ;  // the warp's first thread's
  const int S = a.p.slots;
  const int F = a.features;
  const int e4 = round4(a.epoch);
  const int nk = a.k_tiles();
  const int nc = a.chunks();
  const int pieces = a.pieces();
  int q = 0;
  bool first_tile = true;
  for (int tile = blockIdx.x; tile < a.tiles(); tile += gridDim.x) {
    for (int p = 0; p < pieces; ++p) {
      const int r0 = p * a.p.rz;
      const int nr = min(a.p.rz, a.tile_rows() - r0);
      const int tre = (nr + RR - 1) / RR;
      int off[RR];
#pragma unroll
      for (int i = 0; i < RR; ++i) off[i] = min(tr + i * tre, nr - 1) * kRowFloats;
      const bool active = first_tr < tre;
      // the warps this piece leaves idle copy the chunks ahead (all of
      // them where it leaves fewer than two) and do not read them
      const int w0 = a.copy_warp0(nr);
      const bool copies = static_cast<int>(t / 32) >= w0;
      const bool reads = w0 == 0 || !copies;
      const int ready = a.ready_threads(nr);
      for (int k = 0; k < nk; ++k) {
        float acc[RR][QQ];
#pragma unroll
        for (int i = 0; i < RR; ++i) {
#pragma unroll
          for (int u = 0; u < QQ; ++u) acc[i][u] = 0.0f;
        }
        for (int cc = 0; cc < nc; ++cc, ++q) {
          const int s = q % S;
          if (reads) role_sync(kZReady + s, ready);
          const float* zs = a.slot(s);
          if (active) {
            fma_chunk<RR, QQ>(acc, zs, off, zs + a.p.rz * kRowFloats + QQ * tq, kt,
                              min(kChunkJ, e4 - cc * kChunkJ));
          }
          if (cc + 1 == nc) {
            if (p == 0 && k == 0 && !first_tile) role_sync(kYFree, kRoles);
            const int col = k * kt + QQ * tq;
            if (tr < tre) {
#pragma unroll
              for (int i = 0; i < RR; ++i) {
                const int r = tr + i * tre;
                if (r < nr) {
                  float* yr = a.y + static_cast<size_t>(r0 + r) * F;
#pragma unroll
                  for (int u = 0; u < QQ; ++u) {
                    if (col + u < F) yr[col + u] = acc[i][u];
                  }
                }
              }
            }
            if (p + 1 == pieces && k + 1 == nk && !a.last_tile(tile)) {
              role_arrive(kYFull, kRoles);
            }
          }
          // the slot read by every consumer: those that copy wait for it
          if (copies) {
            role_sync(kSlotRead + s, kConsumerThreads);
          } else {
            role_arrive(kSlotRead + s, kConsumerThreads);
          }
          // the chunks up to `slots` ahead: the one into this slot, and any
          // the first piece's copies left (they stop at its end)
          for (; next < total && next <= q + S; ++next) stage_chunk(a, chunk_at(a, next), w0, win);
        }
      }
    }
    first_tile = false;
  }
  // the last piece's means: the hand-back the copies no longer wait for
  role_sync(kBaseFree, kRoles);
}

// Walk this block's tiles (tile = blockIdx.x, + gridDim.x, ...) by roles:
// warps 0-7 contract and copy, warps 8-11 centre and finish; the means of
// the block's first piece and the epilogue of its last tile, which nothing
// overlaps, by all 12 warps. No barrier is block-wide between those; each
// hand-off is a named barrier or a slot's mbarrier. Every output is the
// phase-by-phase design's function in the same operations and order (the
// mean in lane_baseline_sum's order, the centre as __fmul_rn then
// __fsub_rn of sample_value's bits, one chain of FMAs from 0 in ascending
// j, normalize_row, quantize_feature), so a window's row is the same bit
// for bit whatever the design, the plan or its place in the launch.
template <class Sample, Precision P, class Windows>
__device__ __forceinline__ void run_tiles_ring(void* smem, const StreamView<Sample>& v,
                                               const float* __restrict__ res,
                                               const float* __restrict__ w, int rows, int pre,
                                               int skip, int epoch, int features,
                                               const RingPlan& plan, const Windows& win) {
  RingLaunch<Sample> a{v, res, w, rows, pre, skip, epoch, features, plan};
  a.bars = static_cast<uint64_t*>(smem);
  a.ring = reinterpret_cast<float*>(static_cast<char*>(smem) + kBarrierBytes);
  a.base = a.ring + static_cast<size_t>(plan.slots) * ring_slot_floats(plan);
  a.rcm = reinterpret_cast<float2*>(a.base + static_cast<size_t>(plan.rz) * plan.base_floats);
  a.seg = reinterpret_cast<int2*>(a.rcm + plan.rz);
  a.y = reinterpret_cast<float*>(a.seg + plan.rz);
  const size_t tile_rows = static_cast<size_t>(plan.m) * v.channels;
  a.gmax = a.y + tile_rows * features;
  a.starts = reinterpret_cast<int*>(a.gmax + tile_rows * subband_groups(features));
  a.chunk0 = a.starts + 2 * plan.rz;
  a.base0 = a.chunk0 + plan.rz;
  const uintptr_t xbeg = reinterpret_cast<uintptr_t>(v.raw);
  const uintptr_t xend =
      xbeg + static_cast<uintptr_t>(v.channels) * static_cast<uintptr_t>(v.n) * sizeof(Sample);
  a.xb = xbeg & ~static_cast<uintptr_t>(15);
  a.xoff = static_cast<int>(xbeg - a.xb);
  a.xlo = xbeg & ~static_cast<uintptr_t>(3);
  a.xhi = (xend + 3) & ~static_cast<uintptr_t>(3);
  const int tiles = a.tiles();
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.slots; ++s) mbar_init(a.bars + s, kConsumerThreads);
    mbar_init(a.bars + kMaxSlots, 2 * kConsumerThreads);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // W's chunk slots zeroed: a chunk's rows past epoch are never copied, and
  // meet z = 0 (a finite value times 0 leaves a chain as it is)
  const int wn = kChunkJ * ring_kt(plan);
  for (int i = threadIdx.x; i < plan.slots * wn; i += kRingThreads) {
    a.slot(i / wn)[plan.rz * kRowFloats + i % wn] = 0.0f;
  }
  __syncthreads();  // the mbarriers initialized, W's slots zeroed
  const int warp = threadIdx.x / 32;
  // the consumers copy the block's first piece's baselines and first
  // chunks (as many as the ring holds), then the whole block takes that
  // piece's means: nothing else is ready to run yet
  const int total =
      ((tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * a.pieces() * a.k_tiles() *
      a.chunks();
  int next = 0;
  if (warp < kCentreWarp0) {
    const int first_piece = a.k_tiles() * a.chunks();
    for (; next < total && next < plan.slots && next < first_piece; ++next) {
      stage_chunk(a, chunk_at(a, next), 0, win);
    }
  }
  mbar_wait(a.bars + kMaxSlots, 0);
  piece_means(a, blockIdx.x, 0, min(plan.rz, a.tile_rows()), a.starts, threadIdx.x,
              kRingThreads, [] { __syncthreads(); });
  if (warp < kCentreWarp0) {
    if (plan.rr == 8) {
      ring_consumers<8, 4>(a, next, total, win);
    } else if (plan.rr == 4) {
      ring_consumers<4, 4>(a, next, total, win);
    } else {
      ring_consumers<1, 1>(a, next, total, win);
    }
  } else {
    ring_centring<P>(a, win);
  }
  __syncthreads();  // the last tile's rows written
  const int last =
      blockIdx.x + ((tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x) * gridDim.x;
  ring_finish<P>(a, last, 0, kRingThreads / 32, [] { __syncthreads(); }, win);
}

// One generic launch of `kDesign` (the kernels' body): run_tiles_ring or
// run_tiles_any on the launch's plan.
template <int kDesign, class Sample, Precision P, class Windows>
__device__ __forceinline__ void run_design(void* smem, const StreamView<Sample>& v,
                                           const float* __restrict__ res,
                                           const float* __restrict__ w, int rows, int pre,
                                           int skip, int epoch, int features,
                                           const DesignPlan<kDesign>& plan, const Windows& win) {
  if constexpr (kDesign == kRingDesign) {
    run_tiles_ring<Sample, P>(smem, v, res, w, rows, pre, skip, epoch, features, plan, win);
  } else {
    run_tiles_any<Sample, P>(smem, v, res, w, rows, pre, skip, epoch, features, plan, win);
  }
}

}  // namespace window_features
