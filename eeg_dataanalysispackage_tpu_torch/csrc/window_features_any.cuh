// The generic engine of the fused kernels: any analysis window (`epoch`
// samples) and coefficient count (`features`) but the main path's 512 / 16,
// which runs the ring engine of window_features.cuh. Both kernels walk
// their windows through run_tiles_any below, so the rows of the fused
// ingest kernel and the features behind the serve megakernel's margins
// agree bit for bit.
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
// f32 on CUDA cores).
//
// The one-window-a-block engine this replaces ran about five block-wide
// barriers per channel per window, read W from L1/L2 once per window and
// channel (1.6 GB of L2 traffic at (512, 64)), loaded samples 2 bytes a
// thread and overlapped nothing. The design here:
//   - A tile of M windows a block (AnyPlan::m, chosen per launch by
//     ops/generic_plan.py from the rows, sizes and the card: 1 at a serve
//     batch of 64, about 8-16 at thousands of windows); persistent blocks
//     walk the tiles grid-stride. A tile's (window, channel) rows run as
//     pieces of up to AnyPlan::rz rows (one piece where they fit).
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
//     beside the tile (4-byte cp.async copies, all in flight at once),
//     else streamed in chunks of rows through two slots shared by every
//     row of the piece (one barrier a chunk; chunk c + 1 flies while c is
//     contracted, and the next piece's samples after the last chunk).
//   - The contraction is register-blocked: thread (row group, column
//     group) owns rr rows x qq coefficients (qq = 4, or 1 for a tile of
//     few outputs, such as a serve batch's single window, which then
//     spreads over more threads, each with a shorter chain of FMAs), and
//     reads 4 samples of a row of z as a float4 (z's row stride is 4 mod
//     32 floats, so a warp's rows hit distinct banks). Each output is
//     summed by one thread in ascending j, an order that depends on
//     nothing but j: a window's row is the same bit for bit whatever M or
//     qq, its place in the tile or the launch.
//   - The epilogue: each window's norm in double on a warp; for the int8
//     and int4 rungs each subband group's maximum on a thread and the
//     quantize on every thread of the block; the caller's finish on a
//     warp a window.
//   Block-wide barriers: two a piece, one more at a tile's end (three for
//   the quantized rungs), and one a streamed W chunk; none scale with the
//   channel count where a tile is one piece.
//
// What holds it at 6-9x its bound at 4,096 windows (PERF.md section 6): a
// block's phases run in turn behind their barriers, 16 warps a
// multiprocessor at 126-128 registers a thread, and each output's
// ascending chain of FMAs.
//
// Reach: a launch is refused (kSharedMemoryExceeded) exactly where the
// one-window-a-block engine's shared memory (any_smem_bytes) exceeded the
// block's opt-in limit. Every other launch has a plan that fits: one row a
// piece, nothing staged and the smallest W chunk take less shared memory
// than that engine did.

#pragma once

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
// The plan's fields, in the order the launchers take them.
constexpr int kAnyPlanFields = 9;
// The most (window, channel) rows one thread of the contraction owns: its
// RR x qq accumulators and two steps' samples fit 128 registers beside the
// rest of the kernel without a spill (2 for float32 samples, whose
// instantiations spill at 3).
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
// normalized rows, by the whole block between barriers: each subband
// group's largest magnitude by one thread (exact in any order) into gmax,
// then quantize_feature on every element.
template <Precision P>
__device__ __forceinline__ void quantize_rows(float* y, float* gmax, int nw, int channels,
                                              int features) {
  const int ng = subband_groups(features);
  const int pairs = nw * channels * ng;
  for (int q = threadIdx.x; q < pairs; q += kThreads) {
    const int g = q % ng;
    const int lo = g == 0 ? 0 : 1 << (g - 1);
    const int hi = g == 0 ? 1 : ((1 << g) < features ? (1 << g) : features);
    const float* yc = y + static_cast<size_t>(q / ng) * features;
    float m = 0.0f;
    for (int k = lo; k < hi; ++k) m = fmaxf(m, fabsf(yc[k]));
    gmax[q] = m;
  }
  __syncthreads();  // the maxima visible
  const int n = nw * channels * features;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int cw = i / features;  // the (window, channel) row
    y[i] = quantize_feature<P>(y[i], gmax[cw * ng + subband_group(i - cw * features)]);
  }
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

}  // namespace window_features
