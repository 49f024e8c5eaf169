// One window of samples -> its C*16 Daubechies coefficients, for one
// block of kThreads threads. Shared by the fused ingest kernel
// (ingest_features.cu) and the serve megakernel (serve_mega.cu): both walk
// their windows through run_windows below, so their feature rows agree bit
// for bit. Every other window and coefficient count runs the generic
// engine of window_features_any.cuh, which both kernels share too. The
// epoch-features kernel (epoch_features.cu) uses only the 16-byte chunk
// copies (copy_async16, commit_async, wait_async).
//
// Per channel c of a window starting at `start`:
//   x     = float(raw[c, start + j]) * res[c]      (0 outside [0, n_samples);
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
// Thread (g, k) of the 256 (16 sample groups x 16 features) contracts its
// group's 32 centred samples against W[:, k] with float4 loads from shared
// memory, and partial sums reduce in a fixed order: the shfl_xor 16 pair,
// warps 0..7 in order, each thread's features t, t+256, ... into the norm,
// each warp's butterfly, the warps in order. No tensor cores and no TF32.
//
// run_windows, the engine of K1 and K5/K6: one persistent wave of blocks
// (plan_grid), each walking the windows row = blockIdx.x + i * gridDim.x
// through a ring of two slots of raw samples in shared memory, one piece
// a slot: `group` channels of a window, every channel where they fit (at
// the main path's 3 they do; a wide montage takes two or three pieces a
// window). A slot holds, per channel, the 16-byte-aligned chunks that
// cover the baseline and the analysis segment, so a window at any sample
// offset is one 16-byte cp.async per chunk (no per-sample loads, no
// division per sample); the reads apply the segment's offset within its
// first chunk and mask samples outside the row. Piece i + 1's copies are
// issued while piece i is computed. Per piece (slot k):
//   warp 0:      at a window's first piece, the previous window's
//                epilogue (reduce, norm, then write, quantize or dot; K6
//                loads the row's lane first), then its W rows again (they
//                are dead during the epilogue)
//   warps 1..G:  the baseline means of the piece's channels (channel c on
//                warp 1 + c, lanes strided, summed in double, butterfly)
//   warps G+1..7 (warps 1..7 after their means where G >= 7): stage the
//                next piece into the slot the previous one left
//   barrier 1    the means visible: all warps, or for the int8 and int4
//                rungs warps 1..7 alone (epilogue_off_chain), whose warp
//                0 goes on with its epilogue, quantize step included,
//                through the centre
//   centre:      z = float(x) * res - mean in registers (__fmul_rn,
//                __fsub_rn: the two roundings of the one-window-per-block
//                kernel, never an FMA), rounded to bf16 for kBf16; all
//                warps, or warps 1..7
//   barrier 2    z visible, warp 0 done with the partials
//   all:         contraction, three channels' FMA chains interleaved,
//                into the window's partials at the piece's channels
//   barrier 3    the partials visible
//   warps 1..7 wait for the next piece's copies and meet at a named
//   barrier before the next piece's means.
// Warp 0 computes the reduce and the norm in the block-wide order above
// (it replays each warp's butterfly), so rows equal the one-window-per-
// block kernel's bit for bit, with no barrier after the partials.
//
// Registers: four blocks of 256 threads a multiprocessor (the contraction
// wants the warps) leave 64 a thread, 30 of them W's column (its last
// kTailRows rows come from a copy in shared memory). The loop carries the
// slot index alone: a piece's start, row and first channel sit beside its
// slot in shared memory, and the contraction reads %tid.x afresh, so
// ptxas spills nothing.
//
// Reach: a launch is refused exactly where the one-window-per-block kernel
// could not fit its shared memory (smem_bytes: channels * (pre + 757)
// floats, 76 channels at the 100-sample baseline on Hopper); every other
// launch runs (plan_ring).
//
// Precision instantiations (template argument P; ops/decode_ingest.py):
//   kF32   the function above;
//   kBf16  z and W each rounded to bfloat16 (round to nearest even)
//          before the contraction: the centred samples as the centre step
//          writes them, W as load_held_operator and the tail copy read it. A product of two bf16
//          values is exact in f32, so the contraction accumulates in f32
//          in the same order as kF32; the norm is f32. This is the JAX
//          package's decode slice twin (subtract first in f32, cast the
//          centred operand, f32 accumulation);
//   kInt8, kInt4  the kF32 row, then quantize_feature on each element
//          (quantize_lane: each group's maximum by a butterfly in warp 0).
// Every difference between the forms is an `if constexpr`.

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
// and ran 20% slower on the H100. The wide-ring instantiations (kWide)
// ask for one: their ring fills most of a multiprocessor's shared memory
// anyway, and 64 registers spill there.
constexpr int kMinBlocksPerSm = 4;

__host__ __device__ constexpr int min_blocks_per_sm(bool wide) {
  return wide ? 1 : kMinBlocksPerSm;
}

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

// The shared memory of the one-window-per-block kernel K1 and K5 replaced
// (the window's centred samples, its baseline, the 8 warps' partials, the
// coefficients, the means and the norm's partials): plan_ring refuses a
// launch exactly where this exceeds the block's limit, as that kernel did.
inline size_t smem_bytes(int channels, int pre) {
  const size_t floats = static_cast<size_t>(channels) * kEpoch +
                        static_cast<size_t>(channels) * pre +
                        static_cast<size_t>(kWarps) * channels * kFeatures +
                        static_cast<size_t>(channels) * kFeatures + channels +
                        kWarps + 1;
  return floats * sizeof(float);
}

// The quantize step of the int8 and int4 rungs: element f of the
// L2-normalized row after quantize -> dequantize with the symmetric scale
// of its (channel, subband group), whose largest magnitude is m. The
// groups of a channel's 16 coefficients are [0,1) [1,2) [2,4) [4,8)
// [8,16), the eegdsp layout [aK | dK | ... | d1]. These are the float32
// operations, in order, of the plain version
// (ops/decode_ingest.quantize_dequantize) and of the JAX package's
// quantize_dequantize_int8/int4:
//   s = max|g| / qmax   (IEEE division: the build has no --use_fast_math)
//   s = max(s, 1e-30)   (an all-zero group: 0 / s stays 0)
//   q = clamp(rint(g / s), -qmax, qmax)   (rint: half to even), as an
//       integer (no negative zero)
//   out = q * s
// The group maximum is exact in any order, so the result is the plain
// version's bit for bit on the same row. It reads only the row, so a
// window's quantized row does not depend on the batch it rides in.
template <Precision P>
__device__ __forceinline__ float quantize_feature(float f, float m) {
  static_assert(quantized(P), "quantize_feature is for the int8 and int4 rungs");
  constexpr float qmax = qmax_of(P);
  const float s = fmaxf(m / qmax, 1e-30f);
  const float q = fminf(fmaxf(rintf(f / s), -qmax), qmax);
  // an integer level, as the JAX package's int8 cast makes it: -0.0 -> 0
  return static_cast<float>(static_cast<int>(q)) * s;
}

// quantize_feature for a warp holding 32 consecutive elements of the row,
// from a multiple of 16 (lane l: element i with i % 16 == l % 16; 0 where
// i is past the row): the group maximum by a butterfly within each
// group's aligned run of lanes (a group of 2^j elements starts at a
// multiple of 2^j), so no lane scans its group in shared memory. Every
// lane of the warp calls it.
template <Precision P>
__device__ __forceinline__ float quantize_lane(float f, int lane) {
  const int k = lane % kFeatures;
  const int width = k < 2 ? 1 : 1 << (31 - __clz(k));  // of k's group
  float m = fabsf(f);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, m, off);
    if (off < width) m = fmaxf(m, other);
  }
  return quantize_feature<P>(f, m);
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

// ---------------------------------------------------------------------------
// The ring-staged window engine of the fused ingest kernel and the serve
// megakernel.

constexpr int kChunkBytes = 16;  // one cp.async, 16-byte aligned at both ends
constexpr int kStages = 2;       // ring slots: the piece computed, the next one in flight

// Thread (g, k) keeps the first kHeldRows of its 32 rows of W's column k in
// registers; the last kTailRows it reads from the block's copy in shared
// memory at each contraction (plain loads, which the loop's barriers keep
// the compiler from hoisting into registers held across the loop). That
// frees the registers the loop needs to fit in 64 beside the column (four
// blocks of 256 threads a multiprocessor).
constexpr int kTailRows = 2;
constexpr int kHeldRows = kPerGroup - kTailRows;

template <class Sample>
__host__ __device__ constexpr int chunk_samples() {
  return kChunkBytes / static_cast<int>(sizeof(Sample));
}

// Chunks that hold `len` consecutive samples starting at any sample of a
// chunk: the most the 16-byte-aligned superset of a segment can need.
template <class Sample>
__host__ __device__ constexpr int segment_chunks(int len) {
  return (len + 2 * chunk_samples<Sample>() - 2) / chunk_samples<Sample>();
}

// A launch's ring. A piece is `group` channels of one window (every
// channel where they fit, which they do at the main path's 3); a slot
// holds a piece, per channel base_chunks chunks of the baseline segment,
// then the analysis segment's, `chunks` in all. base_chunks is 0 where
// even one channel's baseline does not fit two slots (a baseline of tens
// of thousands of samples): the means then read it from device memory.
// q / chunks = __umulhi(q, magic) for every chunk index q < 2^16 of a
// slot (magic = ceil(2^32 / chunks); the error q * (magic - 2^32 / chunks)
// / 2^32 stays under 1 / chunks).
struct Ring {
  int base_chunks;
  int chunks;
  int group;
  unsigned magic;
};

template <class Sample>
inline Ring ring_of(int base_chunks, int group) {
  const int chunks = base_chunks + segment_chunks<Sample>(kEpoch);
  return Ring{base_chunks, chunks, group, 0xffffffffu / static_cast<unsigned>(chunks) + 1u};
}

inline size_t ring_smem_bytes(const Ring& r, int channels) {
  const size_t c = static_cast<size_t>(channels);
  const size_t g = static_cast<size_t>(r.group);
  return static_cast<size_t>(kStages) * g * r.chunks * kChunkBytes      // ring
         + g * kEpoch * sizeof(float)                                    // z
         + static_cast<size_t>(kWarps) * c * kFeatures * sizeof(float)   // part
         + c * kFeatures * sizeof(float)                                 // feat
         + static_cast<size_t>(kGroups) * kTailRows * kFeatures * sizeof(float)  // W's tail
         + 3 * static_cast<size_t>(kStages) * sizeof(int)  // slot starts, rows, channels
         + (g + c) * sizeof(float);                        // mean, res
}

struct RingSmem {
  char* ring;        // [kStages][group][chunks] x 16 B   raw samples
  float* z;          // [group][kEpoch]       centred analysis samples
  float* part;       // [kWarps][channels*16] partial contractions
  float* feat;       // [channels*16]         coefficients (warp 0's)
  float* wtail;      // [16 groups][kTailRows][16]  W's last rows of each group
  int* start;        // [kStages]             the window start of each slot
  int* row;          // [kStages]             its row
  int* chan;         // [kStages]             and its piece's first channel
  float* mean;       // [group]
  float* res;        // [channels]
};

__device__ __forceinline__ RingSmem carve_ring(void* smem, const Ring& r, int channels,
                                               int group) {
  RingSmem s;
  s.ring = static_cast<char*>(smem);
  s.z = reinterpret_cast<float*>(s.ring + static_cast<size_t>(kStages) * group * r.chunks *
                                              kChunkBytes);
  s.part = s.z + group * kEpoch;
  s.feat = s.part + kWarps * channels * kFeatures;
  s.wtail = s.feat + channels * kFeatures;
  s.start = reinterpret_cast<int*>(s.wtail + kGroups * kTailRows * kFeatures);
  s.row = s.start + kStages;
  s.chan = s.row + kStages;
  s.mean = reinterpret_cast<float*>(s.chan + kStages);
  s.res = s.mean + group;
  return s;
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// %tid.x read afresh: the contraction derives its addresses from here, so
// they are computed at each window rather than held across the loop in
// one of the 64 registers beside W's column.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <Precision P>
__device__ __forceinline__ void load_held_operator(const float* __restrict__ w,
                                                   float (&wreg)[kHeldRows]) {
  const int g = threadIdx.x / kFeatures;
  const int k = threadIdx.x % kFeatures;
#pragma unroll
  for (int i = 0; i < kHeldRows; ++i) {
    wreg[i] = w[(g * kPerGroup + i) * kFeatures + k];
    if constexpr (P == Precision::kBf16) wreg[i] = round_bf16(wreg[i]);
  }
}

// The (channels, n) sample stream a launch reads.
template <class Sample>
struct StreamView {
  const Sample* raw;
  int channels;
  int n;

  // Offset, in samples, of sample j of channel c (j may lie outside the
  // row) within its 16-byte chunk of the address space: the low 4 bits of
  // the address, which 32-bit arithmetic (mod 2^32) gives exactly.
  __device__ __forceinline__ int offset(int c, long long j) const {
    const unsigned a = static_cast<unsigned>(reinterpret_cast<unsigned long long>(raw)) +
                       (static_cast<unsigned>(c) * static_cast<unsigned>(n) +
                        static_cast<unsigned>(j)) * static_cast<unsigned>(sizeof(Sample));
    return static_cast<int>(a & (kChunkBytes - 1)) / static_cast<int>(sizeof(Sample));
  }

  // The first staged sample of segment `seg` (0 baseline, 1 analysis) of
  // channel c, the piece's channel cl, in `slot`; sample j of the segment
  // is at index j.
  __device__ __forceinline__ const Sample* segment(const char* slot, const Ring& r, int cl,
                                                   int c, int seg, long long first) const {
    const char* chunk0 =
        slot + (static_cast<size_t>(cl) * r.chunks + (seg ? r.base_chunks : 0)) * kChunkBytes;
    return reinterpret_cast<const Sample*>(chunk0) + offset(c, first);
  }
};

// Start copying channels [c0, c0 + count) of the window at `start` into
// `slot`, thread t of `threads` (the caller commits): per channel the
// chunks that cover its baseline [start, start + pre) (where the ring
// keeps it) and analysis [start + pre + skip, + 512) segments. A chunk
// that holds no sample of the channel's row is skipped (the reads mask
// it); a chunk that runs past either end of the tensor is copied sample
// by sample; every other chunk is one 16-byte cp.async.
template <class Sample>
__device__ __forceinline__ void stage_window(const StreamView<Sample>& v, int start, int c0,
                                             int count, int pre, int skip, const Ring& r,
                                             char* slot, int t, int threads) {
  constexpr int kv = chunk_samples<Sample>();
  const long long total = static_cast<long long>(v.channels) * v.n;
  for (int q = t; q < count * r.chunks; q += threads) {
    const int cl = static_cast<int>(__umulhi(static_cast<unsigned>(q), r.magic));
    const int c = c0 + cl;
    int k = q - cl * r.chunks;
    const bool analysis = k >= r.base_chunks;
    if (analysis) k -= r.base_chunks;
    const int len = analysis ? kEpoch : pre;
    const long long first = static_cast<long long>(start) + (analysis ? pre + skip : 0);
    const int off = v.offset(c, first);
    if (k * kv >= off + len) continue;  // past the segment's last chunk
    const long long s0 = first - off + static_cast<long long>(k) * kv;  // chunk's first sample
    if (s0 + kv <= 0 || s0 >= v.n) continue;
    const long long e = static_cast<long long>(c) * v.n + s0;  // ... in the flat tensor
    Sample* dst = reinterpret_cast<Sample*>(slot + static_cast<size_t>(q) * kChunkBytes);
    if (e >= 0 && e + kv <= total) {
      copy_async16(dst, v.raw + e);
    } else {
      for (int i = 0; i < kv; ++i) {
        if (s0 + i >= 0 && s0 + i < v.n) dst[i] = v.raw[e + i];
      }
    }
  }
}

// Samples [lo, hi) of the segment of `len` samples from `first` lie in
// the row [0, n).
struct InRow {
  int lo;
  int hi;
  __device__ __forceinline__ InRow(long long first, int len, int n) {
    lo = first >= 0 ? 0 : (-first < len ? static_cast<int>(-first) : len);
    const long long left = n - first;
    hi = left <= 0 ? 0 : (left < len ? static_cast<int>(left) : len);
  }
};

// x = float(sample j) * res, 0 outside the row: the parent's FMUL, never
// contracted with what follows.
template <class Sample>
__device__ __forceinline__ float scaled(const Sample* seg, int j, const InRow& in, float rc) {
  return (j >= in.lo && j < in.hi) ? __fmul_rn(static_cast<float>(seg[j]), rc) : 0.0f;
}

// The baseline mean of each channel of the piece, by warps 1..7 (its
// channel cl on warp 1 + cl % 7): lanes strided over the pre samples,
// summed in double, then a butterfly; lane 0 writes it. The samples come
// from the slot, or from device memory where the ring keeps no baseline.
template <class Sample, bool kWide>
__device__ __forceinline__ void window_means(const StreamView<Sample>& v, int start, int c0,
                                             int count, int pre, const Ring& r, const char* slot,
                                             const RingSmem& s, int warp, int lane) {
  for (int cl = warp - 1; cl < count; cl += kWarps - 1) {
    const int c = c0 + cl;
    const Sample* seg = v.segment(slot, r, cl, c, 0, start);
    if constexpr (kWide) {
      if (r.base_chunks == 0) seg = v.raw + (static_cast<long long>(c) * v.n + start);
    }
    const InRow in(start, pre, v.n);
    const float rc = s.res[c];
    double sum = 0.0;
    if (in.lo == 0 && in.hi == pre) {  // the whole baseline lies in the row
#pragma unroll 4
      for (int j = lane; j < pre; j += 32) {
        sum += static_cast<double>(__fmul_rn(static_cast<float>(seg[j]), rc));
      }
    } else {
#pragma unroll 4
      for (int j = lane; j < pre; j += 32) sum += static_cast<double>(scaled(seg, j, in, rc));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) s.mean[cl] = static_cast<float>(sum / static_cast<double>(pre));
  }
}

// Whether warp 0 runs the previous window's epilogue through the centre
// step, which warps 1..7 then take alone: for the int8 and int4 rungs,
// whose quantize step makes the epilogue the longest step of the chain.
// The f32 and bf16 rungs' epilogue fits beside the means and the staging,
// and there all warps centre (two samples a channel and thread, fewer
// instructions than warps 1..7 need).
__host__ __device__ constexpr bool epilogue_off_chain(Precision p) { return quantized(p); }

// Threads of the centre step.
__host__ __device__ constexpr int centre_threads(Precision p) {
  return epilogue_off_chain(p) ? kThreads - 32 : kThreads;
}

// z = x - mean (then, for kBf16, rounded) for the 512 analysis samples of
// every channel of the piece, by thread t of the kCentre centre threads
// (all 256, or warps 1..7), three channels at a time: samples t and
// t + kCentre of each of the three, their loads issued together (a group
// past the piece's last channel reads that channel again and stores
// nothing), then, with 224 threads, one of the three channels' last 64
// samples for each of threads 0..191. The groups are written out:
// `#pragma unroll 3` on a channel loop ran whole groups past its end on
// the H100.
template <class Sample, Precision P>
__device__ __forceinline__ float centred(const Sample* seg, int j, const InRow& in, bool whole,
                                         float rc, float m) {
  const float x = whole ? __fmul_rn(static_cast<float>(seg[j]), rc) : scaled(seg, j, in, rc);
  const float z = __fsub_rn(x, m);
  if constexpr (P == Precision::kBf16) return round_bf16(z);
  return z;
}

template <class Sample, Precision P>
__device__ __forceinline__ void window_centre(const StreamView<Sample>& v, long long first,
                                              int c0, int count, const Ring& r,
                                              const char* slot, const RingSmem& s, int t) {
  constexpr int kCentre = centre_threads(P);
  constexpr int kTail = kEpoch - 2 * kCentre;  // 0 or 64 samples a channel
  static_assert(kTail >= 0 && 3 * kTail <= kCentre, "the centre's split of a window");
  const InRow in(first, kEpoch, v.n);
  const bool whole = in.lo == 0 && in.hi == kEpoch;  // no sample to mask
  for (int cl0 = 0; cl0 < count; cl0 += 3) {
    float z[3][2];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int cl = cl0 + u < count ? cl0 + u : count - 1;
      const Sample* seg = v.segment(slot, r, cl, c0 + cl, 1, first);
      const float rc = s.res[c0 + cl];
      const float m = s.mean[cl];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        z[u][h] = centred<Sample, P>(seg, t + h * kCentre, in, whole, rc, m);
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (cl0 + u < count) {
#pragma unroll
        for (int h = 0; h < 2; ++h) s.z[(cl0 + u) * kEpoch + t + h * kCentre] = z[u][h];
      }
    }
    if constexpr (kTail > 0) {
      const int cl = cl0 + t / kTail;
      if (t < 3 * kTail && cl < count) {
        const int j = 2 * kCentre + t % kTail;
        s.z[cl * kEpoch + j] = centred<Sample, P>(v.segment(slot, r, cl, c0 + cl, 1, first), j,
                                                  in, whole, s.res[c0 + cl], s.mean[cl]);
      }
    }
  }
}

// Step 4, the contraction, for the piece's channels c0 .. c0 + count:
// thread (g, k) sums its 32 samples of each channel against W[:, k] in
// sample order; the pair of groups of a warp adds by shfl_xor 16, and lanes
// 0..15 write the warp's partials.
__device__ __forceinline__ void contract_partials(int c0, int count, int channels,
                                                  const float (&wreg)[kHeldRows],
                                                  const RingSmem& s) {
  const int tid = thread_index();
  const int g = tid / kFeatures;
  const int k = tid % kFeatures;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nfeat = channels * kFeatures;
  float tail[kTailRows];
#pragma unroll
  for (int j = 0; j < kTailRows; ++j) tail[j] = s.wtail[(g * kTailRows + j) * kFeatures + k];
  auto wr = [&](int i) { return i < kHeldRows ? wreg[i] : tail[i - kHeldRows]; };
  for (int cl = 0; cl < count; cl += 3) {
    const int left = count - cl;
    const float4* z0 = reinterpret_cast<const float4*>(s.z + cl * kEpoch + g * kPerGroup);
    const float4* z1 = z0 + (left > 1 ? kEpoch / 4 : 0);
    const float4* z2 = z0 + (left > 2 ? kEpoch / 2 : 0);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int q = 0; q < kPerGroup / 4; ++q) {
      const float4 v0 = z0[q];
      const float4 v1 = z1[q];
      const float4 v2 = z2[q];
      a0 = fmaf(v0.x, wr(4 * q + 0), a0);
      a1 = fmaf(v1.x, wr(4 * q + 0), a1);
      a2 = fmaf(v2.x, wr(4 * q + 0), a2);
      a0 = fmaf(v0.y, wr(4 * q + 1), a0);
      a1 = fmaf(v1.y, wr(4 * q + 1), a1);
      a2 = fmaf(v2.y, wr(4 * q + 1), a2);
      a0 = fmaf(v0.z, wr(4 * q + 2), a0);
      a1 = fmaf(v1.z, wr(4 * q + 2), a1);
      a2 = fmaf(v2.z, wr(4 * q + 2), a2);
      a0 = fmaf(v0.w, wr(4 * q + 3), a0);
      a1 = fmaf(v1.w, wr(4 * q + 3), a1);
      a2 = fmaf(v2.w, wr(4 * q + 3), a2);
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
    a2 += __shfl_xor_sync(0xffffffffu, a2, 16);
    if (lane < kFeatures) {
      float* pc = s.part + warp * nfeat + (c0 + cl) * kFeatures + k;
      pc[0] = a0;
      if (left > 1) pc[kFeatures] = a1;
      if (left > 2) pc[2 * kFeatures] = a2;
    }
  }
}

// Step 5 by warp 0 alone, in the block-wide order of the one-window-per-
// block kernel, in which thread t of the 256 reduced its features i = t,
// t + 256, ... over the 8 warps' partials in warp order and summed their
// squares in that order, each warp added its threads' sums by a butterfly
// (shfl_xor 16, 8, 4, 2, 1), and the warps' sums added in warp order. Here,
// for each warp w that held features, lane l stands for thread 32w + l,
// then w's butterfly runs, whose lane-0 value adds to the total in warp
// order. Two warps' rounds run interleaved; a round past
// the last warp with features sums to 0, which adds exactly. Leaves y in
// s.feat (feature i written by lane i % 32) and returns max(||y||, 1e-30)
// to every lane.
__device__ __forceinline__ float reduce_and_norm(int channels, const RingSmem& s, int lane) {
  const int nfeat = channels * kFeatures;
  const int rounds = (nfeat + 31) / 32 < kWarps ? (nfeat + 31) / 32 : kWarps;
  float total = 0.0f;
  for (int w = 0; w < rounds; w += 2) {
    float ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      for (int i = (w + u) * 32 + lane; w + u < rounds && i < nfeat; i += kThreads) {
        float y = 0.0f;
        for (int p = 0; p < kWarps; ++p) y += s.part[p * nfeat + i];
        s.feat[i] = y;
        ss[u] = fmaf(y, y, ss[u]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss[0] += __shfl_xor_sync(0xffffffffu, ss[0], off);
      ss[1] += __shfl_xor_sync(0xffffffffu, ss[1], off);
    }
    total += __shfl_sync(0xffffffffu, ss[0], 0);
    total += __shfl_sync(0xffffffffu, ss[1], 0);
  }
  return fmaxf(sqrtf(total), 1e-30f);
}

// Walk this block's windows row = blockIdx.x, + gridDim.x, ... < rows,
// each as its pieces (channels 0 .. group, group .. 2 group, ...).
// `Windows` supplies start(row) (the window's first sample) and
// epilogue(row, s, lane), which warp 0 runs for each window, calling
// reduce_and_norm. See the header notes for the schedule. Each phase
// carves the shared memory anew from `smem`: 64 registers hold W's column
// and the loop's state, with no room for the carve's pointers.
// kWide: a window takes more than one piece, or the ring keeps no
// baseline (wide_ring); otherwise (the main path) a piece is a window and
// its first channel is 0, which the loop then neither stores nor reads.
template <class Sample, Precision P, bool kWide, class Windows>
__device__ __forceinline__ void run_windows(void* smem, const StreamView<Sample>& v,
                                            const float* __restrict__ res,
                                            const float* __restrict__ w, int rows, int pre,
                                            int skip, const Ring& r, const Windows& win) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  // channels a piece, from the launch's arguments wherever it is used
  // (not a register held across the loop)
  auto group = [&] { return kWide ? r.group : v.channels; };
  const int slot_bytes = group() * r.chunks * kChunkBytes;
  const int wave = gridDim.x;  // rows and the wave fit an int; their sums, unsigned
  // the warps that stage the next pieces: those with no baseline mean to
  // compute, or warps 1..7 after their means where every one has one
  const int first_issuer = group() < kWarps - 1 ? 1 + group() : 1;
  auto shared = [&] { return carve_ring(smem, r, v.channels, group()); };
  auto slot = [&](int k) { return shared().ring + k * slot_bytes; };
  auto chan = [&](int k) {
    if constexpr (kWide) {
      return shared().chan[k];
    } else {
      return 0;
    }
  };
  auto count = [&](int c0) {
    if constexpr (kWide) {
      return v.channels - c0 < r.group ? v.channels - c0 : r.group;
    } else {
      return v.channels;
    }
  };
  // the piece after (row, c0): the window's next channels, else the
  // block's next window (a row at or past `rows` is past the end)
  auto advance = [&](unsigned& row, int& c0) {
    if constexpr (kWide) {
      c0 += r.group;
      if (c0 < v.channels) return;
      c0 = 0;
    }
    row += wave;
  };

  // the first kStages - 1 pieces' copies, then W, while they fly
  {
    unsigned row = blockIdx.x;
    int c0 = 0;
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (row < static_cast<unsigned>(rows)) {
        const int start = win.start(row);
        if (tid == 0) {
          shared().start[k] = start;
          shared().row[k] = row;
          if constexpr (kWide) shared().chan[k] = c0;
        }
        stage_window(v, start, c0, count(c0), pre, skip, r, slot(k), tid, kThreads);
      }
      commit_async();
      advance(row, c0);
    }
  }
  for (int c = tid; c < v.channels; c += kThreads) shared().res[c] = res[c];
  for (int i = tid; i < kGroups * kTailRows * kFeatures; i += kThreads) {
    const int g = i / (kTailRows * kFeatures);
    const int j = i / kFeatures % kTailRows;
    float x = w[(g * kPerGroup + kHeldRows + j) * kFeatures + i % kFeatures];
    if constexpr (P == Precision::kBf16) x = round_bf16(x);
    shared().wtail[i] = x;
  }
  float wreg[kHeldRows];
  load_held_operator<P>(w, wreg);
  wait_async<kStages - 2>();
  __syncthreads();

  // The loop carries the slot index alone; a piece's start, row and first
  // channel sit beside its slot in shared memory, read where they are
  // used: 64 registers hold W's column and little more.
  constexpr bool kOffChain = epilogue_off_chain(P);
  auto lane_now = [] {
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));  // recomputed here, not held across the loop
    return t % 32;
  };
  int k = 0;
  for (;; k = k + 1 == kStages ? 0 : k + 1) {
    if (warp == 0) {
      // W's column is dead until the contraction: the epilogue takes its
      // registers, and the column comes back from L1 after it. A window's
      // first piece runs the epilogue of the block's previous window; a
      // row below the wave is the block's first (blockIdx.x < gridDim.x).
      // Warp 0 has until barrier 2: the means, the staging and the centre
      // of warps 1..7 overlap its epilogue.
      const int row = shared().row[k];
      if (chan(k) == 0 && row >= wave) win.epilogue(row - wave, shared(), lane_now());
      load_held_operator<P>(w, wreg);
    } else {
      const int c0 = chan(k);
      if (warp - 1 < count(c0)) {
        window_means<Sample, kWide>(v, shared().start[k], c0, count(c0), pre, r, slot(k),
                                    shared(), warp, lane_now());
      }
      // the piece kStages - 1 ahead goes to the slot the previous piece
      // left (its copies flew during the centre, before barrier 3)
      unsigned ahead = shared().row[k];
      int ahead_c0 = c0;
#pragma unroll
      for (int a = 0; a < kStages - 1; ++a) advance(ahead, ahead_c0);
      if (warp >= first_issuer && ahead < static_cast<unsigned>(rows)) {
        const int refill = k == 0 ? kStages - 1 : k - 1;
        const int ahead_start = win.start(ahead);
        if (tid == first_issuer * 32) {
          shared().start[refill] = ahead_start;
          shared().row[refill] = ahead;
          if constexpr (kWide) shared().chan[refill] = ahead_c0;
        }
        stage_window(v, ahead_start, ahead_c0, count(ahead_c0), pre, skip, r, slot(refill),
                     tid - first_issuer * 32, (kWarps - first_issuer) * 32);
      }
      commit_async();
      if constexpr (kOffChain) {
        named_sync(1, kThreads - 32);  // barrier 1, warps 1..7: the means visible
        window_centre<Sample, P>(v, static_cast<long long>(shared().start[k]) + pre + skip,
                                 chan(k), count(chan(k)), r, slot(k), shared(),
                                 thread_index() - 32);
      }
    }
    if constexpr (!kOffChain) {
      __syncthreads();  // barrier 1, all warps: the means visible
      window_centre<Sample, P>(v, static_cast<long long>(shared().start[k]) + pre + skip,
                               chan(k), count(chan(k)), r, slot(k), shared(), thread_index());
    }
    __syncthreads();  // barrier 2: z visible, warp 0 done with the partials
    contract_partials(chan(k), count(chan(k)), v.channels, wreg, shared());
    // read before barrier 3: the next piece's issuers rewrite slot k's row
    unsigned next = shared().row[k];
    int next_c0 = chan(k);
    advance(next, next_c0);
    const bool last = next >= static_cast<unsigned>(rows);
    __syncthreads();  // barrier 3: the partials visible
    if (last) break;
    if (warp != 0) {
      wait_async<kStages - 2>();  // this thread's copies of the next piece
      named_sync(1, kThreads - 32);  // and those of every other thread of warps 1..7
    }
  }
  if (warp == 0) win.epilogue(shared().row[k], shared(), lane_now());
}

// Choose the ring. A launch the one-window-per-block kernel could not
// make (its channels * (pre + 757) floats of shared memory, smem_bytes,
// over the block's limit) is refused (cudaErrorInvalidValue), as it was;
// every other one runs: each piece holds as many channels as fit (as
// evenly as the pieces allow), and where one channel's baseline does not
// fit the ring, the means read it from device memory. The launcher then
// sizes the grid (plan_grid) for run_windows' instantiation, wide_ring.
template <class Sample>
cudaError_t plan_ring(int channels, int pre, Ring* ring, size_t* smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(max_optin);
  if (smem_bytes(channels, pre) > limit) return cudaErrorInvalidValue;
  const int bases[2] = {segment_chunks<Sample>(pre), 0};  // the baseline in the ring, or not
  for (const int base : bases) {
    const size_t fixed = ring_smem_bytes(ring_of<Sample>(base, 0), channels);
    const size_t per_channel = ring_smem_bytes(ring_of<Sample>(base, 1), channels) - fixed;
    if (fixed + per_channel > limit) continue;
    const size_t most = (limit - fixed) / per_channel;
    const int fit = most < static_cast<size_t>(channels) ? static_cast<int>(most) : channels;
    const int pieces = (channels + fit - 1) / fit;
    *ring = ring_of<Sample>(base, (channels + pieces - 1) / pieces);
    *smem = ring_smem_bytes(*ring, channels);
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// The ring needs run_windows' kWide instantiation: more than one piece a
// window, or no baseline in the ring.
inline bool wide_ring(const Ring& r, int channels) {
  return r.group < channels || r.base_chunks == 0;
}

}  // namespace window_features
