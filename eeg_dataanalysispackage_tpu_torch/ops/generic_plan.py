"""The tile plan of the fused kernels' generic engine
(``csrc/window_features_any.cuh``: ``AnyPlan``, ``run_tiles_any``).

Every window and coefficient count but the main path's 512 / 16 runs that
engine. A block takes a tile of ``m`` windows at a time; a tile's
(window, channel) rows run in pieces of up to ``rz`` rows, each piece's
samples staged in shared memory by 16-byte chunks, centred into ``z`` and
contracted with W, which stays in shared memory for the launch where it
fits and is streamed through two chunk slots where it does not.

:func:`generic_tile_plan` is a pure function of the sizes, the launch's
row count and the card's multiprocessor count and shared-memory limit:
both wrappers (``ingest_cuda``, ``serve_mega_cuda``) call it and pass the
plan to the launchers, which check it again and refuse one that does not
fit. It is memoized: its search takes ~0.1 ms of Python, more than a
serve batch's kernel, and a server calls it with the same sizes every
batch. It returns ``None`` exactly where the one-window-a-block engine this
engine replaced could not fit its shared memory (:func:`any_smem_bytes`),
and a plan that fits everywhere else.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

#: threads a block, as the kernels' kThreads
THREADS = 256
#: bytes of one staged chunk (kChunkBytes)
CHUNK_BYTES = 16
#: W floats a thread fetches for one streamed chunk (kAnyFetch)
FETCH = 8
#: the largest k-tile (coefficients a pass of the contraction)
MAX_K_TILE = 128


def max_rows(sample_bytes: int) -> int:
    """The most rows one thread of the contraction owns (``max_rows`` of
    window_features_any.cuh): 3 for int16 samples, 2 for float32, whose
    kernels spill at 3."""
    return 3 if sample_bytes == 2 else 2


#: a tile of at most this many outputs (windows x channels x
#: coefficients) contracts one coefficient a thread, not four: a serve
#: batch's single window spreads over more threads, each with a shorter
#: chain of FMAs to wait on
ONE_COLUMN_OUTPUTS = 1024
#: the most windows a tile
MAX_M = 16
#: blocks a multiprocessor runs at once where shared memory allows
#: (the kernels' __launch_bounds__: kAnyMinBlocksPerSm)
BLOCKS_PER_SM = 2
#: shared memory a multiprocessor keeps for each block beyond its own (a
#: multiprocessor holds the per-block opt-in limit plus this)
BLOCK_RESERVE = 1024
#: a piece's fixed cost (its barriers, its staging's latency, the
#: epilogue's chain) in windows' worth of work, for choosing m
PIECE_OVERHEAD = 2


class TilePlan(NamedTuple):
    """``csrc/window_features_any.cuh`` ``AnyPlan`` (the first eight
    fields, in the launchers' order) and the shared memory it takes."""

    m: int            # windows a tile
    rz: int           # (window, channel) rows a piece: the rows of z
    rr: int           # rows each thread contracts: 1 to max_rows(sample_bytes)
    tq_log2: int      # log2 of the column threads; a k-tile is qq << tq_log2
    jc: int           # W rows a streamed chunk, 0: W resident
    ep: int           # z's row stride in floats (4 mod 32)
    base_chunks: int  # staged chunks of a row's baseline, 0: read from device memory
    seg_chunks: int   # staged chunks of a row's analysis segment, 0: nothing staged
    qq: int           # coefficients each thread contracts: 4, or 1
    smem: int         # bytes of shared memory

    def fields(self) -> Tuple[int, ...]:
        """The ints the launchers take."""
        return tuple(self[:9])


def subband_groups(features: int) -> int:
    """Subband groups of one channel's coefficients ([0, 1), then
    [2^(g-1), min(2^g, features)))."""
    groups, lo = 1, 1
    while lo < features:
        groups += 1
        lo *= 2
    return groups


def any_smem_bytes(channels: int, epoch: int, features: int) -> int:
    """The generic engine's reach: the shared memory of the
    one-window-a-block engine it replaced (the row, one channel's window,
    256 partials, the group maxima, 8 doubles). A launch is refused exactly
    where this exceeds the block's opt-in limit."""
    return 8 * 8 + (channels * features + epoch + THREADS
                    + channels * subband_groups(features)) * 4


def segment_chunks(length: int, sample_bytes: int) -> int:
    """16-byte chunks that hold ``length`` consecutive samples starting at
    any sample of a chunk (``segment_chunks`` of window_features.cuh)."""
    per = CHUNK_BYTES // sample_bytes
    return (length + 2 * per - 2) // per


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _z_stride(epoch: int) -> int:
    """The smallest stride >= epoch rounded up to 4 that is 4 mod 32 floats:
    a warp's float4 reads of 8 consecutive rows hit distinct banks."""
    e4 = _round4(epoch)
    return e4 + (4 - e4 % 32) % 32


def _natural_tq_log2(features: int, qq: int = 4) -> int:
    """Column threads for a k-tile of the next power of two >= features
    (at least qq, at most MAX_K_TILE coefficients), qq coefficients a
    thread, as a log2."""
    kt = qq
    while kt < min(features, MAX_K_TILE):
        kt *= 2
    return (kt // qq).bit_length() - 1


def plan_smem_bytes(plan_fields, channels: int, epoch: int, features: int) -> int:
    """Bytes of shared memory of a plan (``any_plan_smem_bytes``): W
    (resident, or two chunk slots), z, the staging slot, the tile's rows and
    their subband groups' maxima."""
    m, rz, _rr, tq_log2, jc, ep, base_chunks, seg_chunks, qq = plan_fields[:9]
    kt = qq << tq_log2
    nk = -(-features // kt)
    w = nk * _round4(epoch) * kt if jc == 0 else 2 * jc * kt
    y = m * channels * (features + subband_groups(features))
    return (w + rz * ep + y) * 4 + rz * (base_chunks + seg_chunks) * CHUNK_BYTES


def _shape(m, channels, epoch, features, pre, sample_bytes, tq_log2, rz=None, resident=True,
           base=True, staged=True, jc=None, qq=4) -> TilePlan:
    tile_rows = m * channels
    tr = THREADS >> tq_log2
    rz = min(tile_rows, max_rows(sample_bytes) * tr) if rz is None else rz
    rr = -(-rz // tr)
    kt = qq << tq_log2
    if resident:
        jc = 0
    elif jc is None:
        jc = min(_round4(epoch), THREADS * FETCH // kt)
    seg = segment_chunks(epoch, sample_bytes) if staged else 0
    base_chunks = segment_chunks(pre, sample_bytes) if staged and base else 0
    fields = (m, rz, rr, tq_log2, jc, _z_stride(epoch), base_chunks, seg, qq)
    return TilePlan(*fields, plan_smem_bytes(fields, channels, epoch, features))


def _fits(plan: TilePlan, smem_optin: int) -> bool:
    return plan.smem <= smem_optin


def resident_blocks(smem: int, smem_optin: int) -> int:
    """Blocks of ``smem`` bytes a multiprocessor runs at once."""
    return max(1, min(BLOCKS_PER_SM, (smem_optin + BLOCK_RESERVE) // (smem + BLOCK_RESERVE)))


def launch_cost(rows: int, plan: TilePlan, channels: int, sm_count: int,
                smem_optin: int) -> int:
    """The launch's time in windows' worth of one block's work: the rounds
    of tiles each resident block walks, each m windows plus the fixed cost
    of each of its pieces."""
    tiles = -(-rows // plan.m)
    slots = sm_count * resident_blocks(plan.smem, smem_optin)
    pieces = -(-plan.m * channels // plan.rz)
    return -(-tiles // slots) * (plan.m + PIECE_OVERHEAD * pieces)


@functools.lru_cache(maxsize=4096)
def generic_tile_plan(channels: int, epoch: int, features: int, rows: int, sm_count: int,
                      smem_optin: int, pre: int = 100,
                      sample_bytes: int = 2) -> Optional[TilePlan]:
    """The tile plan of a generic launch of ``rows`` windows of
    ``channels`` channels, ``epoch`` samples and ``features`` coefficients
    a channel (baseline ``pre``, samples of ``sample_bytes``), on a card
    of ``sm_count`` multiprocessors whose blocks may opt in to
    ``smem_optin`` bytes of shared memory; ``None`` where the sizes lie
    outside the engine's reach (:func:`any_smem_bytes` over the limit).

    For each count of windows a tile up to MAX_M (at most ``rows``) the
    plan keeps W resident and every sample staged if it fits, else
    streams W, else reads the baselines from device memory; of these the
    count with the least :func:`launch_cost` wins, the larger on a tie (a
    serve batch of 64 on 132 multiprocessors: 1 window a tile). Where no
    count fits, one window a tile stages nothing, then halves the piece's
    rows, shrinks W's chunk to 4 rows and halves the k-tile, until it
    fits; the last of these takes less shared memory than
    :func:`any_smem_bytes`, so every size within reach has a plan."""
    if min(channels, epoch, features, rows, sm_count, pre, sample_bytes) < 1:
        raise ValueError("generic_tile_plan needs positive sizes")
    if any_smem_bytes(channels, epoch, features) > smem_optin:
        return None
    tq = _natural_tq_log2(features)
    args = (channels, epoch, features, pre, sample_bytes)
    best = None
    for m in range(1, min(MAX_M, rows) + 1):
        qq = 1 if m * channels * features <= ONE_COLUMN_OUTPUTS else 4
        for resident, base in ((True, True), (False, True), (True, False), (False, False)):
            plan = _shape(m, *args, _natural_tq_log2(features, qq), resident=resident, base=base,
                          qq=qq)
            if _fits(plan, smem_optin):
                cost = launch_cost(rows, plan, channels, sm_count, smem_optin)
                if best is None or cost <= best[0]:
                    best = (cost, plan)
                break
    if best is not None:
        return best[1]
    rz = min(channels, max_rows(sample_bytes) * (THREADS >> tq))
    while True:
        for resident in (True, False):
            plan = _shape(1, *args, tq, rz=rz, resident=resident, staged=False)
            if _fits(plan, smem_optin):
                return plan
        if rz > 1:
            rz = max(1, rz // 2)
            continue
        plan = _shape(1, *args, tq, rz=1, resident=False, staged=False, jc=4)
        if _fits(plan, smem_optin):
            return plan
        if tq == 0:
            raise AssertionError("no generic tile plan fits within the engine's reach")
        tq -= 1
