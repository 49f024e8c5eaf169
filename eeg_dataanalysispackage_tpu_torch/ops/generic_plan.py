"""The tile plans of the fused kernels' generic engine
(``csrc/window_features_any.cuh``) and the choice of its design.

Every window and coefficient count but the main path's 512 / 16 runs that
engine. A block takes a tile of ``m`` windows at a time; a tile's
(window, channel) rows run in pieces of up to ``rz`` rows. The engine has
two designs, each for int16 and float32 samples, and the plan's first
field says which a launch runs (``kPhaseDesign``, ``kRingDesign``):

- The ring design (:class:`RingTilePlan`, ``RingPlan`` and
  ``run_tiles_ring``): a block of 384 threads works in two roles through a
  ring of ``slots`` chunk slots, a chunk 32 samples of j of every row of a
  piece and W's 32 rows of a k-tile: eight consumer warps contract each
  chunk, each thread an ``rr`` x ``qq`` register tile (8 x 4 or 4 x 4, or
  1 x 1 for a tile of few outputs), and the warps a piece leaves idle copy
  the chunks ahead (cp.async of the 16-byte chunks that cover a row's 32
  samples: 9 of float32 samples, 5 of int16); four centring warps take
  the means and centre each chunk in place (and run each tile's epilogue
  while the next tile is contracted). One block runs on a multiprocessor
  (168 registers a thread), so its plan balances the tiles over the
  multiprocessors' rounds with :func:`ring_launch_cost`, a model of the
  busiest sub-partition's issue slots, the centring, the copies and each
  tile's fixed cost.
- The phase-by-phase design (:class:`TilePlan`, ``AnyPlan`` and
  ``run_tiles_any``): each piece's samples are staged in shared memory by
  16-byte chunks, centred into ``z`` and contracted with W, which stays in
  shared memory for the launch where it fits and is streamed through two
  chunk slots where it does not; a block's phases run in turn behind
  block-wide barriers, two blocks a multiprocessor. Its fixed cost a tile
  is smaller, so it stays where a tile has few outputs (a serve batch's
  single window); :func:`phase_launch_cost` models it in the ring model's
  clocks.

:func:`generic_tile_plan` plans the launch in both designs and keeps the
one whose modelled clocks are fewer (:func:`design_plans` gives both). It
is a pure function of the sizes, the launch's row count, the sample width
and the card's multiprocessor count and shared-memory limit: both wrappers
(``ingest_cuda``, ``serve_mega_cuda``) call it and pass the plan to the
launchers, which check it again and refuse one that does not fit. It is
memoized: its search takes ~1 ms of Python, more than a serve batch's
kernel, and a server calls it with the same sizes every batch. It returns
``None`` exactly where the one-window-a-block engine this engine replaced
could not fit its shared memory (:func:`any_smem_bytes`), for either
sample width, and a plan of either design that fits everywhere else.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

#: threads a block, as the kernels' kThreads
THREADS = 256
#: bytes of one staged chunk (kChunkBytes)
CHUNK_BYTES = 16
#: W floats a thread fetches for one streamed chunk (kAnyFetch)
FETCH = 8
#: the largest k-tile (coefficients a pass of the contraction)
MAX_K_TILE = 128


#: the two designs (the plan's first field, ``kPhaseDesign`` and
#: ``kRingDesign``), by name
PHASE_DESIGN = 0
RING_DESIGN = 1
DESIGNS = ("phase", "ring")


def max_rows(sample_bytes: int) -> int:
    """The most rows one thread of the phase-by-phase design's contraction
    owns (``max_rows`` of window_features_any.cuh): 3 for int16 samples, 2
    for float32, whose kernels spill at 3."""
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
    """The phase-by-phase design's plan: ``csrc/window_features_any.cuh``
    ``AnyPlan`` after its design field (the first ten fields, in the
    launchers' order) and the shared memory it takes."""

    design: int       # PHASE_DESIGN
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
        return tuple(self[:10])


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
    """Bytes of shared memory of a phase-by-phase plan
    (``any_plan_smem_bytes``; ``plan_fields`` as :meth:`TilePlan.fields`):
    W (resident, or two chunk slots), z, the staging slot, the tile's rows
    and their subband groups' maxima."""
    _design, m, rz, _rr, tq_log2, jc, ep, base_chunks, seg_chunks, qq = plan_fields[:10]
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
    fields = (PHASE_DESIGN, m, rz, rr, tq_log2, jc, _z_stride(epoch), base_chunks, seg, qq)
    return TilePlan(*fields, plan_smem_bytes(fields, channels, epoch, features))


def resident_blocks(smem: int, smem_optin: int) -> int:
    """Blocks of ``smem`` bytes a multiprocessor runs at once (phase-by-phase
    design)."""
    return max(1, min(BLOCKS_PER_SM, (smem_optin + BLOCK_RESERVE) // (smem + BLOCK_RESERVE)))


def launch_cost(rows: int, plan: TilePlan, channels: int, sm_count: int,
                smem_optin: int) -> int:
    """The phase-by-phase design's choice of windows a tile: the launch's
    time in windows' worth of one block's work, the rounds of tiles each
    resident block walks, each m windows plus the fixed cost of each of its
    pieces."""
    tiles = -(-rows // plan.m)
    slots = sm_count * resident_blocks(plan.smem, smem_optin)
    pieces = -(-plan.m * channels // plan.rz)
    return -(-tiles // slots) * (plan.m + PIECE_OVERHEAD * pieces)


def phase_tile_plan(channels: int, epoch: int, features: int, rows: int, sm_count: int,
                    smem_optin: int, pre: int = 100, sample_bytes: int = 2) -> TilePlan:
    """The phase-by-phase design's plan of a launch within reach. For each
    count of windows a tile up to MAX_M (at most ``rows``) the plan keeps W
    resident and every sample staged if it fits, else streams W, else
    reads the baselines from device memory; of these the count with the
    least :func:`launch_cost` wins, the larger on a tie (a serve batch of
    64 on 132 multiprocessors: 1 window a tile). Where no count fits, one
    window a tile stages nothing, then halves the piece's rows, shrinks W's
    chunk to 4 rows and halves the k-tile, until it fits; the last of
    these takes less shared memory than :func:`any_smem_bytes`, so every
    size within reach has a plan."""
    tq = _natural_tq_log2(features)
    args = (channels, epoch, features, pre, sample_bytes)
    best = None
    for m in range(1, min(MAX_M, rows) + 1):
        qq = 1 if m * channels * features <= ONE_COLUMN_OUTPUTS else 4
        for resident, base in ((True, True), (False, True), (True, False), (False, False)):
            plan = _shape(m, *args, _natural_tq_log2(features, qq), resident=resident, base=base,
                          qq=qq)
            if plan.smem <= smem_optin:
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
            if plan.smem <= smem_optin:
                return plan
        if rz > 1:
            rz = max(1, rz // 2)
            continue
        plan = _shape(1, *args, tq, rz=1, resident=False, staged=False, jc=4)
        if plan.smem <= smem_optin:
            return plan
        if tq == 0:
            raise AssertionError("no phase-by-phase tile plan fits within the engine's reach")
        tq -= 1


def phase_launch_cost(rows: int, plan: TilePlan, channels: int, epoch: int, features: int,
                      sm_count: int, smem_optin: int, pre: int = 100,
                      sample_bytes: int = 2) -> float:
    """The phase-by-phase design's time in a multiprocessor's clocks, in the
    units of :func:`ring_launch_cost`, modelled on its measured device
    times (PERF.md section 6): the rounds of tiles the resident blocks walk,
    each tile a fixed cost (its first piece's staging and W's copies, which
    nothing overlaps, and its epilogue's chain) and its pieces in turn,
    each piece its barriers, its means and centre, its means' reads of
    device memory where the baselines are not staged, its contraction (the
    issue slots of a sub-partition's busiest warps, shared with the other
    block resident on the multiprocessor) and one barrier a streamed W
    chunk."""
    tiles = -(-rows // plan.m)
    blocks = resident_blocks(plan.smem, smem_optin)
    rounds = -(-tiles // (sm_count * blocks))
    kt = plan.qq << plan.tq_log2
    nk = -(-features // kt)
    e4 = _round4(epoch)
    tile_rows = plan.m * channels
    tile = PHASE_TILE_FIXED + -(-plan.m // 8) * PHASE_NORM
    for r0 in range(0, tile_rows, plan.rz):
        nr = min(plan.rz, tile_rows - r0)
        groups = -(-nr // 32)
        centre = groups * (pre + e4) / 32 * (PHASE_CENTRE_STEP if sample_bytes == 2
                                            else PHASE_CENTRE_STEP_F32)
        if plan.base_chunks == 0:
            centre += groups * MEANS_DEVICE * -(-pre // CHUNK_J)
        stage = -(-nr * (plan.base_chunks + plan.seg_chunks) // THREADS) * PHASE_STAGE_ISSUE
        warps = -(-(-(-nr // plan.rr) << plan.tq_log2) // 32)
        step = plan.rr * plan.qq * 4 + plan.rr + 4
        contract = nk * (e4 / 4) * step * -(-warps // 4) * blocks * PHASE_ISSUE
        chunks = nk * -(-e4 // plan.jc) * PHASE_CHUNK_FIXED if plan.jc else 0
        tile += PHASE_PIECE_FIXED + stage + centre + contract + chunks
    return rounds * tile


# ---------------------------------------------------------------------------
# The ring design (run_tiles_ring): 384 threads a block, one block a
# multiprocessor, the work handed on through a ring of chunk slots.

#: threads a block: 8 consumer warps (which also copy), 4 centring warps
RING_THREADS = 384
CONSUMER_THREADS = 256
#: registers a thread the kernels may use (``__launch_bounds__(384, 1)``:
#: 65,536 / 384, rounded down to the allocation unit of 8)
RING_REGISTERS = 168
#: samples of j a chunk (``kChunkJ``) and a row's floats in a slot
#: (``kRowFloats``: the 16-byte chunks that hold 32 samples at any offset,
#: 9 of float32 samples and 5 of int16, or the 32 centred floats)
CHUNK_J = 32
ROW_FLOATS = 36
#: words a row of a piece keeps beside the ring (``kRowWords``: two window
#: starts, its mean, resolution, analysis segment and offset, and the
#: first chunks of its analysis segment and baseline)
ROW_WORDS = 8
#: ring slots at most (``kMaxSlots``)
MAX_SLOTS = 4
#: bytes before the ring: the mbarriers (``kBarrierBytes``)
BARRIER_BYTES = 64
#: the consumers' register tiles: (rows, coefficients a thread, most column
#: threads), widest first; the 1 x 1 tile spreads a tile of few outputs
#: (a serve batch's one window) over more threads with shorter chains
RING_TILES = ((8, 4, 16), (4, 4, 16), (1, 1, 64))
#: the most windows a ring-design tile
RING_MAX_M = 128
#: The two cost models, in clocks of about 2 GHz (the fit's scale: 2.0
#: million to a millisecond of device time), fitted by ``chip_plans.py
#: --fit`` to 933 device times (K1-any and K5-any at f32) of 556 plans of
#: either design at chip_compare.py's generic cases and at 16,384 and
#: 32,768 windows, on int16 and float32 samples (``chip_plans.py`` on an
#: NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). The ring
#: design's: a copy's latency over the ring's slots, a tile's fixed cost
#: beside its epilogue, and a chunk's hand-off between the roles
COPY_LATENCY = 4000
TILE_FIXED = 2000
HANDOFF = 1416
#: clocks a consumer warp's FMA or shared load takes to issue, its
#: sub-partition shared with a centring warp
RING_ISSUE = 1.56
#: clocks a consumer warp of the 8 x 4 tile waits on a step's loads where
#: no other consumer warp shares its sub-partition
RING_STALL = 34
#: clocks a consumer pays to issue one 16-byte copy of the chunks ahead,
#: and one round of 32 rows' means from the staged baselines
COPY_ISSUE = 195
MEANS_ROUND = 5570
#: clocks of 32 rows' means a 32-sample chunk of baseline, where the
#: baselines are not staged and the means read device memory (either
#: design)
MEANS_DEVICE = 1868
#: clocks the centring warps take for 32 rows of a chunk (float32 samples:
#: four loads, two operations and four stores a lane; int16: three loads,
#: two byte permutes and four conversions, three operations and one store
#: for four samples: the fit does not tell the two apart)
CENTRE_ROWS = 490
#: the phase-by-phase design's: a tile's fixed cost, a piece's barriers
#: and staging wait, a step of four samples of a row's means and centre on
#: its 8 lanes (int16, float32), a streamed W chunk's barrier and copies,
#: and the epilogue's norms and finish, a round of 8 windows
PHASE_TILE_FIXED = 2000
PHASE_PIECE_FIXED = 7481
PHASE_CENTRE_STEP = 385
PHASE_CENTRE_STEP_F32 = 245
PHASE_CHUNK_FIXED = 298
PHASE_NORM = 250
#: clocks a thread of the phase-by-phase design takes to issue one 16-byte
#: copy of a piece's samples
PHASE_STAGE_ISSUE = 564
#: clocks a contracting warp's FMA or shared load takes to issue (times
#: the blocks resident on the multiprocessor)
PHASE_ISSUE = 2.04


class RingTilePlan(NamedTuple):
    """The ring design's plan: ``csrc/window_features_any.cuh`` ``RingPlan``
    after its design field (the first eight fields, in the launchers'
    order) and the shared memory it takes."""

    design: int       # RING_DESIGN
    m: int            # windows a tile
    rz: int           # (window, channel) rows a piece
    rr: int           # rows a consumer thread contracts: 1, 4 or 8
    qq: int           # coefficients a consumer thread contracts: 1 (rr 1) or 4
    tq: int           # consumer threads across a k-tile: kt = qq * tq
    slots: int        # ring slots, 1 to MAX_SLOTS
    base_floats: int  # a row's staged baseline floats, 0: read from device memory
    smem: int         # bytes of shared memory

    def fields(self) -> Tuple[int, ...]:
        """The ints the launchers take."""
        return tuple(self[:8])


def row_chunks(sample_bytes: int) -> int:
    """The 16-byte chunks a ring slot holds of a row: those of 32 samples
    at any offset (``row_chunks``: 9 of float32 samples, 5 of int16)."""
    return segment_chunks(CHUNK_J, sample_bytes)


def ring_plan_smem_bytes(plan_fields, channels: int, features: int) -> int:
    """Bytes of shared memory of a ring-design plan
    (``ring_plan_smem_bytes``; ``plan_fields`` as
    :meth:`RingTilePlan.fields`): the mbarriers, the ring (each slot the
    piece's rows, then W's chunk), the staged baselines, the tile's rows and
    their subband groups' maxima, and ROW_WORDS a row of the piece."""
    _design, m, rz, _rr, qq, tq, slots, base_floats = plan_fields[:8]
    slot = rz * ROW_FLOATS + CHUNK_J * qq * tq
    y = m * channels * (features + subband_groups(features))
    return BARRIER_BYTES + 4 * (slots * slot + rz * base_floats + y + ROW_WORDS * rz)


def _ring_tq(features: int, qq: int, most: int) -> int:
    """Column threads for ``features`` coefficients at ``qq`` a thread (at
    most ``most``); a 1 x 1 tile's is a multiple of 4, so W's chunk rows
    stay 16-byte aligned."""
    tq = min(most, -(-features // qq))
    return _round4(tq) if qq == 1 else tq


def _ring_plan(m, rz, rr, qq, tq, slots, base_floats, channels, features) -> RingTilePlan:
    fields = (RING_DESIGN, m, rz, rr, qq, tq, slots, base_floats)
    return RingTilePlan(*fields, ring_plan_smem_bytes(fields, channels, features))


def ring_launch_cost(rows: int, plan: RingTilePlan, channels: int, epoch: int, features: int,
                     sm_count: int, pre: int = 100, sample_bytes: int = 2) -> float:
    """The ring design's time in a multiprocessor's clocks, modelled on its
    measured device times (PERF.md section 6): the rounds of tiles each
    multiprocessor walks (one block each), each tile a fixed cost (its
    first piece's copies and means and its epilogue, which the pipeline
    hides only in part) and its pieces' chunks, a chunk the slowest of its
    consumers (the issue slots of the busiest sub-partition's warps: FMAs
    and their shared loads, and the copies of the chunks ahead, row_chunks
    a row, where the piece leaves fewer than two consumer warps idle to
    issue them), the idle warps' copies, its centring and its copies'
    latency over the ring's slots, and each later piece's means."""
    tiles = -(-rows // plan.m)
    rounds = -(-tiles // sm_count)
    kt = plan.qq * plan.tq
    nk = -(-features // kt)
    nc = -(-epoch // CHUNK_J)
    tile_rows = plan.m * channels
    loads = (plan.rr + plan.qq) / (plan.rr * plan.qq * 4.0) if plan.qq == 4 else 1.0
    tile = TILE_FIXED + -(-plan.m // 12) * (channels * features / 32 * 40 + 1500)
    for r0 in range(0, tile_rows, plan.rz):
        nr = min(plan.rz, tile_rows - r0)
        warps = -(-(-(-nr // plan.rr)) * plan.tq // 32)
        consume = (-(-warps // 4) * plan.rr * plan.qq * CHUNK_J * (1.0 + loads) * RING_ISSUE
                   + HANDOFF)
        if plan.rr == 8 and warps <= 4:
            # the 8 x 4 tile's steps are not unrolled: a warp alone on its
            # sub-partition waits on each step's loads
            consume += CHUNK_J / 4 * RING_STALL
        # the copies of a chunk ahead: by the warps the piece leaves idle,
        # or by every consumer warp beside its contraction
        copiers = CONSUMER_THREADS // 32 - warps
        if copiers < 2:
            copiers = CONSUMER_THREADS // 32
        copies = -(-(nr * row_chunks(sample_bytes) + CHUNK_J * kt // 4) // (copiers * 32))
        copy = copies * COPY_ISSUE
        if copiers == CONSUMER_THREADS // 32:
            consume, copy = consume + copy, 0
        centre = -(-nr // 32) * CENTRE_ROWS + 100
        chunk = max(consume, centre, copy, COPY_LATENCY / plan.slots)
        # the means: 32 rows at a time, from the staged baselines or, a few
        # loads at a time, from device memory
        means = -(-nr // 32) * (MEANS_ROUND if plan.base_floats
                                else MEANS_DEVICE * -(-pre // CHUNK_J))
        tile += nk * nc * chunk + means
    return rounds * tile


def ring_tile_plan(channels: int, epoch: int, features: int, rows: int, sm_count: int,
                   smem_optin: int, pre: int = 100, sample_bytes: int = 2) -> RingTilePlan:
    """The ring design's plan of a launch within reach. For each register
    tile of ``RING_TILES`` and each count of windows a tile up to
    RING_MAX_M (at most ``rows``), a piece takes the tile's rows up to
    what the tile's consumers hold, with the most ring slots that fit and
    the baselines staged where they fit; the least :func:`ring_launch_cost`
    wins (the first found on a tie; past 16 windows only the counts that
    spread the tiles evenly over the multiprocessors' rounds are tried).
    Where none fits, one window a tile halves the piece's rows, then the
    column threads, then the slots, staging no baseline, until it fits: one
    row, 4 coefficients and one slot take 172 floats beside the row, fewer
    than the ``epoch + 256`` of :func:`any_smem_bytes`, so every size within
    reach has a plan."""
    base = 4 * segment_chunks(pre, sample_bytes)
    top = min(RING_MAX_M, rows)
    counts = set(range(1, min(16, top) + 1))
    for r in range(1, -(-rows // (17 * sm_count)) + 1):
        m = -(-rows // (r * sm_count))
        if m <= top:
            counts.add(m)
    counts.add(top)
    best = None
    for rr, qq, most in RING_TILES:
        tq = _ring_tq(features, qq, most)
        cap = rr * (CONSUMER_THREADS // tq)
        for m in sorted(counts):
            rz = min(m * channels, cap)
            plan = None
            for base_floats in (base, 0):
                for slots in range(MAX_SLOTS, 1, -1):
                    candidate = _ring_plan(m, rz, rr, qq, tq, slots, base_floats, channels,
                                           features)
                    if candidate.smem <= smem_optin:
                        plan = candidate
                        break
                if plan is not None:
                    break
            if plan is None:
                break  # more windows only take more shared memory
            cost = ring_launch_cost(rows, plan, channels, epoch, features, sm_count, pre,
                                    sample_bytes)
            if best is None or cost < best[0]:
                best = (cost, plan)
    if best is not None:
        return best[1]
    rr, qq, most = RING_TILES[1]
    tq = _ring_tq(features, qq, most)
    rz = min(channels, rr * (CONSUMER_THREADS // tq))
    while True:
        for slots in range(MAX_SLOTS, 0, -1):
            plan = _ring_plan(1, rz, rr, qq, tq, slots, 0, channels, features)
            if plan.smem <= smem_optin:
                return plan
        if rz > 1:
            rz = max(1, rz // 2)
        elif tq > 1:
            tq = max(1, tq // 2)
        else:
            raise AssertionError("no ring-design tile plan fits within the engine's reach")


def launch_clocks(rows: int, plan, channels: int, epoch: int, features: int, sm_count: int,
                  smem_optin: int, pre: int = 100, sample_bytes: int = 2) -> float:
    """A plan's modelled time in clocks, by its design's cost model."""
    if plan.design == RING_DESIGN:
        return ring_launch_cost(rows, plan, channels, epoch, features, sm_count, pre,
                                sample_bytes)
    return phase_launch_cost(rows, plan, channels, epoch, features, sm_count, smem_optin, pre,
                             sample_bytes)


@functools.lru_cache(maxsize=4096)
def design_plans(channels: int, epoch: int, features: int, rows: int, sm_count: int,
                 smem_optin: int, pre: int = 100, sample_bytes: int = 2):
    """Both designs' plans of a launch within reach, each with its modelled
    clocks: ((phase plan, clocks), (ring plan, clocks)); ``None`` outside
    the engine's reach."""
    if min(channels, epoch, features, rows, sm_count, pre, sample_bytes) < 1:
        raise ValueError("generic_tile_plan needs positive sizes")
    if any_smem_bytes(channels, epoch, features) > smem_optin:
        return None
    out = []
    for plan_of in (phase_tile_plan, ring_tile_plan):
        plan = plan_of(channels, epoch, features, rows, sm_count, smem_optin, pre, sample_bytes)
        out.append((plan, launch_clocks(rows, plan, channels, epoch, features, sm_count,
                                        smem_optin, pre, sample_bytes)))
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def generic_tile_plan(channels: int, epoch: int, features: int, rows: int, sm_count: int,
                      smem_optin: int, pre: int = 100, sample_bytes: int = 2):
    """The tile plan of a generic launch of ``rows`` windows of
    ``channels`` channels, ``epoch`` samples and ``features`` coefficients
    a channel (baseline ``pre``, samples of ``sample_bytes``), on a card
    of ``sm_count`` multiprocessors whose blocks may opt in to
    ``smem_optin`` bytes of shared memory; ``None`` where the sizes lie
    outside the engine's reach (:func:`any_smem_bytes` over the limit),
    for either design and sample width.

    Each design plans the launch (:func:`phase_tile_plan`,
    :func:`ring_tile_plan`) and the plan whose modelled clocks
    (:func:`phase_launch_cost`, :func:`ring_launch_cost`) are the fewer
    is returned (the ring design's on a tie): a :class:`TilePlan` or a
    :class:`RingTilePlan`, its design in its first field."""
    plans = design_plans(channels, epoch, features, rows, sm_count, smem_optin, pre,
                         sample_bytes)
    if plans is None:
        return None
    (phase, phase_clocks), (ring, ring_clocks) = plans
    return phase if phase_clocks < ring_clocks else ring
