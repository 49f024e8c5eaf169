"""The tile plan of the fused kernels' generic engine
(``ops/generic_plan.generic_tile_plan``), on the CPU: where it refuses,
that it fits where it does not, how many windows a tile it takes, which
design it picks and that it is a pure function of its inputs, for int16
(``sample_bytes`` 2) and float32 (4) samples.

The refusal boundary is held against the one-window-a-block engine's
shared memory, copied here from its source as it stood
(``window_features.cuh`` ``any_smem_bytes``): the redesign keeps that
engine's reach exactly, in both designs.
"""

import pytest

from eeg_dataanalysispackage_tpu_torch.ops import cuda_build, dwt, generic_plan

#: an H100's multiprocessors and per-block shared-memory opt-in limit
SMS = 132
OPTIN = 232_448
PHASE, RING = generic_plan.PHASE_DESIGN, generic_plan.RING_DESIGN
WIDTHS = [2, 4]


def old_any_smem_bytes(channels, epoch, features):
    """The one-window-a-block engine's shared memory: 8 doubles, then the
    row, one channel's window, 256 partials and the subband groups'
    maxima as floats."""
    groups, lo = 1, 1
    while lo < features:
        groups += 1
        lo *= 2
    return 8 * 8 + (channels * features + epoch + 256 + channels * groups) * 4


# (channels, epoch, features): the card tests' and chip_smoke.py's generic
# sizes, the wide montage, the largest rows at a 750-sample window and one
# coefficient past them, long windows, and sizes either side of the limit
SIZES = [
    (3, 256, 16), (3, 512, 64), (3, 333, 20), (3, 700, 32), (3, 1, 1), (3, 100, 3),
    (3, 16, 16), (3, 600, 300), (76, 333, 20), (76, 750, 745), (76, 750, 740),
    (76, 750, 741), (75, 750, 745), (77, 750, 730), (77, 750, 731), (1, 57_000, 1),
    (1, 57_900, 1), (1, 30_000, 27_800), (2, 9_000, 8_000), (128, 512, 64),
    (300, 256, 128), (1_000, 64, 40), (64, 750, 745), (16, 2_048, 2_000),
]


@pytest.mark.parametrize("channels,epoch,features", SIZES)
@pytest.mark.parametrize("sample_bytes", WIDTHS)
def test_refusal_boundary_is_the_old_engines(channels, epoch, features, sample_bytes):
    """A plan exists exactly where the old engine's shared memory fits the
    limit, for either sample width, and every plan of either design fits
    the limit and the launcher's checks."""
    for rows in (1, 64, 4_096):
        plan = generic_plan.generic_tile_plan(channels, epoch, features, rows, SMS, OPTIN, 100,
                                              sample_bytes)
        both = generic_plan.design_plans(channels, epoch, features, rows, SMS, OPTIN, 100,
                                         sample_bytes)
        assert (plan is None) == (old_any_smem_bytes(channels, epoch, features) > OPTIN)
        assert (both is None) == (plan is None)
        assert generic_plan.any_smem_bytes(channels, epoch, features) == old_any_smem_bytes(
            channels, epoch, features)
        if plan is None:
            continue
        assert plan in [p for p, _clocks in both]
        for each, _clocks in both:
            _assert_consistent(each, channels, epoch, features, 100, sample_bytes)


def _assert_consistent(plan, channels, epoch, features, pre=100, sample_bytes=2):
    """The launchers' checks (csrc/window_features_any.cuh check_any_plan
    for the phase-by-phase design, check_ring_plan for the ring one) and
    the launch array's layout: the design, then the design's fields."""
    assert plan.smem <= OPTIN
    fields = plan.fields()
    assert fields[0] == plan.design
    if plan.design == RING:
        _assert_ring_consistent(plan, channels, features, pre, sample_bytes)
        assert len(fields) == 8
        return
    assert plan.design == PHASE and len(fields) == 10
    assert plan.smem == generic_plan.plan_smem_bytes(fields, channels, epoch, features)
    kt = plan.qq << plan.tq_log2
    assert 1 <= plan.m <= 1024 and plan.qq in (1, 4) and kt <= 128
    assert 1 <= plan.rr <= (3 if sample_bytes == 2 else 2)
    assert plan.rr <= generic_plan.max_rows(sample_bytes)
    assert 1 <= plan.rz <= (256 >> plan.tq_log2) * plan.rr and plan.rz <= plan.m * channels
    assert plan.jc == 0 or (plan.jc >= 4 and plan.jc % 4 == 0 and plan.jc * kt <= 256 * 8)
    assert plan.ep >= (epoch + 3) // 4 * 4 and plan.ep % 32 == 4
    if plan.seg_chunks == 0:
        assert plan.base_chunks == 0
    else:
        assert plan.seg_chunks == generic_plan.segment_chunks(epoch, sample_bytes)
        assert plan.base_chunks in (0, generic_plan.segment_chunks(pre, sample_bytes))


def _assert_ring_consistent(plan, channels, features, pre=100, sample_bytes=2):
    """The ring design's launcher checks (check_ring_plan), and the
    register budget it launches with: 384 threads of 168 registers on one
    multiprocessor, each consumer thread's tile one of RING_TILES; a slot's
    row region holds the row's raw chunks at either sample width."""
    assert isinstance(plan, generic_plan.RingTilePlan)
    assert (plan.rr, plan.qq) in [(rr, qq) for rr, qq, _ in generic_plan.RING_TILES]
    most = {(rr, qq): most for rr, qq, most in generic_plan.RING_TILES}[(plan.rr, plan.qq)]
    assert 1 <= plan.tq <= most and (plan.qq == 4 or plan.tq % 4 == 0)
    assert 1 <= plan.m <= 1024 and 1 <= plan.slots <= generic_plan.MAX_SLOTS
    assert 1 <= plan.rz <= plan.rr * (256 // plan.tq) and plan.rz <= plan.m * channels
    assert plan.base_floats in (0, 4 * generic_plan.segment_chunks(pre, sample_bytes))
    assert plan.smem == generic_plan.ring_plan_smem_bytes(plan.fields(), channels, features)
    assert generic_plan.RING_THREADS * generic_plan.RING_REGISTERS <= 65_536
    assert 4 * generic_plan.row_chunks(sample_bytes) <= generic_plan.ROW_FLOATS
    assert generic_plan.row_chunks(sample_bytes) == (5 if sample_bytes == 2 else 9)


# chip_smoke.py's GENERIC_SIZES (epoch, features) on 3 channels, and its
# 76-channel montage at GENERIC_WIDE
SMOKE_SIZES = [(3, 256, 16), (3, 512, 64), (3, 333, 20), (3, 700, 32), (76, 333, 20)]


@pytest.mark.parametrize("rows", [64, 4_096])
@pytest.mark.parametrize("channels,epoch,features", SMOKE_SIZES)
@pytest.mark.parametrize("sample_bytes", WIDTHS)
def test_plan_at_the_smoke_sizes(channels, epoch, features, rows, sample_bytes):
    """At the smoke's sizes both designs' plans fit and pass the launcher's
    checks; a serve batch of 64 on 3 channels takes one window a tile (64
    blocks), on the one-row tile in the ring design; 4,096 windows take
    several windows a tile, on a register tile of at least 4 x 4 with the
    baselines staged in the ring design."""
    phase, ring = (p for p, _clocks in generic_plan.design_plans(
        channels, epoch, features, rows, SMS, OPTIN, 100, sample_bytes))
    plan = generic_plan.generic_tile_plan(channels, epoch, features, rows, SMS, OPTIN, 100,
                                          sample_bytes)
    for each in (phase, ring, plan):
        _assert_consistent(each, channels, epoch, features, 100, sample_bytes)
    if channels == 3 and rows == 64:
        assert plan.m == phase.m == ring.m == 1 and (ring.rr, ring.qq) == (1, 1)
    if channels == 3 and rows == 4_096:
        assert plan.m >= 4 and phase.m >= 4 and ring.rr >= 4 and ring.base_floats > 0


@pytest.mark.parametrize("sample_bytes", WIDTHS)
def test_widest_row_at_a_750_sample_window(sample_bytes):
    """76 channels at a 750-sample window: 740 coefficients (within the
    cascade's 745) are the most the old engine took, and plan in both
    designs; 741 do not."""
    dwt.check_feature_size(8, 750, 741)
    args = (SMS, OPTIN, 100, sample_bytes)
    assert generic_plan.generic_tile_plan(76, 750, 740, 8, *args) is not None
    assert all(p is not None for p, _c in generic_plan.design_plans(76, 750, 740, 8, *args))
    assert generic_plan.generic_tile_plan(76, 750, 741, 8, *args) is None


@pytest.mark.parametrize("channels,epoch,features", SIZES[:8])
@pytest.mark.parametrize("sample_bytes", WIDTHS)
def test_one_window_a_tile_at_a_serve_batch(channels, epoch, features, sample_bytes):
    """A capacity-64 batch on 132 multiprocessors takes one window a tile,
    so its 64 windows spread over 64 blocks, in either design."""
    plan = generic_plan.generic_tile_plan(channels, epoch, features, 64, SMS, OPTIN, 100,
                                          sample_bytes)
    assert plan.m == 1
    for each, _clocks in generic_plan.design_plans(channels, epoch, features, 64, SMS, OPTIN,
                                                   100, sample_bytes):
        assert each.m == 1


@pytest.mark.parametrize("channels,epoch,features",
                         [s for s in SIZES if old_any_smem_bytes(*s) <= OPTIN])
def test_windows_a_tile_rise_with_rows_and_fit(channels, epoch, features):
    """In the phase-by-phase design on int16 samples more rows never take
    fewer windows a tile; thousands of windows take several in the chosen
    plan where shared memory allows, and no plan passes the limit."""
    last = 0
    for rows in (1, 7, 64, 300, 1_000, 4_096, 32_768, 1_000_000):
        plan = generic_plan.design_plans(channels, epoch, features, rows, SMS, OPTIN)[PHASE][0]
        chosen = generic_plan.generic_tile_plan(channels, epoch, features, rows, SMS, OPTIN)
        assert plan.m >= last and plan.smem <= OPTIN and chosen.smem <= OPTIN
        last = plan.m
    if (channels, epoch, features) in [(3, 256, 16), (3, 333, 20), (3, 700, 32), (3, 512, 64)]:
        assert generic_plan.generic_tile_plan(channels, epoch, features, 4_096, SMS,
                                              OPTIN).m >= 4


@pytest.mark.parametrize("sample_bytes,pre", [(2, 100), (4, 100), (2, 2_800), (4, 40_000)])
def test_plan_is_deterministic_and_fits_any_baseline(sample_bytes, pre):
    """The same inputs give the same plan, the memoized one included; a
    baseline too long to stage is read from device memory (no baseline
    chunks) in both designs, and float32 samples stage twice the bytes of
    int16."""
    for channels, epoch, features in SIZES[:9]:
        a = generic_plan.generic_tile_plan(channels, epoch, features, 4_096, SMS, OPTIN, pre,
                                           sample_bytes)
        b = generic_plan.generic_tile_plan.__wrapped__(channels, epoch, features, 4_096, SMS,
                                                       OPTIN, pre, sample_bytes)
        assert a == b and a.smem <= OPTIN
        _assert_consistent(a, channels, epoch, features, pre, sample_bytes)
        phase, ring = (p for p, _c in generic_plan.design_plans(
            channels, epoch, features, 4_096, SMS, OPTIN, pre, sample_bytes))
        if pre == 40_000:
            assert phase.base_chunks == 0 and ring.base_floats == 0
        if pre == 100:  # a 100-sample baseline: 14 chunks of int16, 26 of float32
            staged = 14 if sample_bytes == 2 else 26
            assert phase.base_chunks in (0, staged) and ring.base_floats in (0, 4 * staged)


@pytest.mark.parametrize("rows", [1, 64, 4_096])
def test_plan_and_its_array_are_memoized(rows):
    """A launch's plan is searched once for its sizes (the search is more
    host time than a serve batch's kernel), and its launch array is made
    once: a second call returns the same objects without a search; so for
    float32 samples; the array's first int is the plan's design."""
    for sample_bytes in (2, 4):
        args = (3, 256, 16, rows, SMS, OPTIN, 100, sample_bytes)
        first = generic_plan.generic_tile_plan(*args)
        misses = generic_plan.generic_tile_plan.cache_info().misses
        assert generic_plan.generic_tile_plan(*args) is first
        assert generic_plan.generic_tile_plan.cache_info().misses == misses
        assert first == generic_plan.generic_tile_plan.__wrapped__(*args)
        array = cuda_build.plan_array(first)
        assert cuda_build.plan_array(first) is array and tuple(array) == first.fields()
        assert array[0] == first.design
    assert cuda_build.plan_array(None) is None


def test_plan_refuses_nonpositive_sizes():
    with pytest.raises(ValueError):
        generic_plan.generic_tile_plan(0, 256, 16, 64, SMS, OPTIN)


# The timed cases of chip_compare.py (4,096 windows of 3 channels at the
# four GENERIC_SIZES, a serve batch of 64 at GENERIC_PATH_SIZE, 256 windows
# of 76 channels at GENERIC_WIDE) and the design the plan picks for each,
# on int16 (2) and float32 (4) samples
# (as measured on the card: PERF.md section 6)
TIMED = {
    (3, 256, 16, 4_096): {2: PHASE, 4: RING},
    (3, 333, 20, 4_096): {2: RING, 4: RING},
    (3, 700, 32, 4_096): {2: RING, 4: RING},
    (3, 512, 64, 4_096): {2: RING, 4: RING},
    (3, 256, 16, 64): {2: PHASE, 4: PHASE},
    (76, 333, 20, 256): {2: RING, 4: RING},
}


@pytest.mark.parametrize("case", sorted(TIMED))
@pytest.mark.parametrize("sample_bytes", WIDTHS)
def test_design_at_each_timed_case(case, sample_bytes):
    """Each timed case gets the design the cost models find faster, and
    the chosen plan's modelled clocks are the lower of the two designs'
    (the ring design's on a tie)."""
    (phase, phase_clocks), (ring, ring_clocks) = generic_plan.design_plans(
        *case, SMS, OPTIN, 100, sample_bytes)
    plan = generic_plan.generic_tile_plan(*case, SMS, OPTIN, 100, sample_bytes)
    assert plan.design == TIMED[case][sample_bytes]
    assert plan is (phase if phase_clocks < ring_clocks else ring)
    chosen = phase_clocks if plan.design == PHASE else ring_clocks
    assert chosen == min(phase_clocks, ring_clocks)
    assert chosen == generic_plan.launch_clocks(case[3], plan, *case[:3], SMS, OPTIN, 100,
                                                sample_bytes)
