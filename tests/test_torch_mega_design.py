"""The float32-sample megakernel's design choice at 512 / 16
(``ops/serve_mega_cuda.mega_design``): run_windows or the tile design
(``csrc/window_tiles.cuh``), picked per launch from its sizes and the
card. CPU only: the choice is a pure function, and its mirror of the
tile design's shared memory and reach is held against the CUDA source."""

from __future__ import annotations

import os
import re

import pytest
import torch

from eeg_dataanalysispackage_tpu_torch.ops import dwt, serve_mega, serve_mega_cuda as smc

RING, TILES = smc.MEGA_DESIGNS.index("ring"), smc.MEGA_DESIGNS.index("tiles")
H100 = (132, 232_448)  # multiprocessors, per-block shared-memory opt-in bytes
STRIDE = serve_mega.padded_stride(100, 750)
SOURCE = os.path.join(os.path.dirname(smc.__file__), "..", "csrc", "window_tiles.cuh")


def _design(capacity, channels=3, card=H100, pre=100, stride=STRIDE, sample_bytes=4,
            aligned=True):
    return smc.mega_design(capacity, channels, *card, pre, stride, sample_bytes, aligned)


def test_designs_are_named_in_the_launchers_order():
    assert smc.MEGA_DESIGNS == ("ring", "tiles")


@pytest.mark.parametrize("card", [H100, (114, 232_448), (144, 232_448)])
def test_one_serve_batch_keeps_run_windows(card):
    assert _design(64, card=card) == RING


@pytest.mark.parametrize("card", [H100, (114, 232_448), (144, 232_448)])
def test_a_large_batch_takes_the_tile_design(card):
    assert _design(32_768, card=card) == TILES


@pytest.mark.parametrize("sms", [1, 114, 132, 144])
def test_the_crossover_is_the_documented_one(sms):
    edge = smc.tiles_crossover(sms)
    assert edge == smc.TILES_WINDOWS_PER_SM * sms
    assert _design(edge - 1, card=(sms, H100[1])) == RING
    assert _design(edge, card=(sms, H100[1])) == TILES


def test_the_crossover_on_the_h100():
    # the value the source notes and PERF.md give for 132 multiprocessors
    assert smc.tiles_crossover(132) == 1_056


@pytest.mark.parametrize("capacity, kwargs", [
    (32_768, {"sample_bytes": 2}),          # int16 samples: the ring engine
    (32_768, {"channels": 4}),              # past the register tile's 3 channels
    (32_768, {"channels": 76}),             # a wide montage: the wide ring
    (32_768, {"pre": 254}),                 # a 256-sample baseline box still fits
    (32_768, {"pre": 257}),                 # a baseline past one box
    (32_768, {"stride": 898}),              # a stride the tensor map cannot take
    (32_768, {"aligned": False}),           # a stream off a 16-byte boundary
    (32_768, {"card": (132, 150_000)}),     # two stages do not fit
    (32_768, {"card": (132, 48 * 1024)}),   # no opt-in
])
def test_out_of_reach_launches_stay_on_run_windows(capacity, kwargs):
    channels = kwargs.get("channels", 3)
    pre = kwargs.get("pre", 100)
    card = kwargs.get("card", H100)
    reach = (kwargs.get("sample_bytes", 4) == 4 and channels <= smc.TILE_MAX_CHANNELS
             and 4 * ((pre + 3) // 4) <= smc.TILE_MAX_BOX and kwargs.get("stride", STRIDE) % 4 == 0
             and kwargs.get("aligned", True)
             and smc.tiles_smem_bytes(channels, pre, smc.TILE_MIN_STAGES) <= card[1])
    assert _design(capacity, **kwargs) == (TILES if reach else RING)


@pytest.mark.parametrize("capacity", [1, 7, 8, 9, 64, 320, 1_001, 1_024, 4_096, 32_768,
                                      2**31 // 896])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 8, 76])
def test_every_launch_gets_a_design(capacity, channels):
    # run_windows reaches every launch the kernel takes; the tile design
    # only what its reach admits
    d = _design(capacity, channels)
    assert d in (RING, TILES)
    if d == TILES:
        assert channels <= smc.TILE_MAX_CHANNELS and capacity >= smc.tiles_crossover(132)


def test_the_choice_is_pure_and_memoized():
    smc.mega_design.cache_clear()
    first = [_design(n) for n in (64, 4_096, 32_768)]
    hits = smc.mega_design.cache_info().hits
    again = [_design(n) for n in (64, 4_096, 32_768)]
    assert again == first
    assert smc.mega_design.cache_info().hits == hits + 3


@pytest.mark.parametrize("channels, pre, stages, resident, want", [
    # stages of 16 group boxes (channels x 4 rows of 36 floats, each on a
    # 128-byte boundary) and the baseline box, rounded up to 128 bytes; W
    # in 16 padded groups (33,792 bytes); two tiles' partials and rows;
    # res and the epilogue's resident bytes, each 16-byte aligned; 22
    # barriers; 128 bytes of alignment
    (3, 100, 2, 0, 128 + 2 * (16 * 1_792 + 4_864) + 33_792 + 13_824 + 16 + 176),
    (3, 100, 5, 0, 215_616),
    (3, 100, 6, 0, 249_152),
    (3, 100, 5, 224, 215_840),       # K5's weights: five stages fit the H100's 232,448
    (3, 100, 4, 24_608, 206_688),    # K6's f32 stack: four
    (3, 100, 5, 24_608, 240_224),
    (1, 100, 4, 0, 128 + 4 * (16 * 640 + 1_664) + 33_792 + 4_608 + 16 + 176),
    (2, 7, 2, 0, 128 + 2 * (16 * 1_152 + 256) + 33_792 + 9_216 + 16 + 176),
])
def test_shared_memory_mirrors_the_source(channels, pre, stages, resident, want):
    assert smc.tiles_smem_bytes(channels, pre, stages, resident) == want


@pytest.mark.parametrize("channels, want", [(1, 8_224), (2, 16_416), (3, 24_608)])
def test_the_largest_epilogue_state_is_the_f32_stack(channels, want):
    # 128 lanes of channels x 16 floats, and 8 lane slots
    assert smc.tiles_resident_bytes(channels) == want


@pytest.mark.parametrize("name, value", [
    ("kWindows", smc.TILE_WINDOWS),
    ("kMaxChannels", smc.TILE_MAX_CHANNELS),
    ("kMinStages", smc.TILE_MIN_STAGES),
    ("kMaxStages", smc.TILE_MAX_STAGES),
])
def test_constants_match_the_cuda_source(name, value):
    with open(SOURCE) as f:
        text = f.read()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found and int(found.group(1)) == value


def test_cpu_launches_count_no_design():
    stride = STRIDE
    rng = torch.Generator().manual_seed(3)
    stream = torch.randn((3, 64 * stride), generator=rng)
    W = dwt.kernel_operator(8, 512, 16, torch.device("cpu"))
    before = (smc.F32S_DESIGN_RING, smc.F32S_DESIGN_TILES)
    got = smc.serve_mega_margins(stream, torch.ones(3), W, torch.randn(48, generator=rng), 100,
                                 175, stride)
    assert got.shape == (64,) and bool(torch.isfinite(got).all())
    assert (smc.F32S_DESIGN_RING, smc.F32S_DESIGN_TILES) == before


def test_chip_tiles_imports_nothing_of_jax():
    # the tile design's measurement script runs on the card's host, which
    # has no JAX: neither JAX nor the JAX package may be imported
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_tiles.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                        "eeg_dataanalysispackage_tpu")]
    assert "eeg_dataanalysispackage_tpu_torch.ops" in names
