"""The serve megakernel's wrapper (``csrc/serve_mega.cu``).

Counterpart of the JAX package's Pallas megakernel
(``ops/serve_mega.py:259``, ``_make_mega_kernel``): a micro-batch of
windows at a regular stride -> one margin per window, features kept on
chip; at ``precision`` int8 or int4, quantized before the margin. The
stream is int16 (INT_16 recordings) or float32 (other formats, staged
already scaled with unit resolutions, the ``stage_raw`` convention): a
float32 stream runs the kernel's float32-sample instantiations (K5-f32s,
K5-int8-f32s, K5-int4-f32s; K6-f32s, K6-w8-f32s, K6-w4-f32s), each with
its own counter (the ``_F32S`` names).

:func:`serve_mega_margins` checks its inputs, then for CUDA tensors
launches the kernel (and counts the launch in the counter of its
instantiation: :data:`LAUNCHES`, :data:`LAUNCHES_INT8` or
:data:`LAUNCHES_INT4` on int16 samples, :data:`LAUNCHES_F32S`,
:data:`LAUNCHES_INT8_F32S` or :data:`LAUNCHES_INT4_F32S` on float32
ones), and for CPU tensors runs the plain version,
``serve_mega.serve_mega_margins_plain``. A CUDA launch that fails
raises; nothing falls back to the plain version on the card.

:func:`serve_mega_multi_margins` is K6, the tenant-stacked kernel
(``ops/serve_mega.py:484`` of the JAX package, ``_mega_multi_program``):
the same kernel's ``kMulti`` instantiation, each window dotted with its
tenant's row of a (128, C*K) f32 stack, counted in
:data:`MULTI_LAUNCHES`. :func:`serve_mega_multi_packed_margins` is K6-w8
and K6-w4: the stack resident as packed int8 levels or int4 nibble pairs
with one scale a lane (``ops/quant.py``), dequantized term by term in the
kernel, counted in :data:`MULTI_LAUNCHES_INT8` and
:data:`MULTI_LAUNCHES_INT4`. The lanes come from the host, where their
range is checked before they are copied to the card.

The main path's sizes (a 512-sample window, 16 coefficients a channel)
run the kernel's ring engine (``run_windows``); on float32 samples they
run one of two designs, picked per launch by :func:`mega_design` (a pure
function of the launch's sizes and the card) and counted by design in
:data:`F32S_DESIGN_RING` and :data:`F32S_DESIGN_TILES`: ``run_windows``,
or the tile design (``csrc/window_tiles.cuh``: persistent blocks walking
tiles of 4 windows through TMA-fed stages by warp role) from
:func:`tiles_crossover` windows on. Every other window and coefficient count
runs its generic engine, counted apart (the ``ANY_`` counters, and by
the design its plan picked in ``ANY_DESIGN_PHASE`` / ``ANY_DESIGN_RING``),
tiled as ``generic_plan.generic_tile_plan`` plans for the launch and the
card. A size outside the generic engine's reach raises a ``ValueError``
naming the sizes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, decode_ingest, dwt, generic_plan, serve_mega

#: kernel launches made by this process (the wrapper adds one per
#: launch), one counter per instantiation: f32, int8, int4 on int16
#: samples, and the same on float32 samples (``_F32S``)
LAUNCHES = 0
LAUNCHES_INT8 = 0
LAUNCHES_INT4 = 0
LAUNCHES_F32S = 0
LAUNCHES_INT8_F32S = 0
LAUNCHES_INT4_F32S = 0
#: launches of the tenant-stacked instantiations: K6 (f32 stack), K6-w8
#: and K6-w4 (packed stacks), on int16 and on float32 samples
MULTI_LAUNCHES = 0
MULTI_LAUNCHES_INT8 = 0
MULTI_LAUNCHES_INT4 = 0
MULTI_LAUNCHES_F32S = 0
MULTI_LAUNCHES_INT8_F32S = 0
MULTI_LAUNCHES_INT4_F32S = 0
#: launches of the generic engine (every size but 512 / 16), one counter
#: per instantiation as above
ANY_LAUNCHES = 0
ANY_LAUNCHES_INT8 = 0
ANY_LAUNCHES_INT4 = 0
ANY_LAUNCHES_F32S = 0
ANY_LAUNCHES_INT8_F32S = 0
ANY_LAUNCHES_INT4_F32S = 0
ANY_MULTI_LAUNCHES = 0
ANY_MULTI_LAUNCHES_INT8 = 0
ANY_MULTI_LAUNCHES_INT4 = 0
ANY_MULTI_LAUNCHES_F32S = 0
ANY_MULTI_LAUNCHES_INT8_F32S = 0
ANY_MULTI_LAUNCHES_INT4_F32S = 0
#: the generic launches above by the design their plan chose
#: (``generic_plan.DESIGNS``): the phase-by-phase one and the ring one
ANY_DESIGN_PHASE = 0
ANY_DESIGN_RING = 0
#: the float32-sample launches at 512 / 16 (K5-f32s and K6-f32s at every
#: rung and stack) by the design :func:`mega_design` picked
F32S_DESIGN_RING = 0
F32S_DESIGN_TILES = 0

#: the float32-sample megakernel's designs at 512 / 16, in the launchers'
#: code: ``run_windows`` (one window a block in flight, four blocks a
#: multiprocessor) and the tile design (``csrc/window_tiles.cuh``)
MEGA_DESIGNS = ("ring", "tiles")
#: windows a tile of the tile design, the channels its register tile
#: holds, the most samples of a tensor-map box's dimension, and its
#: stages: at least 2, at most 6 (as many as the block's shared memory
#: holds)
TILE_WINDOWS = 4
TILE_MAX_CHANNELS = 3
TILE_MAX_BOX = 256
TILE_MIN_STAGES = 2
TILE_MAX_STAGES = 6
#: the tile design's crossover in windows a multiprocessor: launches of at
#: least this many windows a multiprocessor (1,056 on the H100's 132) take
#: it. On an H100 the two designs tie at 1,024 windows and the tile design
#: takes 26-29% less time at 4,096 (PERF.md section 6, PR 28:
#: device times of both designs at 64, 320, 1,024, 4,096 and 32,768
#: windows, chip_compare.py)
TILES_WINDOWS_PER_SM = 8

_COUNTERS = {"f32": "LAUNCHES", "int8": "LAUNCHES_INT8", "int4": "LAUNCHES_INT4"}
_MULTI_COUNTERS = {"f32": "MULTI_LAUNCHES", "int8": "MULTI_LAUNCHES_INT8",
                   "int4": "MULTI_LAUNCHES_INT4"}
#: the stream dtypes the kernel takes
SAMPLE_DTYPES = (torch.int16, torch.float32)
#: the packed stack's dtype and bytes a term, by weights precision
_PACKED = {"int8": (torch.int8, 1.0), "int4": (torch.uint8, 0.5)}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("serve_mega")
    fn = lib.serve_mega_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    multi = lib.serve_mega_multi_launch
    multi.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
    multi.restype = ctypes.c_int
    limits = lib.serve_mega_device_limits
    limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    limits.restype = ctypes.c_int
    lib.serve_mega_error_string.argtypes = [ctypes.c_int]
    lib.serve_mega_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (if needed) and load the kernel; returns the library path."""
    _library()
    return cuda_build.library_path("serve_mega")


def _check(stream, resolutions, operator, weights, pre, skip_samples, stride,
           epoch_size, feature_size, weights_name="weights", weights_shape=None,
           weights_dtype=torch.float32) -> None:
    if stream.dim() != 2 or stream.dtype not in SAMPLE_DTYPES:
        raise ValueError(
            f"stream must be (C, capacity*stride) int16 or float32, got "
            f"{tuple(stream.shape)} {stream.dtype}"
        )
    C, S = stream.shape
    if resolutions.shape != (C,) or resolutions.dtype != torch.float32:
        raise ValueError(
            f"resolutions must be ({C},) float32, got "
            f"{tuple(resolutions.shape)} {resolutions.dtype}"
        )
    if operator.shape != (epoch_size, feature_size) or operator.dtype != torch.float32:
        raise ValueError(
            f"operator must be ({epoch_size}, {feature_size}) float32, got "
            f"{tuple(operator.shape)} {operator.dtype}"
        )
    shape = weights_shape or (C * feature_size,)
    if weights.shape != shape or weights.dtype != weights_dtype:
        raise ValueError(
            f"{weights_name} must be {shape} {str(weights_dtype).replace('torch.', '')}, got "
            f"{tuple(weights.shape)} {weights.dtype}"
        )
    for name, t in (("stream", stream), ("resolutions", resolutions),
                    ("operator", operator), (weights_name, weights)):
        if t.device != stream.device:
            raise ValueError(f"{name} is on {t.device}, stream on {stream.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pre < 1 or skip_samples < 0 or pre + skip_samples + epoch_size > stride:
        raise ValueError(
            f"need pre >= 1, skip >= 0 and pre + skip + {epoch_size} <= stride; "
            f"got pre {pre}, skip {skip_samples}, stride {stride}"
        )
    if S % stride:
        raise ValueError(f"stream length {S} is not a multiple of the stride {stride}")
    if S > cuda_build.INT32_MAX:
        raise ValueError("stream length must fit in int32")


def _check_lanes(lanes, capacity) -> None:
    if (not isinstance(lanes, torch.Tensor) or lanes.dtype != torch.int32
            or lanes.shape != (capacity,)):
        raise ValueError(f"lanes must be a ({capacity},) int32 tensor, got {lanes!r}")
    if lanes.device.type != "cpu":
        raise ValueError(
            f"lanes must be on the host (got {lanes.device}): their range is "
            "checked before they are copied to the card"
        )
    if capacity and (int(lanes.min()) < 0 or int(lanes.max()) >= serve_mega.MAX_TENANTS):
        raise ValueError(
            f"lanes must lie in [0, {serve_mega.MAX_TENANTS}); got "
            f"[{int(lanes.min())}, {int(lanes.max())}]"
        )


def tiles_resident_bytes(channels: int) -> int:
    """The most shared memory (bytes) a tile-design block keeps for its
    epilogue (``csrc/serve_mega.cu`` TileMargins::resident_bytes): K6's
    f32 tenant stack (128 rows of ``channels * 16`` floats) and a lane
    slot for each of its 8 epilogue warps; K5's weights and the packed
    stacks take less."""
    return 128 * channels * dwt.KERNEL_FEATURE_SIZE * 4 + 8 * 4


def tiles_smem_bytes(channels: int, pre: int, stages: int, resident: int = 0) -> int:
    """Shared memory (bytes) of a tile-design block at ``stages`` stages
    (``csrc/window_tiles.cuh`` tiles_smem_bytes): the stages (each the 16
    analysis group boxes of :data:`TILE_WINDOWS` windows x ``channels``
    rows of 36 floats, each box on a 128-byte boundary, then the baseline
    box of ``round4(pre)`` samples, rounded up to 128 bytes), W (16 groups
    of 32 rows, each padded by 16 floats), two tiles' partials and rows,
    ``res``, the epilogue's ``resident`` bytes (16-byte aligned), the
    mbarriers (3 a stage, 2 a partials buffer), and 128 bytes to align the
    block's base."""
    base = 4 * ((pre + 3) // 4)
    box = -(-(channels * TILE_WINDOWS * 36 * 4) // 128) * 128
    stage = -(-(16 * box + channels * TILE_WINDOWS * base * 4) // 128) * 128
    w = 16 * (32 + 1) * dwt.KERNEL_FEATURE_SIZE * 4
    parts = 2 * TILE_WINDOWS * 9 * channels * dwt.KERNEL_FEATURE_SIZE * 4
    res_end = stages * stage + w + parts + channels * 4
    bars = (((res_end + 15) & ~15) + resident + 7) & ~7
    return 128 + bars + (3 * TILE_MAX_STAGES + 4) * 8


def tiles_crossover(sms: int) -> int:
    """The fewest windows a launch takes the tile design with on a card
    of ``sms`` multiprocessors (:data:`TILES_WINDOWS_PER_SM` each)."""
    return TILES_WINDOWS_PER_SM * sms


@functools.lru_cache(maxsize=4096)
def mega_design(capacity: int, channels: int, sms: int, smem_optin: int, pre: int, stride: int,
                sample_bytes: int = 4, aligned: bool = True) -> int:
    """The design (an index of :data:`MEGA_DESIGNS`) of a 512 / 16
    megakernel launch of ``capacity`` windows of ``channels`` channels on
    a card of ``sms`` multiprocessors and ``smem_optin`` bytes of shared
    memory a block: the tile design (1) for float32 samples
    (``sample_bytes`` 4) from :func:`tiles_crossover` windows on, where it
    reaches the launch (at most :data:`TILE_MAX_CHANNELS` channels, a
    baseline box of at most 256 samples, a stride of a multiple of 4
    samples, a 16-byte ``aligned`` stream, two stages and the largest
    epilogue state in ``smem_optin``);
    ``run_windows`` (0) for every other launch, which it reaches wherever
    the kernel runs at all. Pure: the same arguments, the same design."""
    reach = (sample_bytes == 4 and 1 <= channels <= TILE_MAX_CHANNELS
             and 4 * ((pre + 3) // 4) <= TILE_MAX_BOX and stride % 4 == 0 and aligned
             and tiles_smem_bytes(channels, pre, TILE_MIN_STAGES,
                                  tiles_resident_bytes(channels)) <= smem_optin)
    return 1 if reach and capacity >= tiles_crossover(sms) else 0


def _design(lib, stream: torch.Tensor, capacity: int, pre: int, stride: int, epoch_size: int,
            feature_size: int) -> int:
    """The launch's megakernel design: :func:`mega_design`'s at 512 / 16,
    ``run_windows``' code (0, the generic engine's plan decides) at any
    other size."""
    if (epoch_size, feature_size) != (dwt.KERNEL_EPOCH_SIZE, dwt.KERNEL_FEATURE_SIZE):
        return 0
    limits = cuda_build.device_limits(lib.serve_mega_device_limits, lib.serve_mega_error_string,
                                      stream.device)
    return mega_design(capacity, stream.shape[0], *limits, pre, stride, stream.element_size(),
                       stream.data_ptr() % 16 == 0)


def _plan(lib, stream: torch.Tensor, capacity: int, pre: int, epoch_size: int,
          feature_size: int, kernel: str):
    """The generic engine's tile plan of a launch (``None`` at the main
    path's 512 / 16); raises, before any launch, outside its reach."""
    if (epoch_size, feature_size) == (dwt.KERNEL_EPOCH_SIZE, dwt.KERNEL_FEATURE_SIZE):
        return None
    C = stream.shape[0]
    limits = cuda_build.device_limits(lib.serve_mega_device_limits, lib.serve_mega_error_string,
                                      stream.device)
    plan = generic_plan.generic_tile_plan(C, epoch_size, feature_size, capacity, *limits, pre,
                                          stream.element_size())
    if plan is None:
        _raise_on(cuda_build.SHARED_MEMORY_EXCEEDED, lib, kernel, C, epoch_size, feature_size)
    return plan


def _raise_on(rc: int, lib, kernel: str, C: int, epoch_size: int, feature_size: int) -> None:
    if rc == cuda_build.SHARED_MEMORY_EXCEEDED:
        raise ValueError(
            f"{kernel}: a row of {C} channels x {feature_size} coefficients at "
            f"epoch_size {epoch_size} does not fit the kernel's shared memory"
        )
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} "
            f"({lib.serve_mega_error_string(rc).decode()})"
        )


def _count(counter: str, stream: torch.Tensor, plan, design: int) -> None:
    """One launch in its instantiation's counter (``plan``: the generic
    engine's, ``None`` at 512 / 16), a generic launch in its plan's
    design's, and a float32-sample one at 512 / 16 in ``design``'s."""
    if stream.dtype == torch.float32:
        counter += "_F32S"
        if plan is None:
            globals()["F32S_DESIGN_" + MEGA_DESIGNS[design].upper()] += 1
    if plan is not None:
        counter = "ANY_" + counter
        globals()["ANY_DESIGN_" + generic_plan.DESIGNS[plan.design].upper()] += 1
    globals()[counter] += 1


def serve_mega_margins(
    stream: torch.Tensor,
    resolutions: torch.Tensor,
    operator: torch.Tensor,
    weights: torch.Tensor,
    pre: int,
    skip_samples: int,
    stride: int,
    precision: str = "f32",
    epoch_size: int = dwt.KERNEL_EPOCH_SIZE,
    feature_size: int = dwt.KERNEL_FEATURE_SIZE,
) -> torch.Tensor:
    """(C, capacity*stride) int16 or float32 + (C,) res + (epoch_size,
    feature_size) operator + (C*feature_size,) weights -> (capacity,)
    float32 margins before the intercept, at ``precision`` (f32, int8 or
    int4); see ``serve_mega.serve_mega_margins_plain`` for the exact
    function."""
    serve_mega._check_precision(precision)
    _check(stream, resolutions, operator, weights, pre, skip_samples, stride, epoch_size,
           feature_size)
    if stream.device.type == "cpu":
        return serve_mega.serve_mega_margins_plain(
            stream, resolutions, operator, weights, pre, skip_samples, stride, precision
        )
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    C, S = stream.shape
    capacity = S // stride
    out = torch.empty((capacity,), dtype=torch.float32, device=stream.device)
    if capacity == 0:
        return out
    lib = _library()
    plan = _plan(lib, stream, capacity, pre, epoch_size, feature_size, "serve_mega")
    design = _design(lib, stream, capacity, pre, stride, epoch_size, feature_size)
    with torch.cuda.device(stream.device):
        cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
        rc = lib.serve_mega_launch(
            stream.data_ptr(), resolutions.data_ptr(), operator.data_ptr(),
            weights.data_ptr(), out.data_ptr(),
            capacity, C, stride, pre, skip_samples, int(stream.dtype == torch.float32),
            decode_ingest.PRECISIONS.index(precision), epoch_size, feature_size, design,
            cuda_build.plan_array(plan), cuda_stream,
        )
    _raise_on(rc, lib, "serve_mega", C, epoch_size, feature_size)
    _count(_COUNTERS[precision], stream, plan, design)
    return out


def _launch_multi(stream, resolutions, operator, stack, scales, lanes, pre, skip_samples,
                  stride, weights_precision, epoch_size, feature_size) -> torch.Tensor:
    """One K6 launch (stack and lanes already checked)."""
    C, S = stream.shape
    capacity = S // stride
    out = torch.empty((capacity,), dtype=torch.float32, device=stream.device)
    if capacity == 0:
        return out
    lib = _library()
    plan = _plan(lib, stream, capacity, pre, epoch_size, feature_size, "serve_mega_multi")
    design = _design(lib, stream, capacity, pre, stride, epoch_size, feature_size)
    lanes_dev = lanes.to(stream.device)
    with torch.cuda.device(stream.device):
        cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
        rc = lib.serve_mega_multi_launch(
            stream.data_ptr(), resolutions.data_ptr(), operator.data_ptr(),
            stack.data_ptr(), None if scales is None else scales.data_ptr(),
            lanes_dev.data_ptr(), out.data_ptr(),
            capacity, C, stride, pre, skip_samples, int(stream.dtype == torch.float32),
            decode_ingest.PRECISIONS.index(weights_precision), epoch_size, feature_size,
            design, cuda_build.plan_array(plan), cuda_stream,
        )
    _raise_on(rc, lib, "serve_mega_multi", C, epoch_size, feature_size)
    _count(_MULTI_COUNTERS[weights_precision], stream, plan, design)
    return out


def serve_mega_multi_margins(
    stream: torch.Tensor,
    resolutions: torch.Tensor,
    operator: torch.Tensor,
    stack: torch.Tensor,
    lanes: torch.Tensor,
    pre: int,
    skip_samples: int,
    stride: int,
    epoch_size: int = dwt.KERNEL_EPOCH_SIZE,
    feature_size: int = dwt.KERNEL_FEATURE_SIZE,
) -> torch.Tensor:
    """K6: (C, capacity*stride) int16 or float32 + (C,) res + (epoch_size,
    feature_size) operator + (128, C*feature_size) tenant-major f32 stack
    + (capacity,) int32 lanes on the host -> (capacity,) float32 margins
    before the intercept, window ``i`` dotted with ``stack[lanes[i]]``;
    see ``serve_mega.serve_mega_multi_margins_plain`` for the exact
    function. The stack and the lanes are checked here, on the host,
    before the lanes are copied to the card and the kernel launches."""
    C = stream.shape[0] if stream.dim() == 2 else 0
    _check(stream, resolutions, operator, stack, pre, skip_samples, stride, epoch_size,
           feature_size, weights_name="stack",
           weights_shape=(serve_mega.MAX_TENANTS, C * feature_size))
    capacity = stream.shape[1] // stride
    _check_lanes(lanes, capacity)
    if stream.device.type == "cpu":
        return serve_mega.serve_mega_multi_margins_plain(
            stream, resolutions, operator, stack, lanes, pre, skip_samples, stride
        )
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    return _launch_multi(stream, resolutions, operator, stack, None, lanes, pre,
                         skip_samples, stride, "f32", epoch_size, feature_size)


def serve_mega_multi_packed_margins(
    stream: torch.Tensor,
    resolutions: torch.Tensor,
    operator: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    lanes: torch.Tensor,
    pre: int,
    skip_samples: int,
    stride: int,
    weights_precision: str,
    epoch_size: int = dwt.KERNEL_EPOCH_SIZE,
    feature_size: int = dwt.KERNEL_FEATURE_SIZE,
) -> torch.Tensor:
    """K6-w8 / K6-w4: as :func:`serve_mega_multi_margins`, with the stack
    resident packed (``quant.quantize_weight_stack``, tenant-major):
    ``packed`` (128, C*K) int8 levels at ``weights_precision="int8"``, or
    (128, C*K/2) uint8 at ``"int4"`` (term 2j in the low nibble of byte
    j, 2j+1 in the high, each stored +8), and ``scales`` (128,) float32,
    one a lane. Term ``i`` of lane ``t`` is ``float(q) * scales[t]``, so
    the margins equal K6's on the dequantized stack
    (``quant.dequantize_weight_stack``) bit for bit; see
    ``serve_mega.serve_mega_multi_packed_margins_plain``. Everything is
    checked here, before the launch."""
    if weights_precision not in _PACKED:
        raise ValueError(
            f"weights_precision {weights_precision!r} has no packed stack; use int8 or int4"
        )
    C = stream.shape[0] if stream.dim() == 2 else 0
    dtype, per_term = _PACKED[weights_precision]
    terms = C * feature_size
    if weights_precision == "int4" and terms % 2:
        raise ValueError(f"an int4 stack packs an even number of terms, got {terms}")
    _check(stream, resolutions, operator, packed, pre, skip_samples, stride, epoch_size,
           feature_size, weights_name="packed",
           weights_shape=(serve_mega.MAX_TENANTS, int(terms * per_term)), weights_dtype=dtype)
    if (scales.shape != (serve_mega.MAX_TENANTS,) or scales.dtype != torch.float32
            or scales.device != stream.device or not scales.is_contiguous()):
        raise ValueError(
            f"scales must be a contiguous ({serve_mega.MAX_TENANTS},) float32 tensor on "
            f"{stream.device}, got {tuple(scales.shape)} {scales.dtype} on {scales.device}"
        )
    capacity = stream.shape[1] // stride
    _check_lanes(lanes, capacity)
    if stream.device.type == "cpu":
        return serve_mega.serve_mega_multi_packed_margins_plain(
            stream, resolutions, operator, packed, scales, lanes, pre, skip_samples, stride,
            weights_precision,
        )
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    return _launch_multi(stream, resolutions, operator, packed, scales, lanes, pre,
                         skip_samples, stride, weights_precision, epoch_size, feature_size)
