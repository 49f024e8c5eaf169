"""ctypes binding to the native host kernels (``csrc/eeg_host.cc``).

Port of the JAX package's ``io/native.py``. The C++ library is the
stand-in for the reference's closed ``eegloader-hdfs`` jar and its
per-marker epoching loop (OffLineDataProvider.java:167-196, 200-265):
the .vhdr/.vmrk parsers, the int16 demux with per-channel resolution
scaling, the window gather with the float32 baseline correction, and the
sequential class-balance scan. ``io/brainvision.py`` and
``epochs/extractor.py`` call it where the JAX package calls its own; every
entry point is bit-equal to their numpy paths, which stay as the
reference.

The library is the port's own copy of the source, built at first use
with ``g++`` into ``_build/`` (``ops/cuda_build.build_host``). A failed
build or load raises with the compiler's output: the port does not fall
back. ``EEG_TPU_NATIVE=0`` is the caller's explicit choice of the numpy
paths (read at every call), and the entry points return None then.
Routing by input stays as in the JAX package: text the C++ parser cannot
represent exactly, and windows longer than :data:`MAX_WINDOW`, go to the
Python and numpy paths (the functions return None for them too).
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops import cuda_build

#: the C++ gather kernel's fixed stack window buffer
MAX_WINDOW = 4096

#: ``0`` selects the numpy paths
ENV_NATIVE = "EEG_TPU_NATIVE"

_SOURCE = "eeg_host"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_pi16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


class _HeaderInfo(ctypes.Structure):
    _fields_ = [
        ("sampling_interval_us", ctypes.c_double),
        ("num_channels", ctypes.c_int64),
        ("data_file", ctypes.c_char * 256),
        ("marker_file", ctypes.c_char * 256),
        ("data_format", ctypes.c_char * 32),
        ("orientation", ctypes.c_char * 32),
        ("binary_format", ctypes.c_char * 32),
    ]


class _ChannelInfo(ctypes.Structure):
    _fields_ = [
        ("resolution", ctypes.c_double),
        ("number", ctypes.c_int64),
        ("name", ctypes.c_char * 128),
        ("reference", ctypes.c_char * 64),
        ("units", ctypes.c_char * 32),
    ]


class _MarkerInfo(ctypes.Structure):
    _fields_ = [
        ("position", ctypes.c_int64),
        ("name", ctypes.c_char * 32),
        ("kind", ctypes.c_char * 64),
        ("stimulus", ctypes.c_char * 64),
    ]


def enabled() -> bool:
    """False when ``EEG_TPU_NATIVE=0`` selects the numpy paths."""
    return os.environ.get(ENV_NATIVE, "1") != "0"


def _load() -> ctypes.CDLL:
    """The library, built and loaded once per process; raises."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(cuda_build.build_host(_SOURCE))
        lib.eeg_demux_int16.argtypes = [_pi16, _i64, _i64, _pi64, _i64, _pf, _pd]
        lib.eeg_demux_int16.restype = None
        lib.eeg_demux_int16_vectorized.argtypes = list(lib.eeg_demux_int16.argtypes)
        lib.eeg_demux_int16_vectorized.restype = None
        lib.eeg_valid_windows.argtypes = [_pi64, _i64, _i64, _i64, _pu8]
        lib.eeg_valid_windows.restype = _i64
        lib.eeg_gather_baseline.argtypes = [_pd, _i64, _i64, _pi64, _pu8, _i64, _i64, _i64, _pd]
        lib.eeg_gather_baseline.restype = None
        lib.eeg_balance_scan.argtypes = [_pu8, _i64, _pi64, _pu8]
        lib.eeg_balance_scan.restype = None
        lib.eeg_parse_vhdr.argtypes = [ctypes.c_char_p, _i64, ctypes.POINTER(_HeaderInfo),
                                       ctypes.POINTER(_ChannelInfo), _i64]
        lib.eeg_parse_vhdr.restype = _i64
        lib.eeg_parse_vmrk.argtypes = [ctypes.c_char_p, _i64, ctypes.POINTER(_MarkerInfo), _i64]
        lib.eeg_parse_vmrk.restype = _i64
        _lib = lib
        return lib


def _library() -> Optional[ctypes.CDLL]:
    """The library, or None when ``EEG_TPU_NATIVE=0``."""
    return _load() if enabled() else None


def available() -> bool:
    """True unless ``EEG_TPU_NATIVE=0``; builds the library on first use
    and raises when that fails."""
    return _library() is not None


def demux_int16(
    raw: np.ndarray, indices, resolutions, vectorized: bool = False,
) -> Optional[np.ndarray]:
    """(S, C) [or (C, S) with ``vectorized``] int16 -> (n_sel, S) float64:
    each selected channel scaled by its float32 resolution in float32,
    then widened. None under ``EEG_TPU_NATIVE=0``."""
    lib = _library()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    if vectorized:
        n_channels, n_samples = raw.shape
    else:
        n_samples, n_channels = raw.shape
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n_channels):
        raise IndexError(f"channel index out of range for {n_channels} channels: {idx}")
    res = np.ascontiguousarray(resolutions, dtype=np.float32)
    if res.shape != idx.shape:
        raise ValueError(f"{res.size} resolutions for {idx.size} channels")
    out = np.empty((idx.size, n_samples), dtype=np.float64)
    fn = lib.eeg_demux_int16_vectorized if vectorized else lib.eeg_demux_int16
    fn(raw, n_samples, n_channels, idx, idx.size, res, out)
    return out


def gather_baseline(
    channels: np.ndarray, positions: np.ndarray, pre: int, post: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Window gather and float32 baseline correction, epochs of ``post``
    samples. ``channels`` (n_channels, n_samples) float64. Returns
    (epochs (n_valid, n_channels, post) float64, valid (n_pos,) bool), or
    None under ``EEG_TPU_NATIVE=0`` or for a window past
    :data:`MAX_WINDOW` (the numpy path takes those)."""
    if pre + post > MAX_WINDOW:
        return None
    lib = _library()
    if lib is None:
        return None
    channels = np.ascontiguousarray(channels, dtype=np.float64)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    n_channels, n_samples = channels.shape
    valid = np.empty(pos.size, dtype=np.uint8)
    n_valid = lib.eeg_valid_windows(pos, pos.size, pre, n_samples, valid)
    out = np.empty((int(n_valid), n_channels, post), dtype=np.float64)
    lib.eeg_gather_baseline(channels, n_channels, n_samples, pos, valid, pos.size, pre, post,
                            out)
    return out, valid.astype(bool)


def balance_scan(is_target: np.ndarray, counters: np.ndarray) -> Optional[np.ndarray]:
    """The sequential balance filter from ``counters`` ([n_targets,
    n_nontargets] int64, updated in place); the keep mask, or None under
    ``EEG_TPU_NATIVE=0``."""
    lib = _library()
    if lib is None:
        return None
    t = np.ascontiguousarray(is_target, dtype=np.uint8)
    keep = np.empty(t.size, dtype=np.uint8)
    c = np.ascontiguousarray(counters, dtype=np.int64)
    lib.eeg_balance_scan(t, t.size, c, keep)
    counters[:] = c
    return keep.astype(bool)


# The C++ parser works byte-wise on '\n'/'\r\n' line structure and ASCII
# whitespace and digits; Python's splitlines()/strip()/\d/int() also honor
# \v, \f, \x1c-\x1e, a lone \r, and the Unicode digit and whitespace
# classes. Text using any of them goes to the Python parser, which defines
# the behaviour. Other non-ASCII text (channel names, µV units) is
# byte-transparent and stays native. \x00: a ctypes c_char array stops at
# the first NUL, which would truncate fields the Python parser keeps whole.
_EXOTIC_TEXT_RE = re.compile(r"\r(?!\n)|[\x00\v\f\x1c\x1d\x1e]")


def _native_parseable(text: str) -> bool:
    if _EXOTIC_TEXT_RE.search(text):
        return False
    if text.isascii():
        return True
    return not any(ord(c) > 127 and (c.isdigit() or c.isspace()) for c in text)


def _encoded(text: str) -> Optional[bytes]:
    """``text`` as UTF-8 when the C++ parser can represent it, else None."""
    if not _native_parseable(text):
        return None
    try:
        return text.encode("utf-8")
    except UnicodeEncodeError:  # lone surrogates (surrogateescape reads)
        return None


def parse_vhdr(text: str):
    """A .vhdr through the C++ parser -> ``io.brainvision.Header``; None
    under ``EEG_TPU_NATIVE=0`` and for text the Python parser must define
    (exotic text, or a negative status: a numeric parse failure or an
    oversized field)."""
    lib = _library()
    data = None if lib is None else _encoded(text)
    if data is None:
        return None
    from . import brainvision

    max_channels = data.count(b"\n") + 2
    hdr = _HeaderInfo()
    chans = (_ChannelInfo * max_channels)()
    n = lib.eeg_parse_vhdr(data, len(data), ctypes.byref(hdr), chans, max_channels)
    if n < 0:
        return None
    channels = [
        brainvision.ChannelInfo(
            number=int(c.number),
            name=c.name.decode("utf-8"),
            reference=c.reference.decode("utf-8"),
            resolution=float(c.resolution),
            units=c.units.decode("utf-8"),
        )
        for c in chans[:n]
    ]
    return brainvision.Header(
        data_file=hdr.data_file.decode("utf-8"),
        marker_file=hdr.marker_file.decode("utf-8"),
        data_format=hdr.data_format.decode("utf-8"),
        orientation=hdr.orientation.decode("utf-8"),
        num_channels=int(hdr.num_channels),
        sampling_interval_us=float(hdr.sampling_interval_us),
        binary_format=hdr.binary_format.decode("utf-8"),
        channels=channels,
    )


def parse_vmrk(text: str):
    """A .vmrk through the C++ parser -> a list of
    ``io.brainvision.Marker``; None as :func:`parse_vhdr`."""
    lib = _library()
    data = None if lib is None else _encoded(text)
    if data is None:
        return None
    from . import brainvision

    max_markers = data.count(b"\n") + 2
    marks = (_MarkerInfo * max_markers)()
    n = lib.eeg_parse_vmrk(data, len(data), marks, max_markers)
    if n < 0:
        return None
    return [
        brainvision.Marker(
            name=m.name.decode("utf-8"),
            kind=m.kind.decode("utf-8"),
            stimulus=m.stimulus.decode("utf-8"),
            position=int(m.position),
        )
        for m in marks[:n]
    ]
