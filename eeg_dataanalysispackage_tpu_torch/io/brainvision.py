"""BrainVision (.vhdr/.vmrk/.eeg) reader.

Parses the Brain Vision Data Exchange format (INI-style header + marker
files, multiplexed or vectorized INT_16, INT_32 or IEEE_FLOAT_32 binary
data) the way the reference's closed ``eegloader-hdfs`` jar does
(OffLineDataProvider.java:167-196). The header and marker files parse
through the native C++ parser and the host path's int16 channels demux
through the native kernel (``io/native.py``), where the JAX package calls
its own; the Python parsers (:func:`parse_vhdr_py`, :func:`parse_vmrk_py`)
and the numpy demux are the reference they are bit-equal to, and the
paths ``EEG_TPU_NATIVE=0`` selects. The fused path ships the unscaled
int16 samples to the card and scales them there, and the host path reads
scaled float64 channels.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import native, remote


@dataclasses.dataclass(frozen=True)
class ChannelInfo:
    """One ``Ch<n>=<Name>,<Ref>,<Resolution>,<Unit>`` entry."""

    number: int  # 1-based channel number, as in the header
    name: str
    reference: str
    resolution: float
    units: str


@dataclasses.dataclass(frozen=True)
class Marker:
    """One ``Mk<n>=<Type>,<Description>,<Position>,...`` entry.

    ``position`` is the raw position-in-data-points field, used directly
    as the sample index (OffLineDataProvider.java:220-225).
    """

    name: str
    kind: str
    stimulus: str
    position: int

    def stimulus_index(self) -> int:
        """Digits of the stimulus text minus one; -1 when no digits
        (OffLineDataProvider.java:207-214)."""
        digits = re.sub(r"\D", "", self.stimulus)
        if digits:
            return int(digits) - 1
        return -1


@dataclasses.dataclass(frozen=True)
class Header:
    data_file: str
    marker_file: str
    data_format: str  # BINARY
    orientation: str  # MULTIPLEXED | VECTORIZED
    num_channels: int
    sampling_interval_us: float
    binary_format: str  # INT_16 | IEEE_FLOAT_32
    channels: List[ChannelInfo]

    @property
    def sampling_rate_hz(self) -> float:
        return 1e6 / self.sampling_interval_us

    def channel_index(self, name: str) -> Optional[int]:
        """0-based index of a channel by case-insensitive name."""
        lname = name.lower()
        for i, ch in enumerate(self.channels):
            if ch.name.lower() == lname:
                return i
        return None


_SECTION_RE = re.compile(r"^\[(?P<name>.+)\]\s*$")
_KV_RE = re.compile(r"^(?P<key>[^=;]+)=(?P<value>.*)$")


def _parse_ini(text: str) -> Dict[str, Dict[str, str]]:
    """Minimal INI parse: sections, key=value, ';' comments skipped.

    The [Comment] section of real vhdr files contains free text with
    '=' signs; values are kept verbatim, later sections win on dup keys.
    """
    sections: Dict[str, Dict[str, str]] = {}
    current: Optional[Dict[str, str]] = None
    for raw in text.splitlines():
        line = raw.strip("\r\n")
        if not line or line.lstrip().startswith(";"):
            continue
        m = _SECTION_RE.match(line.strip())
        if m:
            current = sections.setdefault(m.group("name"), {})
            continue
        if current is None:
            continue
        kv = _KV_RE.match(line)
        if kv:
            current[kv.group("key").strip()] = kv.group("value")
    return sections


def _unescape_name(name: str) -> str:
    # Commas in channel names are coded as "\1" per the format spec.
    return name.replace("\\1", ",")


def parse_vhdr(text: str) -> Header:
    """Parse a .vhdr header: the C++ parser, or :func:`parse_vhdr_py` for
    text the C++ side cannot represent exactly and under
    ``EEG_TPU_NATIVE=0`` (the two agree wherever both parse)."""
    header = native.parse_vhdr(text)
    return header if header is not None else parse_vhdr_py(text)


def parse_vhdr_py(text: str) -> Header:
    sections = _parse_ini(text)
    common = sections.get("Common Infos", {})
    binary = sections.get("Binary Infos", {})
    chan_section = sections.get("Channel Infos", {})

    channels: List[ChannelInfo] = []
    chan_keys = [k for k in chan_section if re.fullmatch(r"Ch\d+", k)]
    for key in sorted(chan_keys, key=lambda k: int(k[2:])):
        parts = chan_section[key].split(",")
        # <Name>,<Reference>,<Resolution>,<Unit>, future extensions
        name = _unescape_name(parts[0]) if parts else ""
        ref = parts[1] if len(parts) > 1 else ""
        res = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
        units = parts[3] if len(parts) > 3 else "uV"
        channels.append(
            ChannelInfo(
                number=int(key[2:]),
                name=name,
                reference=ref,
                resolution=res,
                units=units,
            )
        )

    return Header(
        data_file=common.get("DataFile", ""),
        marker_file=common.get("MarkerFile", ""),
        data_format=common.get("DataFormat", "BINARY"),
        orientation=common.get("DataOrientation", "MULTIPLEXED"),
        num_channels=int(common.get("NumberOfChannels", len(channels) or 1)),
        sampling_interval_us=float(common.get("SamplingInterval", 1000)),
        binary_format=binary.get("BinaryFormat", "INT_16"),
        channels=channels,
    )


_MARKER_KEY_RE = re.compile(r"^Mk\d+$")


def parse_vmrk(text: str) -> List[Marker]:
    """Parse a .vmrk marker file, routed as :func:`parse_vhdr`."""
    markers = native.parse_vmrk(text)
    return markers if markers is not None else parse_vmrk_py(text)


def parse_vmrk_py(text: str) -> List[Marker]:
    sections = _parse_ini(text)
    infos = sections.get("Marker Infos", {})
    markers: List[Marker] = []
    # preserve numeric Mk order
    for key in sorted(infos, key=lambda k: int(k[2:]) if k[2:].isdigit() else 0):
        if not _MARKER_KEY_RE.match(key):
            continue
        parts = infos[key].split(",")
        kind = parts[0] if parts else ""
        stimulus = _unescape_name(parts[1]) if len(parts) > 1 else ""
        try:
            position = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            position = 0
        markers.append(Marker(name=key, kind=kind, stimulus=stimulus, position=position))
    return markers


_BINARY_DTYPES = {
    "INT_16": np.dtype("<i2"),
    "INT_32": np.dtype("<i4"),
    "IEEE_FLOAT_32": np.dtype("<f4"),
}


class Recording:
    """A parsed BrainVision triplet with lazy channel access."""

    def __init__(self, header: Header, markers: List[Marker], raw: np.ndarray):
        self.header = header
        self.markers = markers
        # raw: (num_samples, num_channels) unscaled samples
        self._raw = raw

    @property
    def num_samples(self) -> int:
        return self._raw.shape[0]

    def read_channel(self, index: int) -> np.ndarray:
        """One whole channel (0-based) as float64, scaled by its resolution
        in float32 as :meth:`read_channels` does."""
        res = np.float32(self.header.channels[index].resolution)
        return (self._raw[:, index].astype(np.float32) * res).astype(np.float64)

    def raw_int16(self, indices: Sequence[int], out: Optional[np.ndarray] = None) -> np.ndarray:
        """(len(indices), num_samples) UNSCALED int16 channel matrix.

        The fused path stages these raw samples to the card and scales
        them there, halving host->device bytes against float32. With
        ``out`` (int16, ``len(indices)`` rows of at least ``num_samples``),
        the channels are written into its leading columns, one pass a
        channel, and ``out`` is returned. Raises TypeError for non-INT_16
        recordings (callers fall back to :meth:`read_channels`).
        """
        if self._raw.dtype != np.int16:
            raise TypeError(
                f"raw_int16 requires INT_16 data, got {self._raw.dtype}"
            )
        if out is None:
            return np.ascontiguousarray(self._raw[:, list(indices)].T)
        for row, i in enumerate(indices):
            out[row, : self.num_samples] = self._raw[:, i]
        return out

    def resolutions(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices),) float32 per-channel resolution factors."""
        return np.array(
            [self.header.channels[i].resolution for i in indices],
            dtype=np.float32,
        )

    def read_channels(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices), num_samples) float64 scaled channel matrix.

        Matches ``DataTransformer.readBinaryData`` returning double[]
        (OffLineDataProvider.java:186-188): the closed eegloader jar
        scales sample x resolution in float32 before widening to double,
        for INT_16, INT_32 and IEEE_FLOAT_32 data alike. INT_16 samples in
        either layout demux through the native kernel (bit-equal to the
        numpy lines below, which take every other case and
        ``EEG_TPU_NATIVE=0``).
        """
        res = self.resolutions(indices)
        if self._raw.dtype == np.int16:
            if self._raw.flags["C_CONTIGUOUS"]:
                out = native.demux_int16(self._raw, indices, res)
            elif self._raw.T.flags["C_CONTIGUOUS"]:
                out = native.demux_int16(self._raw.T, indices, res, vectorized=True)
            else:
                out = None
            if out is not None:
                return out
        scaled32 = self._raw[:, list(indices)].T.astype(np.float32) * res[:, None]
        return scaled32.astype(np.float64)


def load_recording_bytes(
    vhdr_bytes: bytes, vmrk_bytes: bytes, eeg_bytes: bytes
) -> Recording:
    """Build a :class:`Recording` from an already-read triplet."""
    header = parse_vhdr(vhdr_bytes.decode("utf-8", errors="replace"))
    markers = parse_vmrk(vmrk_bytes.decode("utf-8", errors="replace"))
    return recording_from_blob(header, markers, eeg_bytes)


def recording_from_blob(header: Header, markers: List[Marker], eeg_bytes: bytes) -> Recording:
    """A :class:`Recording` from a parsed header and markers and the .eeg
    bytes (the pod path parses the text files in its metadata pass and
    reads only its own recordings' waveforms)."""
    dtype = _BINARY_DTYPES.get(header.binary_format)
    if dtype is None:
        raise ValueError(f"Unsupported BinaryFormat: {header.binary_format}")
    flat = np.frombuffer(eeg_bytes, dtype=dtype)
    nch = header.num_channels
    nsamp = flat.size // nch
    flat = flat[: nsamp * nch]
    if header.orientation.upper() == "MULTIPLEXED":
        raw = flat.reshape(nsamp, nch)
    else:  # VECTORIZED: ch1 all samples, ch2 all samples, ...
        raw = flat.reshape(nch, nsamp).T
    return Recording(header, markers, raw)


def load_recording(eeg_path: str, filesystem=None) -> Recording:
    """Load a BrainVision triplet through ``filesystem`` (an
    ``io.sources`` filesystem; ``None`` routes by the path's URI scheme).
    The sibling .vhdr/.vmrk are the .eeg path with the suffix
    substituted, as ``setFileNames`` does (OffLineDataProvider.java:327-365);
    a missing one raises ``FileNotFoundError``."""
    fs = filesystem if filesystem is not None else remote.filesystem_for(eeg_path)
    base = os.path.splitext(eeg_path)[0]
    triplet = (base + ".vhdr", base + ".vmrk", eeg_path)
    for p in triplet:
        if not fs.exists(p):
            raise FileNotFoundError(f"No related file found: {p}")
    return load_recording_bytes(*(fs.read_bytes(p) for p in triplet))
